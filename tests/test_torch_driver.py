"""The port's experiment driver on the CPU: the CLI's flags, a tiny covariant
run of two PPO iterations through `run_experiment` with its JSON-lines
streams and checkpoint, a resume from that checkpoint, the same for the
internal (SchNet) and the mlp models, an iteration of each host reward and
transport, the options of data parallelism, TensorBoard and the profiler,
and the refusal of every option the port does not run."""
import json
import pickle
import sys

import numpy as np
import pytest
import torch

from molgym_tpu.tools.arg_parser import \
    build_default_argparser as jax_argparser
from molgym_tpu_torch import run, run_stochastic
from molgym_tpu_torch.parallel.mesh import free_port
from molgym_tpu_torch.tools.arg_parser import (build_default_argparser,
                                               check_supported)
from molgym_tpu_torch.tools.driver import run_experiment
from molgym_tpu_torch.tools import util
from molgym_tpu_torch.tools.model_io import ModelIO

TINY = ['--name=tiny', '--formulas=H2O,OH2', '--canvas_size=3',
        '--symbols=X,H,O', '--bag_scale=3', '--model=covariant', '--maxl=2',
        '--num_cg_levels=2', '--network_width=16', '--num_channels_hidden=3',
        '--num_channels_per_element=2', '--num_gaussians=2',
        '--reward=device_lj', '--num_envs=4', '--num_steps_per_iter=8',
        '--mini_batch_size=6', '--max_num_train_iters=2', '--save_freq=1',
        '--eval_freq=1', '--seed=1', '--save_rollouts=all']


def _config(tmp_path, *extra):
    dirs = [f'--{d}_dir={tmp_path / d}' for d in ('log', 'model', 'data',
                                                  'results')]
    return vars(build_default_argparser().parse_args(TINY + dirs + list(extra)))


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_flags_and_defaults_match_the_jax_cli():
    """Every flag of the JAX CLI exists with the same default, except the
    device, which names the card."""
    args = ['--name=x', '--formulas=SF6', '--bag_scale=5']
    ours = vars(build_default_argparser().parse_args(args))
    ref = vars(jax_argparser().parse_args(args))
    assert set(ours) == set(ref)
    assert ours.pop('device') == 'cuda'
    ref.pop('device')
    assert ours == ref


def test_run_experiment_trains_saves_and_resumes(tmp_path):
    config = _config(tmp_path, '--num_steps=16')
    agent, optimizer = run_experiment(config, device='cpu')
    results = tmp_path / 'results'
    opt = _lines(results / 'tiny_run-1_opt.txt')
    train = _lines(results / 'tiny_run-1_train.txt')
    evals = _lines(results / 'tiny_run-1_eval.txt')
    assert [r['total_num_steps'] for r in opt] == [0, 8]
    assert len(train) == len(evals) == 2
    for rec in opt:
        assert rec['num_opt_steps'] >= 1
        assert all(v == v for v in rec.values())   # no NaN
    assert optimizer.count == sum(r['num_opt_steps'] for r in opt)
    assert (tmp_path / 'log' / 'tiny_run-1.json').exists()
    with open(tmp_path / 'data' / 'tiny_run-1_steps-8_eval.pkl', 'rb') as f:
        rollout = pickle.load(f)
    assert rollout['obs']['elements'].shape[1:] == (1, 3)   # [T, 1 env, N]
    # a training rollout is saved at the steps it starts from, an eval
    # rollout at the steps after the update
    assert {p.name for p in (tmp_path / 'data').iterdir()} == {
        'tiny_run-1_steps-0_train.pkl', 'tiny_run-1_steps-8_train.pkl',
        'tiny_run-1_steps-8_eval.pkl', 'tiny_run-1_steps-16_eval.pkl'}

    # one checkpoint is kept, at 16 steps, and it holds the final state
    models = sorted(p.name for p in (tmp_path / 'model').iterdir())
    assert models == ['tiny_run-1_steps-16.model']
    state, steps = ModelIO(tmp_path / 'model', 'tiny_run-1').load_latest()
    assert steps == 16 and state['optimizer']['count'] == optimizer.count
    for k, v in agent.state_dict().items():
        torch.testing.assert_close(state['model'][k], v, rtol=0, atol=0)

    # resume: one more iteration, from the checkpoint's step count and state
    resumed, opt2 = run_experiment(
        _config(tmp_path, '--num_steps=24', '--load_latest'), device='cpu')
    opt = _lines(results / 'tiny_run-1_opt.txt')
    assert [r['total_num_steps'] for r in opt] == [0, 8, 16]
    assert opt2.count == optimizer.count + opt[-1]['num_opt_steps']
    # as in the JAX package, a new run deletes only checkpoints it wrote
    assert sorted(p.name for p in (tmp_path / 'model').iterdir()) == [
        'tiny_run-1_steps-16.model', 'tiny_run-1_steps-24.model']
    assert any(not torch.equal(v, resumed.state_dict()[k])
               for k, v in agent.state_dict().items())


def test_sampled_evaluation_reports_the_best_return(tmp_path):
    """--eval_sample_k=3 samples 3 episodes for each of the 2 eval formulas
    and adds the mean over formulas of each one's best return."""
    run_experiment(_config(tmp_path, '--num_steps=8', '--eval_sample_k=3',
                           '--save_rollouts=none'), device='cpu')
    (rec, ) = _lines(tmp_path / 'results' / 'tiny_run-1_eval.txt')
    assert rec['return_best_mean'] >= rec['return_mean']
    assert not (tmp_path / 'data').exists() or not any(
        (tmp_path / 'data').iterdir())


def test_bf16_encoder_run_trains_and_saves(tmp_path):
    """--encoder_dtype=bfloat16 trains (its encoder through the bf16 plain
    versions here), writes a checkpoint of float32 parameters, and the
    checkpoint loads back equal into a bf16 agent."""
    from molgym_tpu_torch.agents.cormorant import (CormorantEncoder,
                                                  RadialFiltersStacked)
    config = _config(tmp_path, '--num_steps=16', '--encoder_dtype=bfloat16',
                     '--save_rollouts=none')
    seen = []   # the dtypes of the radial features and of the covariants

    def record(module, _args, out):
        if isinstance(module, RadialFiltersStacked):
            seen.append(('radial', out.dtype))
        elif isinstance(module, CormorantEncoder):
            seen.extend(('covariants', c.dtype) for c in out)
    handle = torch.nn.modules.module.register_module_forward_hook(record)
    try:
        agent, optimizer = run_experiment(config, device='cpu')
    finally:
        handle.remove()
    assert set(seen) == {('radial', torch.bfloat16),
                         ('covariants', torch.float32)}
    opt = _lines(tmp_path / 'results' / 'tiny_run-1_opt.txt')
    assert [r['total_num_steps'] for r in opt] == [0, 8]
    for rec in opt:
        assert rec['num_opt_steps'] >= 1
        assert all(v == v for v in rec.values())   # no NaN
    state, steps = ModelIO(tmp_path / 'model', 'tiny_run-1').load_latest()
    assert steps == 16 and state['optimizer']['count'] == optimizer.count
    assert all(v.dtype == torch.float32 for v in state['model'].values())
    for k, v in agent.state_dict().items():
        torch.testing.assert_close(state['model'][k], v, rtol=0, atol=0)


def test_run_main_parses_the_cli(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(run, 'run_experiment',
                        lambda config, env_builder: seen.update(config))
    run.main(TINY + ['--device=cpu'])
    assert seen['model'] == 'covariant' and seen['device'] == 'cpu'


def test_run_stochastic_main_parses_the_cli(monkeypatch):
    """The stochastic entry point adds --size_range, and nothing else, to
    the flags, and hands stochastic_envs to run_experiment."""
    seen = {}

    def fake(config, env_builder):
        seen.update(config, env_builder=env_builder)
    monkeypatch.setattr(run_stochastic, 'run_experiment', fake)
    run_stochastic.main(TINY + ['--device=cpu', '--size_range=2,4'])
    assert seen['size_range'] == '2,4' and seen['device'] == 'cpu'
    assert seen['env_builder'] is run_stochastic.stochastic_envs
    ours = vars(run_stochastic.build_parser().parse_args(
        TINY + ['--size_range=2,4']))
    assert set(ours) - set(vars(build_default_argparser().parse_args(TINY))) == {
        'size_range'}


@pytest.mark.parametrize('flag,match', [
    ('--agg_backend=einsum', 'agg_backend')])
def test_unported_options_are_refused(tmp_path, flag, match):
    config = _config(tmp_path, flag)
    with pytest.raises(NotImplementedError, match=match):
        check_supported(config)
    with pytest.raises(NotImplementedError, match=match):
        run_experiment(config, device='cpu')
    assert not (tmp_path / 'results').exists()


@pytest.mark.parametrize('flag', ['--num_devices=4', '--multihost',
                                  '--tensorboard', '--profile'])
def test_options_once_refused_are_accepted_and_run(tmp_path, monkeypatch,
                                                   flag):
    """The four options the port refused before data parallelism run two
    iterations of the tiny run: 4 gloo ranks of one env each; --multihost
    as one process of one rank (the MOLGYM_* variables), its rollouts
    tagged; the TensorBoard mirror; the profiler trace of iteration 1."""
    if flag == '--multihost':
        for key, value in (('COORDINATOR_ADDRESS',
                            f'localhost:{free_port()}'),
                           ('NUM_PROCESSES', '1'), ('PROCESS_ID', '0')):
            monkeypatch.setenv(f'MOLGYM_{key}', value)
    config = _config(tmp_path, '--num_steps=16', flag)
    check_supported(config)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # spawned ranks divide this process's threads
    try:
        run_experiment(config, device='cpu')
    finally:
        torch.set_num_threads(threads)
    opt = _lines(tmp_path / 'results' / 'tiny_run-1_opt.txt')
    assert [r['total_num_steps'] for r in opt] == [0, 8]
    assert all(r['num_opt_steps'] >= 1 for r in opt)
    log = (tmp_path / 'log' / 'tiny_run-1.log').read_text()
    rank = '_rank-0' if flag == '--multihost' else ''
    assert {p.name for p in (tmp_path / 'data').iterdir()} == {
        f'tiny_run-1_steps-{n}{rank}_{mode}.pkl'
        for n, mode in ((0, 'train'), (8, 'train'), (8, 'eval'), (16, 'eval'))}
    if flag == '--num_devices=4':
        assert 'Data-parallel rank 0 of 4 (gloo), process 0' in log
    elif flag == '--multihost':
        assert 'Data-parallel rank 0 of 1 (gloo), process 0' in log
    elif flag == '--tensorboard':
        events = list((tmp_path / 'log' / 'tb' / 'tiny_run-1').iterdir())
        assert len(events) == 1 and events[0].stat().st_size > 0
        assert events[0].name.startswith('events.out.tfevents.')
    else:
        trace = json.loads((tmp_path / 'log' / 'profile' /
                            'iteration-1.trace.json').read_text())
        names = {e.get('name', '') for e in trace['traceEvents']}
        assert any('aten::' in n for n in names)


def test_tensorboard_falls_back_to_json_lines(tmp_path, monkeypatch, caplog):
    """Without the tensorboard package the InfoSaver warns and writes JSON
    lines only, as the JAX package does without tensorboardX."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    saver = util.InfoSaver(str(tmp_path), 'tag',
                           tensorboard_dir=str(tmp_path / 'tb'))
    assert 'tensorboard not available; JSONL only' in caplog.text
    saver.save({'loss': np.float32(0.5), 'total_num_steps': 8}, name='opt')
    saver.close()
    assert _lines(tmp_path / 'tag_opt.txt') == [{'loss': 0.5,
                                                  'total_num_steps': 8}]
    assert not (tmp_path / 'tb').exists()


@pytest.mark.parametrize('model', ['internal', 'mlp'])
def test_internal_models_train_save_and_resume(tmp_path, model):
    """--model=internal (2 SchNet interactions) and --model=mlp train two
    iterations, keep a checkpoint of the final state, and resume from it
    with the step count and optimizer state it holds."""
    from molgym_tpu_torch.agents.internal import AtomMLPEncoder, InternalAC
    from molgym_tpu_torch.agents.schnet import SchNetEncoder
    flags = [f'--model={model}', '--num_interactions=2', '--save_rollouts=none']
    agent, optimizer = run_experiment(_config(tmp_path, '--num_steps=16',
                                              *flags), device='cpu')
    assert isinstance(agent, InternalAC)
    encoder = SchNetEncoder if model == 'internal' else AtomMLPEncoder
    assert isinstance(agent.encoder, encoder)
    if model == 'internal':
        assert len(agent.encoder.interactions) == 2
    results = tmp_path / 'results'
    opt = _lines(results / 'tiny_run-1_opt.txt')
    assert [r['total_num_steps'] for r in opt] == [0, 8]
    for rec in opt:
        assert rec['num_opt_steps'] >= 1
        assert all(v == v for v in rec.values())   # no NaN
    (train, _) = _lines(results / 'tiny_run-1_train.txt')
    assert np.isfinite(train['return_mean'])
    state, steps = ModelIO(tmp_path / 'model', 'tiny_run-1').load_latest()
    assert steps == 16 and state['optimizer']['count'] == optimizer.count
    for k, v in agent.state_dict().items():
        torch.testing.assert_close(state['model'][k], v, rtol=0, atol=0)

    resumed, opt2 = run_experiment(
        _config(tmp_path, '--num_steps=24', '--load_latest', *flags),
        device='cpu')
    opt = _lines(results / 'tiny_run-1_opt.txt')
    assert [r['total_num_steps'] for r in opt] == [0, 8, 16]
    assert opt2.count == optimizer.count + opt[-1]['num_opt_steps']
    assert any(not torch.equal(v, resumed.state_dict()[k])
               for k, v in agent.state_dict().items())


@pytest.mark.parametrize('model', ['internal', 'mlp'])
def test_bf16_encoder_is_refused_for_the_internal_models(tmp_path, model):
    """The bf16 path is the covariant encoder's: with an internal model
    --encoder_dtype=bfloat16 is refused, never ignored."""
    config = _config(tmp_path, f'--model={model}', '--encoder_dtype=bfloat16')
    with pytest.raises(NotImplementedError, match='encoder_dtype'):
        check_supported(config)
    check_supported(_config(tmp_path, f'--model={model}'))


def test_sparrow_reward_raises_through_its_gate(tmp_path):
    """--reward=sparrow is accepted, and its calculator raises where scine
    is not installed, before anything is written."""
    config = _config(tmp_path, '--reward=sparrow')
    check_supported(config)
    with pytest.raises(RuntimeError, match='scine_sparrow'):
        run_experiment(config, device='cpu')
    assert not (tmp_path / 'results').exists()


@pytest.fixture
def one_torch_thread():
    """One intra-op thread while the test runs: the suite runs six workers
    on the host's cores, and torch's thread pool then waits at its barriers
    for threads the other workers hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.usefixtures('one_torch_thread')
@pytest.mark.parametrize('flags,transport', [
    (['--reward=pm6'], 'pipelined'), (['--reward=eht'], 'pipelined'),
    (['--reward=lj'], 'pipelined'), (['--reward=morse'], 'pipelined'),
    (['--reward=pm6', '--host_reward_mode=loop'], 'pipelined'),
    (['--reward=pm6', '--host_reward_mode=loop_serial'], 'in_step'),
    (['--reward=pm6', '--host_reward_mode=callback'], 'in_step')],
    ids=['pm6', 'eht', 'lj', 'morse', 'pm6-loop', 'pm6-loop_serial',
         'pm6-callback'])
def test_host_reward_options_run(tmp_path, flags, transport):
    """Each host reward and transport passes check_supported and trains an
    iteration; the train info names the transport and the seconds spent in
    the host reward, and the pipelined transport counts its recomputes, in
    training and in evaluation. loop_serial steps in the env: the in-step
    transport is the serial loop. auto (the default) measures both
    transports, the pipelined one first, so its one iteration is
    pipelined."""
    config = _config(tmp_path, '--num_steps=8', '--save_rollouts=none', *flags)
    check_supported(config)
    run_experiment(config, device='cpu')
    (train, ) = _lines(tmp_path / 'results' / 'tiny_run-1_train.txt')
    assert train['transport'] == transport
    assert train['reward_time'] > 0
    assert ('recomputes' in train) == (transport == 'pipelined')
    (opt, ) = _lines(tmp_path / 'results' / 'tiny_run-1_opt.txt')
    assert opt['num_opt_steps'] >= 1 and opt['total_loss'] == opt['total_loss']
    (evals, ) = _lines(tmp_path / 'results' / 'tiny_run-1_eval.txt')
    assert np.isfinite(evals['return_mean'])
    assert ('recomputes' in evals) == (transport == 'pipelined')
    assert evals['transport'] == transport
