"""Data parallelism of the port (molgym_tpu_torch/parallel/mesh.py) on the
CPU, over gloo processes: the update of W = 2 and W = 3 ranks against the
JAX package's make_train_fn and against the port's own single-process
update, the replicas' bits, the trajectory gather and the start broadcast,
W = 1 batch_ppo(mesh=...) against plain batch_ppo bit for bit, and the
driver's --num_devices and --multihost runs and refusals, each against the
same run in one process (test_torch_parallel_draws.py's gates: the run
does not depend on W).

Tolerances: against JAX those of test_torch_ppo.py's
test_train_matches_make_train_fn (rtol 1e-4 on the info,
assert_params_close). Against the port's own update in one process, two
gates on the first step's reduced gradient: within 1e-6 of each leaf's max
|g| of the same chunks computed in one process (chunked_grads: only the sum
over ranks is in another order; measured 3.7e-7 at worst), and within 1e-3 of
plain make_train_fn's, since running a minibatch as chunks rounds otherwise
(the agent's batched ops at another batch size): in one process, chunks of
2, 1 and 1 already move an epoch's gradient by up to 1.8e-4 of a leaf's max
|g|. The info within rtol 1e-4, the parameters by assert_params_close's
rule: not every parameter within 1e-5 of its leaf's max |p|, since a
gradient that is zero but for float32 noise (the focus head's last bias: a
softmax ignores a shared shift) gets Adam's lr-sized step of the noise's
sign. The replicas, and W = 1 against plain batch_ppo: the same bits."""
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from molgym_tpu.rl import ppo as jppo
from molgym_tpu_torch import run
from molgym_tpu_torch.parallel import mesh as pmesh
from molgym_tpu_torch.rl import ppo
from molgym_tpu_torch.tools.driver import run_experiment
from molgym_tpu_torch.tools.model_io import ModelIO
from tests import torch_parallel_ranks as ranks
from tests.test_torch_covariant import SMALL, make_batch, torch_obs
from tests.test_torch_parallel_draws import (assert_params_rule,
                                             assert_records_match)
from tests.test_torch_ppo import CONFIG, Setup, assert_params_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 240   # each spawn's and subprocess's time limit

# the O2 mlp configuration of tests/test_parallel.py's build(), through the
# CLI
O2_MLP = ['--name=dp', '--formulas=O2', '--symbols=X,O', '--canvas_size=3',
          '--bag_scale=3', '--reward=device_lj', '--model=mlp',
          '--network_width=16', '--device=cpu', '--num_envs=4',
          '--num_steps=16', '--num_steps_per_iter=8', '--mini_batch_size=4',
          '--max_num_train_iters=2', '--eval_freq=1', '--save_freq=1',
          '--seed=1']


@pytest.fixture
def one_thread():
    """Spawned ranks divide this process's threads: one each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def spawn(fn, world, *args):
    launch = pmesh.Launch(world, world, 0, 'localhost', pmesh.free_port())
    return pmesh.spawn(fn, launch, args, timeout=JOIN_S)


def _ppo_data(agent, n, seed, logp_noise=0.05):
    """PPO data of n random SMALL canvases: actions the agent samples,
    old log-probs its own plus noise, random advantages and returns."""
    rng = np.random.RandomState(seed)
    obs = torch_obs(make_batch(SMALL, n, seed))
    with torch.no_grad():
        out = agent.act(obs, torch.Generator().manual_seed(seed), False)
    return dict(obs=obs, act=out.action_flat,
                logp=out.logp + logp_noise * torch.from_numpy(
                    rng.randn(n).astype(np.float32)),
                adv=torch.from_numpy(rng.randn(n).astype(np.float32)),
                ret=torch.from_numpy(rng.randn(n).astype(np.float32)))


class Cases:
    """The JAX case (test_torch_ppo's Setup: 8 samples, minibatch 4, so the
    update does not depend on the permutation) and two of the port's own:
    14 samples in minibatches of 4 with a padded remainder, 3 epochs
    without a KL stop; and the same data with every advantage negative,
    old log-probs at the current parameters and target_kl 1e-4, where the
    first epoch steps (approx-KL at the noise floor) and the step lowers
    every log-prob past 1.5 * target_kl, so the second stops."""

    def __init__(self):
        self.setup = Setup()
        self.state = self.setup.pair.agent.state_dict()
        agent = self.setup.fresh_agent()
        padded = _ppo_data(agent, 14, seed=11)
        kl = dict(padded, adv=-torch.ones(14))
        with torch.no_grad():
            kl['logp'], _e, _v = agent.evaluate(kl['obs'], kl['act'])
        self.cases = [
            (CONFIG, self.setup.torch_data(), 0),
            (CONFIG._replace(mini_batch_size=4, max_num_train_iters=3), padded,
             1),
            (CONFIG._replace(mini_batch_size=4, target_kl=1e-4,
                             learning_rate=1e-2, vf_coef=0.0,
                             entropy_coef=0.0), kl, 2)]
        self.single = [ranks.train_once(SMALL, self.state, *case)
                       for case in self.cases]
        self.dp = {}

    def world(self, w):
        if w not in self.dp:
            with_one_thread = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                self.dp[w] = spawn(ranks.update_rank, w, w, SMALL, self.state,
                                   self.cases)
            finally:
                torch.set_num_threads(with_one_thread)
        return self.dp[w]


@pytest.fixture(scope='module')
def cases():
    return Cases()


@pytest.mark.parametrize('world', [2, 3])
def test_dp_update_matches_jax_make_train_fn(cases, world):
    """Minibatch 4 over W ranks (chunks 2+2, or 2+1+1), against the JAX
    update of one process on the same data."""
    setup = cases.setup
    jopt = jppo.make_optimizer(CONFIG)
    jparams, _s, jinfo = jppo.make_train_fn(
        setup.pair.jagent, jopt, CONFIG, setup.n)(
            setup.pair.params, jopt.init(setup.pair.params), setup.jax_data(),
            jax.random.PRNGKey(0))
    for res in cases.world(world):
        params, info, _grads = res['updates'][0]
        assert info['num_opt_steps'] == int(jinfo['num_opt_steps']) == 3
        for key in ppo.INFO_KEYS + ('grad_norm', ):
            np.testing.assert_allclose(info[key], float(jinfo[key]),
                                       rtol=1e-4, atol=1e-6)
        agent = setup.fresh_agent()
        agent.load_state_dict(params, strict=False)
        assert_params_close(agent, jparams, CONFIG.learning_rate, 3)


def assert_grads_within(grads, ref, tol):
    """assert_grads_close's rule: each leaf within `tol` of its max |g|; a
    leaf below 1e-3 of the largest leaf's (zero but for noise) is held
    against 1e-3 of the largest leaf's instead."""
    floor = 1e-3 * max(float(g.abs().max()) for g in ref.values())
    for name, g in grads.items():
        scale = max(float(ref[name].abs().max()), floor)
        assert float((g - ref[name]).abs().max()) <= tol * scale, name


@pytest.mark.parametrize('case', [1, 2], ids=['padded', 'kl_stop'])
@pytest.mark.parametrize('world', [2, 3])
def test_dp_update_matches_single_process(cases, world, case):
    """Several minibatches with a padded remainder (its last chunks of
    weight 0 at W = 3), with and without the KL stop: the steps of one
    process, its gradient, info and parameters, and the same bits on every
    rank."""
    config = cases.cases[case][0]
    ref_params, ref_info, ref_grads = cases.single[case]
    same_chunks = ranks.chunked_grads(SMALL, cases.state, *cases.cases[case],
                                      world)
    results = cases.world(world)
    assert [r['rank'] for r in results] == list(range(world))
    for res in results:
        params, info, grads = res['updates'][case]
        assert info['num_opt_steps'] == ref_info['num_opt_steps']
        assert info['num_grad_passes'] == ref_info['num_grad_passes']
        assert info['num_opt_steps'] == (1 if case == 2 else 3)
        assert_grads_within(grads, same_chunks, 1e-6)
        assert_grads_within(grads, ref_grads, 1e-3)
        for key in ppo.INFO_KEYS + ('grad_norm', ):
            np.testing.assert_allclose(info[key], ref_info[key], rtol=1e-4,
                                       atol=1e-6)
        # assert_params_close's rule, against the port's own parameters
        lr, steps = config.learning_rate, info['num_opt_steps']
        n_off = 0
        for name, p in params.items():
            diff = (p - ref_params[name]).abs()
            assert float(diff.max()) <= 2 * lr * steps + 1e-5, name
            n_off += int((diff > 1e-5).sum())
        assert n_off <= 0.01 * sum(p.numel() for p in params.values())
        first = results[0]['updates'][case]
        assert info == first[1]
        assert all(torch.equal(p, first[0][k]) for k, p in params.items())


@pytest.mark.parametrize('world', [2, 3])
def test_gather_and_start_broadcast(cases, world):
    """The gathered trajectory holds every rank's envs along the env axis in
    rank order; after the start broadcast every replica holds rank 0's
    parameters, optimizer state and step count."""
    results = cases.world(world)
    want = {f: torch.cat([getattr(ranks.marked_trajectory(r), f) for r in
                          range(world)], 0 if f == 'bootstrap_value' else 1)
            for f in ('actions', 'rewards', 'terminals', 'values', 'logps',
                      'bootstrap_value')}
    zero_params, _count, _mu = results[0]['broadcast']
    for res in results:
        got = res['gathered']
        for name, value in want.items():
            assert got[name].dtype == value.dtype
            assert torch.equal(got[name], value), name
        for o in ('obs', 'next_obs'):
            for f in ('elements', 'positions', 'bag'):
                assert torch.equal(getattr(got[o], f), torch.cat(
                    [getattr(getattr(ranks.marked_trajectory(r), o), f)
                     for r in range(world)], 1))
        params, count, mu = res['broadcast']
        assert count == 5
        assert all(torch.equal(v, torch.ones_like(v)) for v in mu.values())
        assert all(torch.equal(p, zero_params[k]) for k, p in params.items())
    state = cases.state
    assert all(torch.equal(p, state[k]) for k, p in zero_params.items())


def test_w1_batch_ppo_matches_plain_batch_ppo(one_thread):
    """W = 1: batch_ppo(mesh=make_mesh(1, 'cpu')) is plain batch_ppo, bit
    for bit, over 2 iterations with evaluation (the times aside)."""
    kwargs = dict(num_envs=4, num_steps_per_iter=8, max_num_steps=16,
                  config=ppo.PPOConfig(mini_batch_size=6,
                                       max_num_train_iters=2),
                  eval_freq=1, seed=3)
    res = spawn(ranks.batch_ppo_rank, 1, kwargs)[0]
    (plain, plain_lines), (dp, dp_lines) = res['plain'], res['mesh']
    assert plain.keys() == dp.keys()
    assert all(torch.equal(plain[k], dp[k]) for k in plain)
    assert len(plain_lines) == len(dp_lines) == 6   # train, opt, eval twice

    def untimed(lines):
        return [(n, {k: v for k, v in r.items()
                     if k not in ('time', 'iteration_time')})
                for n, r in lines]
    assert json.dumps(untimed(plain_lines)) == json.dumps(untimed(dp_lines))


@pytest.mark.parametrize('world', [1, 2])
def test_dp_iteration_matches_batch_ppo(one_thread, world):
    """make_dp_ppo_iteration's iteration is batch_ppo(mesh=...)'s, bit for
    bit: the parameters after one iteration and the update's info, on
    every rank."""
    kwargs = dict(num_envs=4, num_steps_per_iter=8, seed=3,
                  config=ppo.PPOConfig(mini_batch_size=6,
                                       max_num_train_iters=2))
    for res in spawn(ranks.dp_iteration_rank, world, world, kwargs):
        (params, info), (ppo_params, lines) = (res['iteration'],
                                               res['batch_ppo'])
        assert params.keys() == ppo_params.keys()
        assert all(torch.equal(p, ppo_params[k]) for k, p in params.items())
        opt = [r for n, r in lines if n == 'opt']
        assert len(opt) == 1 and info['num_opt_steps'] >= 1
        assert {k: opt[0][k] for k in info} == info


def test_dryrun_multichip_on_the_cpu(one_thread, capsys):
    info = pmesh.dryrun_multichip(2, 'cpu')
    assert info['num_envs'] == 8 and np.isfinite(info['total_loss'])
    assert 'dryrun_multichip OK: 2 ranks on cpu' in capsys.readouterr().out


def _dirs(path):
    return [f'--{d}_dir={path / d}' for d in ('log', 'model', 'data',
                                              'results')]


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _one_process_run(path):
    """O2_MLP in this process, writing under `path`: (its results
    directory, its checkpoint)."""
    run.main(O2_MLP + _dirs(path))
    return (path / 'results',
            ModelIO(path / 'model', 'dp_run-1').load_latest()[0])


def assert_run_matches(results, state, ref_results, ref_state, rank0=True):
    """A data-parallel run's records and checkpoint against one process's:
    the train, opt and eval streams (a writer's) within rtol 1e-4, the
    parameters by assert_params_close's rule, the same step count."""
    for stream in ('train', 'opt', 'eval'):
        assert_records_match(
            [(stream, r) for r in _lines(results / f'dp_run-1_{stream}.txt')],
            [(stream, r) for r in _lines(ref_results
                                         / f'dp_run-1_{stream}.txt')])
    count = ref_state['optimizer']['count']
    assert state['optimizer']['count'] == count
    lr = run.build_default_argparser().parse_args(O2_MLP).learning_rate
    assert_params_rule(state['model'], ref_state['model'], lr, count)


def test_cpu_num_devices_2_run(tmp_path, one_thread):
    """--device=cpu --num_devices=2 through molgym_tpu_torch.run: rank 0
    writes one of each stream, log, config and checkpoint, untagged, as one
    process would, and rank 1 nothing; the checkpoint is the state the run
    returns; the records and the checkpoint are those of the same run in
    one process."""
    dp_path = tmp_path / 'dp'
    agent, optimizer = run.main(O2_MLP + _dirs(dp_path)
                                + ['--num_devices=2', '--save_rollouts=all'])
    files = sorted(str(p.relative_to(dp_path)) for p in dp_path.rglob('*')
                   if p.is_file())
    assert files == [
        'data/dp_run-1_steps-0_train.pkl', 'data/dp_run-1_steps-16_eval.pkl',
        'data/dp_run-1_steps-8_eval.pkl', 'data/dp_run-1_steps-8_train.pkl',
        'log/dp_run-1.json', 'log/dp_run-1.log',
        'model/dp_run-1_steps-16.model', 'results/dp_run-1_eval.txt',
        'results/dp_run-1_opt.txt', 'results/dp_run-1_train.txt']
    opt = _lines(dp_path / 'results' / 'dp_run-1_opt.txt')
    assert [r['total_num_steps'] for r in opt] == [0, 8]
    assert all(r['num_opt_steps'] >= 1 for r in opt)
    assert optimizer.count == sum(r['num_opt_steps'] for r in opt)
    with open(dp_path / 'data' / 'dp_run-1_steps-8_train.pkl', 'rb') as f:
        # the global trajectory: 2 steps of all 4 envs
        assert pickle.load(f)['rewards'].shape == (2, 4)
    state, steps = ModelIO(dp_path / 'model', 'dp_run-1').load_latest()
    assert steps == 16 and state['optimizer']['count'] == optimizer.count
    for k, v in agent.state_dict().items():
        assert torch.equal(state['model'][k], v), k
    for k, v in optimizer.mu.items():
        assert torch.equal(state['optimizer']['mu'][k], v), k
    assert_run_matches(dp_path / 'results', state,
                       *_one_process_run(tmp_path / 'one'))


def test_two_process_multihost_run(tmp_path):
    """Two processes of --multihost --num_devices=2 with the MOLGYM_*
    variables (tests/test_parallel.py's multihost driver run): each
    process's rank writes its checkpoint and streams under its own
    directories, and rank-tagged rollouts into the shared data_dir; the
    records and checkpoint of each are those of the same run in one
    process."""
    port = pmesh.free_port()
    data_dir = tmp_path / 'data'
    procs = []
    for proc_id in range(2):
        env = dict(os.environ, OMP_NUM_THREADS='1',
                   MOLGYM_COORDINATOR_ADDRESS=f'localhost:{port}',
                   MOLGYM_NUM_PROCESSES='2', MOLGYM_PROCESS_ID=str(proc_id),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get(
                       'PYTHONPATH', ''))
        rank_dir = tmp_path / f'rank{proc_id}'
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'molgym_tpu_torch.run'] + O2_MLP + [
                '--num_devices=2', '--multihost', '--save_rollouts=eval',
                f'--log_dir={rank_dir}/logs',
                f'--model_dir={rank_dir}/models',
                f'--results_dir={rank_dir}/results', f'--data_dir={data_dir}'],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=str(tmp_path), text=True))
    try:
        outs = [p.communicate(timeout=JOIN_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'process {i} failed:\n{out}'
        assert f'Data-parallel rank {i} of 2 (gloo), process {i}' in out
    assert sorted(f.name for f in data_dir.iterdir()) == sorted(
        f'dp_run-1_steps-{s}_rank-{r}_eval.pkl' for r in range(2)
        for s in (8, 16))
    params = []
    for rank in range(2):
        rank_dir = tmp_path / f'rank{rank}'
        assert [p.name for p in (rank_dir / 'models').iterdir()] == [
            'dp_run-1_steps-16.model']
        assert len(_lines(rank_dir / 'results' / 'dp_run-1_eval.txt')) == 2
        state, _steps = ModelIO(rank_dir / 'models', 'dp_run-1').load_latest()
        params.append(state)
    for k, v in params[0]['model'].items():
        assert torch.equal(params[1]['model'][k], v), k
    ref = _one_process_run(tmp_path / 'one')
    for rank in range(2):
        assert_run_matches(tmp_path / f'rank{rank}' / 'results',
                           params[rank], *ref)


def test_auto_transport_at_w2(one_thread):
    """--host_reward_mode=auto at W = 2 over gloo: the ranks lock in one
    transport, also where each rank's own timings favour another (the
    stubs: the MAX over the ranks of each timed probe decides); a 5
    iterations' run (torch_parallel_ranks.AUTO_RUN) probes pipelined,
    in_step, pipelined, in_step on both ranks and then keeps the same
    transport on both, and its records and parameters are those of the same
    run in one process (test_torch_parallel_draws.py's gates; the
    transport, which each run measures for itself, and the recomputes
    that follow it, aside: _measured_aside)."""
    results = spawn(ranks.auto_rank, 2, 2)
    assert [r['rank'] for r in results] == [0, 1]
    (choice, times), (choice1, times1) = (r['stub'] for r in results)
    assert choice == choice1 and times == times1
    assert min(times.values()) >= 0.05
    want = ranks.draws_run('auto')
    lr = ranks.draws_config('auto')['learning_rate']
    steps = sum(r['num_opt_steps'] for n, r in want['records'] if n == 'opt')
    transports = []
    for res in results:
        got = res['run']
        train = [r['transport'] for n, r in got['records'] if n == 'train']
        assert train[:4] == ['pipelined', 'in_step'] * 2
        transports.append(train[4])
        assert_params_rule(got['params'], want['params'], lr, steps)
        assert_records_match(
            [(n, _measured_aside(n, r)) for n, r in got['records']],
            [(n, _measured_aside(n, r)) for n, r in want['records']
             if n != 'eval' or res['rank'] == 0])
    assert transports[0] == transports[1] in ('pipelined', 'in_step')


def _measured_aside(name, rec):
    """A record without what depends on the transport that its run measured
    and kept: the transport, and the recomputes that a pipelined rollout
    alone reports, asserted present on a train or eval record exactly
    where its transport is pipelined."""
    if name in ('train', 'eval'):
        assert ('recomputes' in rec) == (rec['transport'] == 'pipelined'), (
            name, rec)
    return {k: v for k, v in rec.items()
            if k not in ('transport', 'recomputes')}


def test_num_envs_must_divide_over_the_ranks(tmp_path):
    argv = O2_MLP + _dirs(tmp_path) + ['--num_devices=3']
    with pytest.raises(ValueError, match=r'num_envs \(4\).*3 data-parallel'):
        run.main(argv)
    assert not tmp_path.joinpath('results').exists()


def test_num_devices_on_cuda_without_a_card_raises(tmp_path):
    argv = [a for a in O2_MLP if a != '--device=cpu'] + _dirs(tmp_path)
    with pytest.raises(ValueError, match='2 local ranks need 2 CUDA devices; '
                       '0 visible'):
        run.main(argv + ['--num_devices=2'])
    assert not tmp_path.joinpath('results').exists()


def test_launch_from_the_variables(monkeypatch):
    """--multihost reads the MOLGYM_* variables, else torchrun's, else
    raises; without it, --num_devices > 1 spawns that many local ranks."""
    for key in ('MOLGYM_COORDINATOR_ADDRESS', 'MOLGYM_NUM_PROCESSES',
                'MOLGYM_PROCESS_ID', 'RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                'MASTER_PORT', 'GROUP_RANK'):
        monkeypatch.delenv(key, raising=False)
    assert pmesh.launch_from(0, False) is None
    assert pmesh.launch_from(1, False) is None
    two = pmesh.launch_from(2, False)
    assert (two.world_size, two.local_ranks, two.process_id) == (2, 2, 0)
    with pytest.raises(RuntimeError, match='MOLGYM_COORDINATOR_ADDRESS'):
        pmesh.launch_from(4, True)
    monkeypatch.setenv('RANK', '3')
    monkeypatch.setenv('WORLD_SIZE', '4')
    monkeypatch.setenv('MASTER_ADDR', 'node0')
    monkeypatch.setenv('MASTER_PORT', '29500')
    monkeypatch.setenv('GROUP_RANK', '1')
    assert pmesh.launch_from(4, True) == pmesh.Launch(4, 0, 1, 'node0', 29500)
    with pytest.raises(ValueError, match='torchrun world of 4'):
        pmesh.launch_from(2, True)
    monkeypatch.setenv('MOLGYM_COORDINATOR_ADDRESS', 'host1:1234')
    monkeypatch.setenv('MOLGYM_NUM_PROCESSES', '2')
    monkeypatch.setenv('MOLGYM_PROCESS_ID', '1')
    assert pmesh.launch_from(4, True) == pmesh.Launch(4, 2, 1, 'host1', 1234)
    assert pmesh.launch_from(0, True) == pmesh.Launch(2, 1, 1, 'host1', 1234)
    with pytest.raises(ValueError, match='does not divide over 2'):
        pmesh.launch_from(3, True)


def test_a_failing_rank_fails_the_run(tmp_path, one_thread):
    """A rank's exception reaches the caller, with its message."""
    config = vars(run.build_default_argparser().parse_args(
        O2_MLP + _dirs(tmp_path) + ['--num_devices=2', '--load_latest']))
    with pytest.raises(Exception, match='Cannot find model to load'):
        run_experiment(config)
