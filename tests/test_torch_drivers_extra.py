"""The port's solvation, scaffold and QM9 drivers on the CPU, against the
JAX package's scripts/run_solvation.py, run_scaffold.py and run_qm9.py:
their flags, their env builders' arrays from the recorded configurations
(bags, the pre-placed canvas, refills, the scaffold's hull), the rewards of
the same placements (the solvation penalty with the device LJ and with PM6
on the host; the scaffold's PM6 without its Ar atoms), the scaffold's two
refusals; then two PPO iterations of each driver at a tiny size with their
JSON-lines streams, a checkpoint and a resume, the solvation penalty
through both rollout transports, and the host tools (structures.py,
tools/analysis.py, plot.py) on what the runs wrote.

Tolerances: the env arrays exactly; device LJ rewards to 1e-6 (float32,
another summation order); PM6 rewards to 1e-6 (the same C++ library in
float64, rounded to float32 in both)."""
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.run_qm9 as jax_run_qm9
import scripts.run_scaffold as jax_run_scaffold
import scripts.run_solvation as jax_run_solvation
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu.tools import driver as jax_driver
from molgym_tpu_torch import plot, run_qm9, run_scaffold, run_solvation
from molgym_tpu_torch import structures
from molgym_tpu_torch.atoms import read_xyz
from molgym_tpu_torch.calculators import native
from molgym_tpu_torch.calculators.reward_host import make_host_reward
from molgym_tpu_torch.envs.environment import MolecularEnv
from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
from molgym_tpu_torch.tools import analysis, driver
from molgym_tpu_torch.tools.arg_parser import build_default_argparser
from molgym_tpu_torch.tools.model_io import ModelIO

from .test_torch_driver_checkpoints import EXPERIMENTS, recorded_config
from .test_torch_host_reward import \
    jax_library_built_from_csrc  # noqa: F401  (module fixture)

SOLUTE = str(EXPERIMENTS / 'solvation' / 'solute.xyz')
CUBE = str(EXPERIMENTS / 'scaffold_pm6' / 'cube.xyz')
QM9_SAMPLE = str(EXPERIMENTS / 'qm9_pm6' / 'qm9_sample.tar.gz')

# (port module, JAX script module, recorded run, the driver's own flags)
DRIVERS = {
    'solvation': (run_solvation, jax_run_solvation, ('solvation', 'solv_run-1'),
                  {'initial_structure', 'num_refills', 'distance_penalty'}),
    'scaffold': (run_scaffold, jax_run_scaffold,
                 ('scaffold_pm6', 'scafpm6_run-1'), {'scaffold'}),
    'qm9': (run_qm9, jax_run_qm9, ('qm9_pm6', 'qm9pm6_run-1'),
            {'qm9_dataset', 'qm9_num_formulas', 'qm9_selection_seed'}),
}
# tiny configurations of the three recorded runs: width 16, 2 SchNet
# interactions or maxl 2 and 2 CG levels, 4 envs x 4 steps
TINY = {
    'solvation': ['--name=solv', '--formulas=H2O', f'--initial_structure={SOLUTE}',
                  '--num_refills=2', '--canvas_size=12', '--symbols=X,H,C,O',
                  '--bag_scale=4', '--model=internal', '--network_width=16',
                  '--num_interactions=2', '--reward=device_lj'],
    'scaffold': ['--name=scaf', '--formulas=H2O', f'--scaffold={CUBE}',
                 '--canvas_size=12', '--symbols=X,H,O,Ar', '--bag_scale=3',
                 '--model=internal', '--network_width=16',
                 '--num_interactions=2', '--reward=pm6'],
    'qm9': ['--name=qm9', f'--qm9_dataset={QM9_SAMPLE}',
            '--qm9_num_formulas=4', '--canvas_size=7',
            '--symbols=X,H,C,N,O,F', '--bag_scale=6', '--model=covariant',
            '--maxl=2', '--num_cg_levels=2', '--network_width=16',
            '--num_channels_hidden=3', '--num_channels_per_element=2',
            '--beta=-10', '--reward=device_lj'],
}
COMMON = ['--num_envs=4', '--num_steps_per_iter=16', '--mini_batch_size=16',
          '--max_num_train_iters=2', '--save_freq=1', '--eval_freq=1',
          '--seed=1', '--save_rollouts=eval', '--device=cpu',
          '--log_level=WARNING']


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's
    cores, and torch's thread pool then waits at its barriers for threads
    the other workers hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _argv(name, tmp_path, *extra):
    dirs = [f'--{d}_dir={tmp_path / d}' for d in ('log', 'model', 'data',
                                                  'results')]
    return TINY[name] + COMMON + dirs + list(extra)


# -- flags and env builders -----------------------------------------------------

@pytest.mark.parametrize('name', list(DRIVERS))
def test_parsers_add_the_drivers_flags(name):
    """Each driver adds its own flags, with the JAX script's defaults, to
    the port's CLI; run_qm9's --formulas is optional."""
    module, jax_module, _run, own = DRIVERS[name]
    argv = TINY[name] + (['--formulas=H2O'] if name == 'qm9' else [])
    ours = vars(module.build_parser().parse_args(argv))
    base = vars(build_default_argparser().parse_args(
        [a for a in argv if a.split('=')[0][2:] not in own]))
    assert set(ours) - set(base) == own
    if name == 'qm9':
        jax_defaults = {'qm9_num_formulas': 4, 'qm9_selection_seed': 0}
        assert module.build_parser().parse_args(TINY[name]).formulas is None
    else:
        jax_defaults = vars(jax_module.build_parser().parse_args(
            ['--name=x', '--formulas=H2O', '--bag_scale=3']
            + (['--scaffold=x'] if name == 'scaffold' else [])))
    for key in own - {'initial_structure', 'scaffold', 'qm9_dataset'}:
        default = vars(module.build_parser().parse_args(
            [a for a in argv if a.split('=')[0][2:] != key]))[key]
        assert default == jax_defaults[key], key


@pytest.mark.parametrize('name', ['solvation', 'scaffold'])
def test_main_hands_its_env_builder(name, monkeypatch):
    seen = {}

    def fake(config, env_builder, **kwargs):
        seen.update(config=config, env_builder=env_builder, **kwargs)
    module = DRIVERS[name][0]
    monkeypatch.setattr(module, 'run_experiment', fake)
    module.main(TINY[name] + ['--device=cpu'])
    assert seen['env_builder'] is getattr(module, f'{name}_envs')
    assert seen.get('solvation', False) == (name == 'solvation')
    assert seen['config']['device'] == 'cpu'


def test_run_qm9_main_selects_and_prints_the_bag_set(monkeypatch, capsys):
    """run_qm9 with the recorded QM9 flags draws CNH,COH2,CFH3,CO2H2 and
    trains on the standard envs; --formulas is ignored, as in the JAX
    script, so a JAX command line that carries it trains on the same bags."""
    seen = {}
    monkeypatch.setattr(run_qm9, 'run_experiment', seen.update)
    run_qm9.main(TINY['qm9'] + ['--device=cpu', '--qm9_selection_seed=0'])
    assert seen['formulas'] == 'CNH,COH2,CFH3,CO2H2'
    assert 'QM9-sampled formulas: CNH,COH2,CFH3,CO2H2' in capsys.readouterr().out
    run_qm9.main(TINY['qm9'] + ['--device=cpu', '--formulas=H2O,CH4'])
    assert seen['formulas'] == 'CNH,COH2,CFH3,CO2H2'


def _env_pairs(name, reward='device_lj', solvation=False):
    """(port (train, eval), JAX (train, eval)) envs of the recorded run of
    driver `name`, from each package's builder and make_reward_fn."""
    module, jax_module, (experiment, tag), _own = DRIVERS[name]
    config = recorded_config(experiment, tag)
    config['reward'] = reward
    zs = symbols_to_zs(config['symbols'])
    builder = getattr(module, f'{name}_envs', driver.standard_envs)
    jbuilder = getattr(jax_module, f'{name}_envs', jax_driver.standard_envs)
    fn = driver.make_reward_fn(config, solvation=solvation)[0]
    jfn = jax_driver.make_reward_fn(config, solvation=solvation)[0]
    return (builder(config, ObservationSpace(config['canvas_size'], zs), fn,
                    torch.device('cpu')),
            jbuilder(config, JaxObservationSpace(config['canvas_size'], zs),
                     jfn))


@pytest.mark.parametrize('name', list(DRIVERS))
def test_env_builders_match_jax(name):
    """The recorded runs' training and evaluation envs hold the JAX
    builder's arrays: the bags, the pre-placed canvas, its atom count,
    the refills, the scaffold's hull and size."""
    for env, jenv in zip(*_env_pairs(name)):
        np.testing.assert_array_equal(env.formulas.numpy(),
                                      np.asarray(jenv.formulas))
        np.testing.assert_array_equal(env.initial_elements.numpy(),
                                      np.asarray(jenv.initial_elements))
        np.testing.assert_array_equal(env.initial_positions.numpy(),
                                      np.asarray(jenv.initial_positions))
        assert env.initial_n_atoms == int(jenv.initial_n_atoms)
        assert (env.num_refills, env.n_scaffold) == (jenv.num_refills,
                                                     jenv.n_scaffold)
        assert (env.hull_a is None) == (jenv.hull_a is None)
        if env.hull_a is not None:
            np.testing.assert_array_equal(env.hull_a.numpy(),
                                          np.asarray(jenv.hull_a))
            np.testing.assert_array_equal(env.hull_b.numpy(),
                                          np.asarray(jenv.hull_b))
    expected = {'solvation': (2, 2, 0), 'scaffold': (8, 0, 8),
                'qm9': (0, 0, 0)}[name]
    assert (env.initial_n_atoms, env.num_refills, env.n_scaffold) == expected
    if name == 'qm9':
        assert env.formulas.shape == (4, 6)


@pytest.mark.parametrize('name', ['solvation', 'scaffold'])
def test_scaffold_and_solute_refusals(name, tmp_path):
    """A canvas without a free slot beside the pre-placed atoms, or one of
    their elements missing from --symbols: ValueError, with the JAX
    scaffold driver's message."""
    module, jax_module, (experiment, tag), _own = DRIVERS[name]
    config = recorded_config(experiment, tag)
    n = len(read_xyz(SOLUTE if name == 'solvation' else CUBE))
    what = 'scaffold' if name == 'scaffold' else 'the initial structure'
    builder = getattr(module, f'{name}_envs')
    for canvas, symbols, match in ((n, config['symbols'], 'raise --canvas_size'),
                                   (12, 'X,H,O', 'must be listed')):
        space = ObservationSpace(canvas, symbols_to_zs(symbols))
        with pytest.raises(ValueError, match=f'{what}.*{match}'):
            builder(config, space, None, torch.device('cpu'))
        if name == 'scaffold':
            with pytest.raises(ValueError, match=f'{what}.*{match}') as jerr:
                jax_module.scaffold_envs(
                    config, JaxObservationSpace(canvas, symbols_to_zs(symbols)),
                    None)
            with pytest.raises(ValueError) as err:
                builder(config, space, None, torch.device('cpu'))
            assert str(err.value) == str(jerr.value)


def _step_both(env, jenv, actions):
    """Step a port env and a JAX env from their first reset through
    `actions` (element index, position) on one env each; the rewards and
    dones of each step."""
    states = env.init_states(1)
    jstates = jenv.init_states(jax.random.PRNGKey(0), 1)
    out = []
    for element, pos in actions:
        res = env.step(states, torch.tensor([element]),
                       torch.tensor([pos], dtype=torch.float32))
        jres = jenv.step(jstates, jnp.array([element], jnp.int32),
                         jnp.array([pos], jnp.float32))
        out.append((float(res.reward[0]), bool(res.done[0]),
                    float(jres.reward[0]), bool(jres.done[0])))
        states, jstates = res.state, jres.state
    return out, states


# element indices: solvation X,H,C,O -> H 1, O 3; scaffold X,H,O,Ar -> H 1,
# O 2. A water next to the solute (CO along x at the origin), with a
# refill; a water inside the cube
PLACEMENTS = {
    'solvation': [(3, (0.6, 2.6, 0.0)), (1, (1.5, 2.9, 0.0)),
                  (1, (0.3, 3.5, 0.0)), (3, (-1.6, -1.9, 0.4)),
                  (1, (-2.5, -1.7, 0.2))],
    'scaffold': [(2, (0.1, 0.2, 0.0)), (1, (1.05, 0.2, 0.0)),
                 (1, (-0.15, 1.13, 0.0))],
}


@pytest.mark.parametrize('reward', ['device_lj', 'pm6'])
@pytest.mark.parametrize('name', ['solvation', 'scaffold'])
def test_rewards_of_the_same_placements_match_jax(name, reward):
    """The same placements in the recorded runs' envs give the JAX envs'
    rewards and dones: with the solvation penalty (device LJ, PM6 on the
    host) after a refill, and inside the scaffold."""
    (_train, env), (_jtrain, jenv) = _env_pairs(
        name, reward, solvation=name == 'solvation')
    steps, states = _step_both(env, jenv, PLACEMENTS[name])
    for reward_t, done, jreward, jdone in steps:
        assert reward_t == pytest.approx(jreward, abs=1e-6)
        assert done == jdone
    assert not any(done for _r, done, _j, _jd in steps[:-1])
    if name == 'solvation':
        # the bag was refilled after the first water
        assert int(states.refill_count[0]) == 1
        assert int(states.n_atoms[0]) == 2 + len(PLACEMENTS[name])


def test_scaffold_pm6_never_sees_the_scaffold():
    """The scaffold run's PM6 reward gets the canvas without the cube's 8
    Ar atoms: the calculator never receives Z = 18, and each reward equals
    the PM6 reward of the same water built with no scaffold at all."""
    (_train, env), _jax = _env_pairs('scaffold', 'pm6')
    calc = native.NativeBatchCalculator(native.METHOD_PM6)
    seen = []

    class Spy:
        def batch_reward(self, zs, *args):
            seen.append(np.array(zs))
            return calc.batch_reward(zs, *args)

    env.reward_fn = make_host_reward(Spy())
    bare = MolecularEnv(make_host_reward(calc), env.observation_space,
                        env.formulas.numpy(), device='cpu')
    states, bare_states = env.init_states(1), bare.init_states(1)
    rewards = []
    for element, pos in PLACEMENTS['scaffold']:
        action = (torch.tensor([element]),
                  torch.tensor([pos], dtype=torch.float32))
        res, bare_res = env.step(states, *action), bare.step(bare_states,
                                                             *action)
        assert float(res.reward[0]) == float(bare_res.reward[0])
        rewards.append(float(res.reward[0]))
        states, bare_states = res.state, bare_res.state
    assert rewards[0] == 0.0 and min(rewards[1:]) > 0.0   # O alone, O-H
    assert len(seen) == len(PLACEMENTS['scaffold'])
    assert not any((zs == 18).any() for zs in seen)
    assert int(states.n_atoms[0]) == 8 + len(PLACEMENTS['scaffold'])


# -- tiny runs and the host tools -------------------------------------------

@pytest.mark.parametrize('name', list(DRIVERS))
def test_driver_trains_saves_and_resumes(name, tmp_path, monkeypatch):
    """Two PPO iterations through the driver's main on the CPU, with its
    JSON-lines streams, config snapshot, eval rollouts and checkpoint;
    then one more from the checkpoint; then the host tools on what the
    run wrote: structures.py's molecules, analysis.py's metrics and
    plot.py's PDF."""
    module = DRIVERS[name][0]
    agent, optimizer = module.main(_argv(name, tmp_path, '--num_steps=32'))
    tag = f'{TINY[name][0][7:]}_run-1'
    results = tmp_path / 'results'
    opt = _lines(results / f'{tag}_opt.txt')
    assert [r['total_num_steps'] for r in opt] == [0, 16]
    for rec in opt:
        assert rec['num_opt_steps'] >= 1 and np.isfinite(rec['total_loss'])
    assert len(_lines(results / f'{tag}_train.txt')) == 2
    evals = _lines(results / f'{tag}_eval.txt')
    assert len(evals) == 2 and all(np.isfinite(e['return_mean'])
                                   for e in evals)
    config = json.loads((tmp_path / 'log' / f'{tag}.json').read_text())
    if name == 'qm9':
        assert config['formulas'] == 'CNH,COH2,CFH3,CO2H2'
    state, steps = ModelIO(tmp_path / 'model', tag).load_latest()
    assert steps == 32 and state['optimizer']['count'] == optimizer.count
    for k, v in agent.state_dict().items():
        torch.testing.assert_close(state['model'][k], v, rtol=0, atol=0)

    _resumed, opt2 = module.main(_argv(name, tmp_path, '--num_steps=48',
                                       '--load_latest'))
    opt = _lines(results / f'{tag}_opt.txt')
    assert [r['total_num_steps'] for r in opt] == [0, 16, 32]
    assert opt2.count == optimizer.count + opt[-1]['num_opt_steps']

    # the host tools on the run's output
    with open(tmp_path / 'data' / f'{tag}_steps-16_eval.pkl', 'rb') as f:
        rollout = pickle.load(f)
    built = structures.terminal_structures(rollout, symbols_to_zs(
        config['symbols']))
    out = tmp_path / 'structures.xyz'
    written = structures.main([f'--dir={tmp_path / "data"}', '--mode=eval',
                               f'--symbols={config["symbols"]}',
                               f'--output={out}', f'--name={tag[:-6]}'])
    assert len(written) >= len(built) >= 1
    frames = read_xyz(str(out), index=slice(None))
    assert [a.symbols for a in frames] == [a.symbols for a in written]
    if name == 'solvation':   # every molecule holds the solute
        assert all(a.symbols[:2] == ['C', 'O'] for a in frames)
    if name == 'scaffold':
        assert all(a.symbols[:8] == ['Ar'] * 8 for a in frames)
    frame = analysis.load_metrics(str(results), 'eval')
    assert len(frame) == 3 and set(frame['seed']) == {1}
    curve = analysis.aggregate_over_seeds(frame)
    assert list(curve['total_num_steps']) == [16, 32, 48]
    pdf = tmp_path / 'curve.pdf'
    monkeypatch.setenv('MPLBACKEND', 'Agg')
    plot.main([f'--dir={results}', f'--output={pdf}'])
    assert pdf.read_bytes().startswith(b'%PDF')


def test_structures_raise_without_terminal_canvases(tmp_path):
    (tmp_path / 'x_run-1_steps-4_eval.pkl').write_bytes(pickle.dumps({
        'terminals': np.zeros((2, 1), bool),
        'next_obs': {'elements': np.zeros((2, 1, 3), np.int64),
                     'positions': np.zeros((2, 1, 3, 3), np.float32)}}))
    with pytest.raises(RuntimeError, match='No terminal structures'):
        structures.main([f'--dir={tmp_path}', '--symbols=X,H'])


def test_solvation_penalty_reaches_both_transports(tmp_path):
    """A solvation run with a host reward trains alike through the in-step
    and the pipelined transports and the measured choice between them
    (auto: the same trajectories, so the same metrics), and the penalty
    changes them: it reaches the pipelined transport as it reaches the
    env's reward function."""
    base = [a for a in TINY['solvation'] if not a.startswith('--reward')]

    def run(tag, *flags):
        argv = (base + COMMON + ['--reward=lj', '--num_steps=32',
                                 '--save_rollouts=none'] + list(flags) +
                [f'--{d}_dir={tmp_path / tag / d}'
                 for d in ('log', 'model', 'data', 'results')])
        run_solvation.main(argv)
        return {stream: [{k: v for k, v in rec.items()
                          if k not in ('time', 'iteration_time',
                                       'reward_time', 'transport',
                                       'recomputes')}
                         for rec in _lines(tmp_path / tag / 'results' /
                                           f'solv_run-1_{stream}.txt')]
                for stream in ('train', 'opt', 'eval')}

    auto = run('auto', '--host_reward_mode=auto', '--distance_penalty=0.05')
    in_step = run('in_step', '--host_reward_mode=loop_serial',
                  '--distance_penalty=0.05')
    pipelined = run('pipelined', '--host_reward_mode=loop',
                    '--distance_penalty=0.05')
    assert in_step == pipelined == auto
    unpenalised = run('unpenalised', '--host_reward_mode=loop',
                      '--distance_penalty=0')
    assert unpenalised['train'] != pipelined['train']

    def transports(tag):
        return [r['transport'] for r in _lines(
            tmp_path / tag / 'results' / 'solv_run-1_train.txt')]
    assert set(transports('pipelined')) == {'pipelined'}
    assert set(transports('in_step')) == {'in_step'}
    assert transports('auto')[:2] == ['pipelined', 'in_step']


def test_driver_penalty_matches_jax():
    """make_reward_fn(config, solvation=True) subtracts the same penalty as
    the JAX driver's, for a device and a host reward; without solvation
    there is none."""
    positions = np.zeros((2, 3, 3), np.float32)
    positions[:, 1] = [1.2, 0, 0]
    zs = np.array([[6, 8, 0], [6, 8, 0]])
    new_pos = np.array([[0.6, 2.6, 0], [-1.6, -1.9, 0.4]], np.float32)
    new_z, valid = np.array([8, 1]), np.array([True, True])
    for backend in ('device_lj', 'device_morse', 'lj', 'pm6'):
        config = {'reward': backend, 'distance_penalty': 0.05}
        got = {}
        for solvation in (False, True):
            fn = driver.make_reward_fn(config, solvation=solvation)[0]
            jfn, _calc, jpenalty = jax_driver.make_reward_fn(
                config, solvation=solvation)
            assert driver.distance_penalty(config, solvation) == jpenalty
            got[solvation] = fn(*(torch.from_numpy(a) for a in (
                positions, zs, new_pos, new_z, valid))).numpy()
            want = jfn(jnp.asarray(positions), jnp.asarray(zs, jnp.int32),
                       jnp.asarray(new_pos), jnp.asarray(new_z, jnp.int32),
                       jnp.asarray(valid))
            np.testing.assert_allclose(got[solvation], np.asarray(want),
                                       rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            got[False] - got[True], 0.05 * np.linalg.norm(new_pos, axis=-1),
            rtol=1e-5)

