"""The trained checkpoints of the solvation, scaffold, QM9, organics and
halides runs and of the three PM6 families organics_pm6, solvation_pm6
and stochastic_pm6 (its run-1 and run-2) in experiments/, evaluated
greedily in both packages on the CPU through each package's own env
builder (scripts/run_*.py's and the port's run_*.py's), reward (each
driver's make_reward_fn, the solvation penalty included) and model
factory, from the run's recorded configuration
(experiments/*/logs/*_run-N.json, its asset paths made absolute). Each of
8 envs runs as many greedy episodes as the run has formulas, so that every
formula of the cycle is evaluated; the mean over them is held against the
other package's and the run's last recorded eval (results/*_eval.txt).

Gates, measured on the CPU:
  * solvation (internal agent, device LJ less 0.01 |x|, CO pre-placed,
    2 refills) and the scaffold with PM6 (internal agent, the cube's 8 Ar
    pre-placed): the internal agent's greedy act draws nothing, so 1e-4
    between the packages (port 0.846711 / JAX 0.846711; 0.525739 /
    0.525739), and 0.01 to the recorded 0.8467 and 0.5257;
  * QM9 with PM6 (covariant, 24 input channels, 4 formulas): the greedy
    distance is the best of 128 draws, which the packages make from
    different generators, and an env's return varies by up to 0.002 with
    its draws: 0.005 between the packages (port 0.401165, JAX 0.401211) and
    to the recorded 0.40142 (four episodes, one a formula);
  * organics (covariant, device LJ, 2 formulas), whose returns vary by up
    to 0.08 with the draws: 0.02 between the packages (port 1.02346, JAX
    1.02764; the port read 1.02565 on another host, whose rounding moved
    one env's best draw). Its recorded eval (1.2953) played one episode
    (--num_eval_episodes=1) of the formula its eval cursor reached, so it
    is held within 0.02 of the nearer formula's mean (1.2995);
  * halides with PM6 (covariant, X,H,C,Cl,Br, canvas 6, CH3Cl and CH3Br),
    whose envs' means spread over 9e-4 with the draws: 1e-3 between the
    packages (port 0.572922, JAX 0.572742) and to the recorded 0.573206
    (one episode a formula).

The three PM6 families. Their recorded evals came from the PM6 constants
of their day: organics_pm6 ran on today's (round-5) calibration, while
solvation_pm6 and stochastic_pm6 ran on the round-3 constants
(experiments/*/README.md), which the C++ of csrc/ no longer builds. Both
packages read today's surface through the same library, so the gates
between the packages are measured on it, and each run's distance to its
record is measured and bounds it:
  * solvation_pm6 (internal agent, PM6, CO pre-placed, 2 refills): no
    draw, 1e-4 between the packages (port 0.824794, JAX 0.824796); 0.15
    to the recorded 0.967983 (0.1432 off: the round-3 surface);
  * organics_pm6 (covariant, CH3NO and C2H2O2): C2H2O2's greedy episode
    ends in one of two modes (0.474 or -0.063) as the best draw falls, so
    one of the 16 episodes changing mode moves the mean by 0.0336: 0.07
    between the packages, two such changes (port 0.564289, JAX 0.530475:
    3 and 4 envs at -0.063); each port episode within 0.03 of a JAX
    episode of its formula (the good mode's episodes spread over
    0.472-0.489 with the draws: 0.4721-0.4749 here, one at 0.4890 on the
    card), and CH3NO's means, of one mode, within 0.005 (0.85557,
    0.85564). The recorded eval played one episode of each formula: some
    two of the port's episodes give it within 0.005 (0.0016 off);
  * stochastic_pm6 run-1 (covariant, maxl 4, 3 CG levels): its envs
    spread over 0.022 with the draws (an env's sd 0.008): 0.015 between the
    packages (port 0.656253, JAX 0.658895); 0.08 to the recorded 0.731613
    (0.0754 off: round 3);
  * stochastic_pm6 run-2: every greedy episode, in both packages, ends at
    its third action, which puts an O within 0.1 A of the second C (port
    0.075-0.078 A; the reference's probe: 0.077 A) and is refused: the
    lengths are all 3, as recorded. 0.005 between the packages (port
    -0.256961, JAX -0.258107; the envs spread over 0.003); 0.06 to the
    recorded -0.207769 (0.0492 off: round 3; the reference read -0.26 on
    the recalibrated surface).
The file reads experiments/ and writes nothing there."""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import scripts.run_scaffold as jax_run_scaffold
import scripts.run_solvation as jax_run_solvation
import scripts.run_stochastic as jax_run_stochastic
from molgym_tpu.rl.rollout import make_rollout_fn as jax_rollout_fn
from molgym_tpu.spaces import ActionSpace as JaxActionSpace
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu.tools import driver as jax_driver
from molgym_tpu.tools.model_util import build_model as jax_build_model
from molgym_tpu_torch import run_scaffold, run_solvation, run_stochastic
from molgym_tpu_torch.convert import (covariant_params_from_jax,
                                      internal_params_from_jax)
from molgym_tpu_torch.rl.rollout import make_rollout_fn
from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
from molgym_tpu_torch.tools import diagnose_greedy, driver
from molgym_tpu_torch.tools.model_util import build_model

from .test_torch_checkpoint import _restore
from .test_torch_host_reward import \
    jax_library_built_from_csrc  # noqa: F401  (module fixture)

EXPERIMENTS = Path(__file__).resolve().parents[1] / 'experiments'
NUM_ENVS = 8

RUNS = {
    'solvation': dict(experiment='solvation', tag='solv_run-1', steps=7000,
                      builders=(jax_run_solvation.solvation_envs,
                                run_solvation.solvation_envs),
                      solvation=True, tol=1e-4, recorded=0.8467234782874584,
                      recorded_tol=0.01),
    'scaffold_pm6': dict(experiment='scaffold_pm6', tag='scafpm6_run-1',
                         steps=12288,
                         builders=(jax_run_scaffold.scaffold_envs,
                                   run_scaffold.scaffold_envs),
                         tol=1e-4, recorded=0.5257213413715363,
                         recorded_tol=0.01),
    'qm9_pm6': dict(experiment='qm9_pm6', tag='qm9pm6_run-1', steps=8400,
                    tol=0.005, recorded=0.40141947381198406,
                    recorded_tol=0.005),
    'organics': dict(experiment='organics', tag='organics_run-1', steps=14000,
                     tol=0.02, recorded=1.2953290194272995,
                     recorded_tol=0.02),
    'halides_pm6': dict(experiment='halides_pm6', tag='halo_run-1',
                        steps=14000, tol=1e-3, recorded=0.5732058584690094,
                        recorded_tol=1e-3),
    'organics_pm6': dict(experiment='organics_pm6', tag='orgpm6_run-1',
                         steps=14000, tol=0.07, modes_tol=0.03,
                         recorded=0.663188518024981, recorded_pairs=True,
                         recorded_tol=0.005),
    'solvation_pm6': dict(experiment='solvation_pm6', tag='solvpm6_run-1',
                          steps=21000,
                          builders=(jax_run_solvation.solvation_envs,
                                    run_solvation.solvation_envs),
                          solvation=True, tol=1e-4,
                          recorded=0.967983135022223, recorded_tol=0.15),
    'stochastic_pm6-run-1': dict(
        experiment='stochastic_pm6', tag='stochpm6_run-1', steps=7000,
        builders=(jax_run_stochastic.stochastic_envs,
                  run_stochastic.stochastic_envs),
        tol=0.015, recorded=0.7316128443926573, recorded_tol=0.08),
    'stochastic_pm6-run-2': dict(
        experiment='stochastic_pm6', tag='stochpm6_run-2', steps=7000,
        builders=(jax_run_stochastic.stochastic_envs,
                  run_stochastic.stochastic_envs),
        tol=0.005, recorded=-0.20776903629302979, recorded_tol=0.06,
        greedy_length=3),
}
ASSETS = ('initial_structure', 'scaffold')


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's
    cores, and torch's thread pool then waits at its barriers for threads
    the other workers hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def recorded_config(experiment: str, tag: str) -> dict:
    """The run's recorded configuration, its asset paths absolute."""
    directory = EXPERIMENTS / experiment
    config = json.loads((directory / 'logs' / f'{tag}.json').read_text())
    for key in ASSETS:
        if config.get(key):
            # a path the run recorded absolute names a file of `directory`
            path = directory / config[key]
            config[key] = str(path if path.exists()
                              else directory / Path(config[key]).name)
    return config


def episode_returns(rewards, terminals, k):
    """[B, k] returns of each env's first k episodes."""
    rewards, terminals = np.asarray(rewards), np.asarray(terminals)
    episode = np.cumsum(terminals, axis=0) - terminals   # episode of a step
    assert (terminals.sum(axis=0) >= k).all()
    return np.stack([(rewards * (episode == i)).sum(axis=0)
                     for i in range(k)], axis=1)


def evaluate_both(name):
    """(port, JAX) [NUM_ENVS, F] greedy returns of run `name`, the port's
    env and trajectory, the run's configuration, the JAX trajectory and
    the port's agent."""
    run = RUNS[name]
    jax_envs, port_envs = run.get(
        'builders', (jax_driver.standard_envs, driver.standard_envs))
    solvation = run.get('solvation', False)
    config = recorded_config(run['experiment'], run['tag'])
    formulas = config['formulas'].split(',')
    zs = symbols_to_zs(config['symbols'])
    num_steps = len(formulas) * (config['canvas_size'] + 1)

    jspace = JaxObservationSpace(config['canvas_size'], zs)
    jagent = jax_build_model(config, jspace, JaxActionSpace(zs))
    params = _restore(dict(model=f'{run["experiment"]}/models/{run["tag"]}'
                           f'_steps-{run["steps"]}.model',
                           formula=formulas[0]), jagent, jspace)
    jfn = jax_driver.make_reward_fn(config, solvation=solvation)[0]
    _train, jenv = jax_envs(config, jspace, jfn)
    _s, jtraj = jax_rollout_fn(jenv, jagent, num_steps, deterministic=True)(
        params, jenv.init_states(jax.random.PRNGKey(1), NUM_ENVS),
        jax.random.PRNGKey(2))
    jret = episode_returns(jtraj.rewards, jtraj.terminals, len(formulas))

    space = ObservationSpace(config['canvas_size'], zs)
    agent = build_model(config, space, device='cpu')
    params_from_jax = (covariant_params_from_jax
                       if config['model'] == 'covariant'
                       else internal_params_from_jax)
    agent.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(params, sep='/').items()}),
        strict=True)
    fn = driver.make_reward_fn(config, solvation=solvation)[0]
    _train, env = port_envs(config, space, fn, torch.device('cpu'))
    gen = torch.Generator().manual_seed(1)
    _s, traj = make_rollout_fn(env, agent, num_steps, deterministic=True)(
        agent, env.init_states(NUM_ENVS, gen), gen)
    tret = episode_returns(traj.rewards.numpy(), traj.terminals.numpy(),
                           len(formulas))
    assert np.isfinite(tret).all() and np.isfinite(jret).all()
    return tret, jret, env, traj, config, jtraj, agent


def first_episodes(elements, positions, actions, terminals):
    """(each env's first episode length, the distance from the position
    its last action chose to the nearest atom on the canvas) of a covariant
    agent's trajectory: the action is (focus, element, distance,
    orientation), the position the focus atom's plus distance times
    orientation."""
    elements, positions, actions, terminals = (np.asarray(x) for x in (
        elements, positions, actions, terminals))
    lengths, contacts = [], []
    for b in range(terminals.shape[1]):
        t = int(terminals[:, b].argmax())   # the first episode's last step
        assert terminals[t, b]
        focus, distance = int(actions[t, b, 0]), float(actions[t, b, 2])
        position = positions[t, b, focus] + distance * actions[t, b, 3:6]
        lengths.append(t + 1)
        contacts.append(diagnose_greedy.contacts(
            elements[t, b], positions[t, b], position)[0])
    return lengths, contacts


@pytest.mark.parametrize('name', list(RUNS))
def test_trained_driver_checkpoint_evaluates_alike(name):
    run = RUNS[name]
    tret, jret, env, traj, config, jtraj, _agent = evaluate_both(name)
    assert abs(float(tret.mean()) - float(jret.mean())) <= run['tol'], (
        tret, jret)
    if run.get('recorded_pairs'):
        # the recorded eval played one episode of each of the two formulas:
        # some two of the port's episodes give its mean
        recorded_err = np.abs(
            (tret[:, None, 0] + tret[None, :, 1]) / 2 - run['recorded']).min()
    elif config.get('num_eval_episodes') == 1:
        # the recorded eval played one formula's episode
        recorded_err = np.abs(tret.mean(axis=0) - run['recorded']).min()
    else:
        recorded_err = abs(float(tret.mean()) - run['recorded'])
    assert recorded_err <= run['recorded_tol'], tret
    if 'modes_tol' in run:
        # each port episode ends where some JAX episode of its formula
        # ends; the first formula's episodes have one mode
        assert (np.abs(tret[:, None, :] - jret[None, :, :]).min(axis=1)
                <= run['modes_tol']).all(), (tret, jret)
        assert np.abs(tret[:, 0].mean() - jret[:, 0].mean()) <= 0.005
    if 'greedy_length' in run:
        # every greedy episode ends at the same action in both packages,
        # one that places its atom within 0.1 A of another
        for obs, actions, terminals in (
                (traj.obs, traj.actions, traj.terminals),
                (jtraj.obs, jtraj.actions, jtraj.terminals)):
            lengths, contacts = first_episodes(
                obs.elements, obs.positions, actions, terminals)
            assert lengths == [run['greedy_length']] * NUM_ENVS, lengths
            assert max(contacts) < 0.1, contacts
    placed = traj.next_obs.elements != 0
    if env.n_scaffold:
        # the scaffold stays, and every atom an episode placed lies inside
        # its hull
        assert torch.equal(traj.next_obs.elements[..., :env.n_scaffold],
                           env.initial_elements[:env.n_scaffold].expand(
                               traj.next_obs.elements.shape[:2] + (-1, )))
        new = traj.next_obs.positions[..., env.n_scaffold:, :][
            placed[..., env.n_scaffold:]]
        assert len(new) and ((new @ env.hull_a.T + env.hull_b)
                             <= 1e-5).all()
    if env.num_refills:
        # some episode placed more atoms than its first bag holds
        first_bag = int(env.formulas[0].sum())
        assert (placed.sum(-1) - env.initial_n_atoms > first_bag).any()
