"""The port's two host-reward transports on the CPU: in step (the env's
reward function calls the host, which is also the JAX package's serial
host loop) and pipelined give the same trajectory, bit for bit, and leave
the generator in the same state, sampling and greedy, on a fixed-bag env, a
stochastic-bag env, an LJ epsilon large enough that the pipelined
transport's low-reward fix-up fires, and a min_reward above 0, where the
fix-up must follow the real dones rather than guess them, and the
solvation run's envs with the distance penalty; and the trained
SF6 PM6 checkpoints, covariant and internal, evaluated greedily with the
PM6 reward in both packages.

The covariant checkpoint's gate: the two packages' means over 8 envs
within 5e-4 of each other and of the run's last recorded eval (0.68257),
where the envs' returns spread over 5e-4 to 7e-4 (measured on the CPU: port
0.68292, JAX 0.68284); the greedy distance is the best of 128 draws, which
the two packages make from different generators. The internal
checkpoint's: see its test."""
import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from molgym_tpu.calculators import native as jnative
from molgym_tpu.calculators.reward_host import \
    make_host_reward as jax_host_reward
from molgym_tpu.envs.environment import MolecularEnv as JaxMolecularEnv
from molgym_tpu.rl.rollout import make_rollout_fn as jax_rollout_fn
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu_torch import run_solvation
from molgym_tpu_torch.agents.covariant import CovariantAC
from molgym_tpu_torch.agents.schnet import make_schnet_agent
from molgym_tpu_torch.calculators.native import (METHOD_LJ, METHOD_PM6,
                                                 NativeBatchCalculator)
from molgym_tpu_torch.calculators.reward_host import (TimedBatchCalculator,
                                                      make_host_reward)
from molgym_tpu_torch.envs.environment import MolecularEnv
from molgym_tpu_torch.formula import string_to_formula
from molgym_tpu_torch.rl.rollout import (make_pipelined_host_rollout_fn,
                                         make_rollout_fn)
from molgym_tpu_torch.spaces import ObservationSpace
from molgym_tpu_torch.tools import driver

from .test_torch_checkpoint import (NUM_ENVS, _first_returns, _restore,
                                    agent_pair)
from .test_torch_driver_checkpoints import recorded_config
from .test_torch_host_reward import \
    jax_library_built_from_csrc  # noqa: F401  (module fixture)

ZS = (0, 1, 8)
FIELDS = ('rewards', 'terminals', 'actions', 'logps', 'values',
          'bootstrap_value')


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread: the suite runs six workers on the
    host's cores, and torch's thread pool then waits at its barriers for
    threads the other workers hold (a transport test took 9 s instead of
    0.5 s under such load, 1.1 s on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(method, epsilon, stochastic, distance=(0.9, 1.5),
           min_reward=-0.6, seeded=False):
    """A host-reward env of H2O (of H2 on a canvas seeded with an O at the
    origin) and a small covariant agent."""
    space = ObservationSpace(canvas_size=4, zs=list(ZS))
    bag = space.bag_from_formula(string_to_formula('H2' if seeded else 'H2O'))
    seed = (dict(initial_elements=np.array([ZS.index(8), 0, 0, 0]),
                 initial_positions=np.zeros((4, 3), np.float32))
            if seeded else {})
    calc = TimedBatchCalculator(NativeBatchCalculator(method, epsilon))
    env = MolecularEnv(make_host_reward(calc), space, bag[None], device='cpu',
                       min_reward=min_reward, **seed,
                       stochastic_size_range=(2, 4) if stochastic else None)
    torch.manual_seed(0)
    agent = CovariantAC(zs=ZS, canvas_size=4, network_width=16, maxl=2,
                        num_cg_levels=2, num_channels_hidden=3,
                        num_channels_per_element=2, bag_scale=3,
                        min_max_distance=distance, beta=-10.0, device='cpu')
    return env, agent, calc


def _run(fn, env, agent, seed=3, num_envs=4):
    gen = torch.Generator().manual_seed(seed)
    states, traj = fn(agent, env.init_states(num_envs, gen), gen)
    return states, traj, gen.get_state()


def _assert_identical(a, b, what):
    (s_a, t_a, g_a), (s_b, t_b, g_b) = a, b
    for field in FIELDS:
        assert torch.equal(getattr(t_a, field), getattr(t_b, field)), (
            what, field)
    for obs in ('obs', 'next_obs'):
        for field in ('elements', 'positions', 'bag'):
            assert torch.equal(getattr(getattr(t_a, obs), field),
                               getattr(getattr(t_b, obs), field)), (
                what, obs, field)
    assert torch.equal(s_a.elements, s_b.elements), what
    assert torch.equal(g_a, g_b), (what, 'generator state')


@pytest.mark.parametrize('deterministic', [False, True],
                         ids=['sampled', 'greedy'])
@pytest.mark.parametrize('case', ['fixed_bag_lj', 'stochastic_pm6',
                                  'fixup_lj', 'min_reward_above_zero_lj'])
def test_transports_give_the_same_trajectory(case, deterministic):
    method, epsilon, stochastic, distance, min_reward, seeded = {
        'fixed_bag_lj': (METHOD_LJ, 0.15, False, (0.9, 1.5), -0.6, False),
        'stochastic_pm6': (METHOD_PM6, 0.0, True, (0.9, 1.5), -0.6, False),
        # close placements at a deep well: rewards below min_reward
        'fixup_lj': (METHOD_LJ, 40.0, True, (0.7, 1.0), -0.6, False),
        # H next to a seeded O: rewards of 0 would end every episode at its
        # first atom, the real rewards (above min_reward) end none
        'min_reward_above_zero_lj': (METHOD_LJ, 0.15, False, (0.9, 1.5),
                                     1e-3, True)}[case]
    env, agent, calc = _setup(method, epsilon, stochastic, distance,
                              min_reward, seeded)
    steps = 6
    pipelined = make_pipelined_host_rollout_fn(env, agent, calc, steps,
                                               deterministic)
    runs = {'in_step': _run(make_rollout_fn(env, agent, steps, deterministic),
                            env, agent),
            'pipelined': _run(pipelined, env, agent)}
    _assert_identical(runs['in_step'], runs['pipelined'], 'pipelined')
    traj = runs['in_step'][1]
    assert torch.isfinite(traj.rewards).all() and traj.terminals.any()
    if stochastic:
        assert len({tuple(b) for b in traj.obs.bag.reshape(-1, 3).tolist()}) > 1
    if case == 'min_reward_above_zero_lj' or (case == 'fixup_lj'
                                              and not deterministic):
        # the fixture exercises the recompute: some env's real done differed
        # from the speculative one before the last step (the greedy policy's
        # one distance misses fixup_lj's placements inside the well)
        assert pipelined.recomputes >= 1
    if case == 'min_reward_above_zero_lj':
        assert (traj.rewards > min_reward).any()
    assert calc.total_calls == 2 * steps


def test_distance_penalty_is_applied_alike():
    env, agent, calc = _setup(METHOD_LJ, 0.15, False)
    env.reward_fn = make_host_reward(calc, distance_penalty=0.05)
    in_step = _run(make_rollout_fn(env, agent, 4), env, agent)
    penalised = _run(make_pipelined_host_rollout_fn(
        env, agent, calc, 4, distance_penalty=0.05), env, agent)
    _assert_identical(in_step, penalised, 'pipelined')
    plain = _run(make_pipelined_host_rollout_fn(env, agent, calc, 4), env,
                 agent)
    assert (penalised[1].rewards <= plain[1].rewards).all()
    assert (penalised[1].rewards < plain[1].rewards).any()


SF6_PM6 = dict(model='sf6_pm6/models/sf6pm6_run-1_steps-15120.model',
               formula='SF6', zs=(0, 16, 9), canvas_size=7, maxl=4,
               num_cg_levels=3, bag_scale=5, min_max_distance=(1.1, 2.1),
               encoder_dtype=None)
RECORDED_EVAL = 0.682570818811655  # results/sf6pm6_run-1_eval.txt, last line
GATE = 5e-4
SF6_INTERNAL_PM6 = dict(
    model='sf6_internal_pm6/models/sf6int_pm6_run-1_steps-15120.model',
    agent='internal', formula='SF6', zs=(0, 16, 9), canvas_size=7,
    min_max_distance=(1.1, 2.1))
# results/sf6int_pm6_run-1_eval.txt, last line
RECORDED_INTERNAL_EVAL = 0.6665726378560066
INTERNAL_GATE = 1e-4


def _pm6_returns(run):
    """Each of NUM_ENVS envs' first greedy episode with the PM6 reward, in
    the JAX package and in the port, from the run's checkpoint."""
    jspace = JaxObservationSpace(run['canvas_size'], list(run['zs']))
    jagent, agent, params_from_jax = agent_pair(run)
    params = _restore(run, jagent, jspace)
    agent.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(params, sep='/').items()}),
        strict=True)
    bag = np.stack([jspace.bag_from_formula(string_to_formula('SF6'))])
    steps = run['canvas_size'] + 1

    jenv = JaxMolecularEnv(
        reward_fn=jax_host_reward(jnative.NativeBatchCalculator(
            jnative.METHOD_PM6)), observation_space=jspace, formulas=bag)
    _s, jtraj = jax_rollout_fn(jenv, jagent, steps, deterministic=True)(
        params, jenv.init_states(jax.random.PRNGKey(1), NUM_ENVS),
        jax.random.PRNGKey(2))
    jret = _first_returns(jtraj.rewards, jtraj.terminals)

    env = MolecularEnv(make_host_reward(NativeBatchCalculator(METHOD_PM6)),
                       ObservationSpace(run['canvas_size'], list(run['zs'])),
                       bag, device='cpu')
    gen = torch.Generator().manual_seed(1)
    _s, traj = make_rollout_fn(env, agent, steps, deterministic=True)(
        agent, env.init_states(NUM_ENVS, gen), gen)
    tret = _first_returns(traj.rewards.numpy(), traj.terminals.numpy())
    assert np.isfinite(tret).all() and np.isfinite(jret).all()
    return tret, jret


def test_trained_pm6_checkpoint_evaluates_alike():
    tret, jret = _pm6_returns(SF6_PM6)
    assert abs(float(tret.mean()) - float(jret.mean())) <= GATE, (tret, jret)
    assert abs(float(tret.mean()) - RECORDED_EVAL) <= GATE, tret


def test_trained_internal_pm6_checkpoint_evaluates_alike():
    """The internal (SchNet) agent's PM6 SF6 run (sf6int_pm6_run-1),
    greedy: its act draws nothing, so the two packages' means are held
    within 1e-4 of each other (measured on the CPU: port 0.6664897, JAX
    0.6664894; the port's envs differ by 1e-7, kappa's mirror-image tie on
    canvases of at most 3 atoms taken either way) and within 5e-4 of the
    run's last recorded eval (0.666573)."""
    tret, jret = _pm6_returns(SF6_INTERNAL_PM6)
    assert abs(float(tret.mean()) - float(jret.mean())) <= INTERNAL_GATE, (
        tret, jret)
    assert abs(float(tret.mean()) - RECORDED_INTERNAL_EVAL) <= GATE, tret


@pytest.mark.parametrize('method', [METHOD_LJ, METHOD_PM6], ids=['lj', 'pm6'])
def test_solvation_transports_give_the_same_trajectory(method):
    """The solvation run's envs (run_solvation.solvation_envs: CO
    pre-placed on a canvas of 12, H2O refilled twice) with a host reward
    less 0.01 |x|: the in-step transport (the env's reward function applies
    the penalty) and the pipelined one (given the penalty by batch_ppo)
    give the same trajectory, bit for bit, with some episode past its
    first bag; without the penalty the pipelined rewards differ."""
    config = recorded_config('solvation', 'solv_run-1')
    config['reward'] = {METHOD_LJ: 'lj', METHOD_PM6: 'pm6'}[method]
    fn, calc = driver.make_reward_fn(config, solvation=True)
    penalty = driver.distance_penalty(config, True)
    assert penalty == 0.01
    space = ObservationSpace(config['canvas_size'], [0, 1, 6, 8])
    env, _eval_env = run_solvation.solvation_envs(config, space, fn,
                                                  torch.device('cpu'))
    torch.manual_seed(0)
    agent = make_schnet_agent(num_zs=4, canvas_size=12, network_width=16,
                              min_max_distance=(0.8, 1.8), n_interactions=2,
                              device='cpu')
    steps = 10
    runs = {'in_step': _run(make_rollout_fn(env, agent, steps), env, agent,
                            num_envs=16),
            'pipelined': _run(make_pipelined_host_rollout_fn(
                env, agent, calc, steps, distance_penalty=penalty), env,
                agent, num_envs=16)}
    _assert_identical(runs['in_step'], runs['pipelined'], 'pipelined')
    traj = runs['in_step'][1]
    placed = (traj.next_obs.elements != 0).sum(-1) - 2   # less the solute
    assert (placed > 3).any(), 'no episode refilled its bag'
    unpenalised = _run(make_pipelined_host_rollout_fn(env, agent, calc, steps),
                       env, agent, num_envs=16)[1]
    assert not torch.equal(unpenalised.rewards, traj.rewards)
