"""The trained checkpoints in experiments/, restored by molgym_tpu's ModelIO
(a legacy layout migrated by migrate_legacy_covariant), carried over by
convert.py, and evaluated greedily in both packages on their run's
evaluation formula with the device LJ reward: the mean over 8 envs of each
env's first greedy episode. The covariant agent's distance mode is the best
of 128 draws, so an env's return varies with its draws (by 0.01 at the
stochastic run, by up to 0.1 at SF6) and the two packages draw
differently.

Tolerance on the two packages' means, measured on the CPU: 0.02 for the
float32 stochastic-bag run (port 1.2443, JAX 1.2409; the run's last
recorded eval 1.246); 0.05 for the bf16 SF6 run (port 1.5432, JAX 1.5519;
recorded 1.544), where the envs' returns spread wider (1.51-1.61) and the
two packages also round to bf16 at other places; 1e-4 for the internal
(SchNet) SF6 run, whose greedy act draws nothing (the continuous
sub-actions are the means, kappa the argmax): port 0.973328, JAX
0.973331. Its envs differ by 5e-7 in the port: on a canvas of at most 3
atoms kappa's two candidates are mirror images whose logits tie up to
rounding, and either sign places an episode of the same energies. The
run's last recorded eval, 0.967779 at 14,000 steps
(results/sf6int_run-1_eval.txt), came from the TPU, whose matmuls round
otherwise: the port is held within 0.01 of it. The file reads
experiments/ and writes nothing there."""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from molgym_tpu.agents.covariant import CovariantAC as JaxCovariantAC
from molgym_tpu.agents.schnet import make_schnet_agent as jax_schnet_agent
from molgym_tpu.envs.environment import MolecularEnv as JaxMolecularEnv
from molgym_tpu.envs.reward import make_lennard_jones_reward as jax_lj
from molgym_tpu.rl.rollout import make_rollout_fn as jax_rollout_fn
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu.tools.model_io import (ModelIO, is_legacy_covariant_tree,
                                       migrate_legacy_covariant)
from molgym_tpu_torch.agents.covariant import CovariantAC
from molgym_tpu_torch.agents.schnet import make_schnet_agent
from molgym_tpu_torch.convert import (covariant_params_from_jax,
                                      internal_params_from_jax)
from molgym_tpu_torch.envs.environment import MolecularEnv
from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
from molgym_tpu_torch.formula import string_to_formula
from molgym_tpu_torch.rl.rollout import make_rollout_fn
from molgym_tpu_torch.spaces import ObservationSpace

EXPERIMENTS = Path(__file__).resolve().parents[1] / 'experiments'
NUM_ENVS = 8

# the recorded runs' configurations (experiments/*/logs/*_run-1.json)
RUNS = {
    'stochastic': dict(
        model='stochastic/models/stoch_run-1_steps-7000.model',
        formula='C2H6O', zs=(0, 1, 6, 8), canvas_size=10, maxl=3,
        num_cg_levels=2, bag_scale=6, min_max_distance=(0.9, 1.8),
        encoder_dtype=None, tol=0.02),
    'sf6_bf16': dict(
        model='sf6_bf16/models/sf6bf16_run-1_steps-15120.model',
        formula='SF6', zs=(0, 16, 9), canvas_size=7, maxl=4, num_cg_levels=3,
        bag_scale=5, min_max_distance=(1.1, 2.1), encoder_dtype='bfloat16',
        tol=0.05),
    'sf6_internal': dict(
        model='sf6_internal/models/sf6int_run-1_steps-14000.model',
        agent='internal', formula='SF6', zs=(0, 16, 9), canvas_size=7,
        min_max_distance=(1.1, 2.1), tol=1e-4, recorded=0.967779278755188),
}


def _agent_kwargs(run):
    return dict(zs=run['zs'], canvas_size=run['canvas_size'],
                network_width=128, maxl=run['maxl'],
                num_cg_levels=run['num_cg_levels'], num_channels_hidden=10,
                num_channels_per_element=4, num_gaussians=3,
                bag_scale=run['bag_scale'],
                min_max_distance=run['min_max_distance'], beta=-10.0,
                encoder_dtype=run['encoder_dtype'])


def agent_pair(run):
    """(the JAX agent, the port's on the CPU, the map of its param tree)
    of a recorded run: the covariant agent at width 128, or the internal
    (SchNet) agent at width 128 with 3 interactions."""
    if run.get('agent') == 'internal':
        kwargs = dict(num_zs=len(run['zs']), canvas_size=run['canvas_size'],
                      network_width=128,
                      min_max_distance=run['min_max_distance'],
                      n_interactions=3)
        return (jax_schnet_agent(**kwargs),
                make_schnet_agent(**kwargs, device='cpu'),
                internal_params_from_jax)
    kwargs = _agent_kwargs(run)
    return (JaxCovariantAC(**kwargs), CovariantAC(**kwargs, device='cpu'),
            covariant_params_from_jax)


def _first_returns(rewards, terminals):
    """Each env's return up to and including its first terminal."""
    rewards, terminals = np.asarray(rewards), np.asarray(terminals)
    first = terminals.argmax(axis=0)
    assert terminals.any(axis=0).all()
    steps = np.arange(rewards.shape[0])[:, None]
    return (rewards * (steps <= first)).sum(axis=0)


def _restore(run, jagent, space):
    """The checkpoint's variables ({'params': ...}) in the current layout,
    as numpy arrays."""
    path = EXPERIMENTS / run['model']
    raw = ModelIO(str(path.parent), 'unused')._restore_raw(str(path))
    variables = raw['params']
    if is_legacy_covariant_tree(variables):
        # the current layout's shapes and dtypes, traced, not computed
        obs = jax.tree.map(lambda x: x[None], space.build(
            (), string_to_formula(run['formula'])))
        template = jax.eval_shape(
            lambda o, k: jagent.init(k, o, k, method=jagent.act), obs,
            jax.random.PRNGKey(0))
        variables = migrate_legacy_covariant(variables, template)
    return variables


def _jax_eval(run, jagent, params, space):
    bag = space.bag_from_formula(string_to_formula(run['formula']))
    env = JaxMolecularEnv(reward_fn=jax_lj(), observation_space=space,
                          formulas=np.stack([bag]))
    rollout = jax_rollout_fn(env, jagent, run['canvas_size'] + 1,
                             deterministic=True)
    states = env.init_states(jax.random.PRNGKey(1), NUM_ENVS)
    _states, traj = rollout(params, states, jax.random.PRNGKey(2))
    return _first_returns(traj.rewards, traj.terminals)


def _torch_eval(run, agent):
    space = ObservationSpace(run['canvas_size'], list(run['zs']))
    bag = space.bag_from_formula(string_to_formula(run['formula']))
    env = MolecularEnv(make_lennard_jones_reward(), space, np.stack([bag]),
                       device='cpu')
    rollout = make_rollout_fn(env, agent, run['canvas_size'] + 1,
                              deterministic=True)
    gen = torch.Generator().manual_seed(1)
    _states, traj = rollout(agent, env.init_states(NUM_ENVS, gen), gen)
    return _first_returns(traj.rewards.numpy(), traj.terminals.numpy())


@pytest.mark.parametrize('name', list(RUNS))
def test_trained_checkpoint_evaluates_alike(name):
    run = RUNS[name]
    jspace = JaxObservationSpace(run['canvas_size'], list(run['zs']))
    jagent, agent, params_from_jax = agent_pair(run)
    params = _restore(run, jagent, jspace)
    flat = {k: np.asarray(v)
            for k, v in flatten_dict(params, sep='/').items()}
    missing, unexpected = agent.load_state_dict(params_from_jax(flat),
                                                strict=True)
    assert not missing and not unexpected

    jret = _jax_eval(run, jagent, params, jspace)
    tret = _torch_eval(run, agent)
    assert np.isfinite(tret).all() and np.isfinite(jret).all()
    assert abs(float(tret.mean()) - float(jret.mean())) <= run['tol'], (
        tret, jret)
    if 'recorded' in run:
        assert abs(float(tret.mean()) - run['recorded']) <= 0.01, tret


def test_internal_checkpoint_optimizer_state_carries_over():
    """The internal checkpoint's optax state, restored without a template
    (nested lists and dicts), carries over by the internal map into the
    port's optimizer: its count, and each moment transposed as its
    parameter is."""
    from molgym_tpu_torch.convert import flatten_tree, optimizer_state_from_jax
    from molgym_tpu_torch.rl.ppo import PPOConfig, make_optimizer
    run = RUNS['sf6_internal']
    path = EXPERIMENTS / run['model']
    raw = ModelIO(str(path.parent), 'unused')._restore_raw(str(path))
    _jagent, agent, params_from_jax = agent_pair(run)
    agent.load_state_dict(params_from_jax(flatten_tree(raw['params'])),
                          strict=True)
    optimizer = make_optimizer(PPOConfig(), agent)
    state = optimizer_state_from_jax(raw['opt_state'], params_from_jax)
    assert set(state) == {'count', 'mu', 'nu'}
    optimizer.load_state_dict(state)
    assert optimizer.count == 373
    adam = raw['opt_state'][1][0]
    kernel = np.asarray(adam['mu']['params']['encoder'][
        'SchNetInteraction_2']['Dense_2']['kernel'])
    np.testing.assert_array_equal(
        optimizer.mu['encoder.interactions.2.in2f.weight'].numpy(), kernel.T)
    embedding = np.asarray(adam['nu']['params']['encoder']['Embed_0'][
        'embedding'])
    np.testing.assert_array_equal(
        optimizer.nu['encoder.embedding.weight'].numpy(), embedding)
