"""Successive PPO updates at the stochastic-bag configuration
(experiments/stochastic/logs/stoch_run-1.json's structure: canvas 10,
X,H,C,O, bags of 4-8 atoms (--size_range=4,9) sampled from C2H6O's element
distribution, so that the bag masks and atom counts vary within a batch,
maxl 3, 2 CG levels, beta -10; its PPO: clip 0.2, target_kl 0.01, up to 7
epochs, one minibatch of every sample, lr 3e-4, entropy 0.01, vf 0.5,
gradient clip 0.5, gamma 1, lam 0.97), narrow (width 32, 4 hidden
channels), held against the JAX package over K = 3 iterations.

Each iteration the JAX package rolls 10 envs x 6 steps out from its own
parameters with the device LJ reward; both packages then train from their
own current parameters and optimizer state on that trajectory, carried
over with numpy. With the minibatch equal to the sample count, an epoch's
gradient does not depend on the permutation, so the two random streams
give the same update (up to float32 order). After each iteration:
  * the losses of the last epoch that stepped, approx_kl, clip_fraction
    and grad_norm within 1e-4 relative (1e-6 absolute);
  * num_opt_steps exactly equal: the KL stop fires at the same epoch (it
    fires in at least one iteration);
  * the parameters by tests/test_torch_ppo.py's counting rule
    (assert_params_close): 1e-5, except at most 1% of the elements whose
    Adam update flips sign at the float32 noise floor, by at most 2 lr per
    step taken so far.
This is the guard ROADMAP Queue 3 asked for: the stochastic run's update
held against the JAX one over successive iterations."""
import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from molgym_tpu.agents.covariant import CovariantAC as JaxCovariantAC
from molgym_tpu.envs.environment import MolecularEnv as JaxMolecularEnv
from molgym_tpu.envs.reward import make_lennard_jones_reward as jax_lj
from molgym_tpu.rl import buffer as jbuffer
from molgym_tpu.rl import ppo as jppo
from molgym_tpu.rl.rollout import make_rollout_fn as jax_rollout_fn
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu_torch.agents.covariant import CovariantAC
from molgym_tpu_torch.convert import covariant_params_from_jax
from molgym_tpu_torch.rl import buffer, ppo
from molgym_tpu_torch.spaces import Observation

from .test_torch_ppo import assert_params_close

ZS = (0, 1, 6, 8)                     # X, H, C, O
BASE = np.array([[0, 6, 2, 1]])       # C2H6O
AGENT = dict(zs=ZS, canvas_size=10, network_width=32, maxl=3,
             num_cg_levels=2, num_channels_hidden=4,
             num_channels_per_element=4, num_gaussians=3, bag_scale=6,
             min_max_distance=(0.9, 1.8), beta=-10.0)
NUM_ENVS, STEPS = 10, 6
SAMPLES = NUM_ENVS * STEPS
ITERATIONS = 3
CONFIG = dict(gamma=1.0, lam=0.97, clip_ratio=0.2, vf_coef=0.5,
              entropy_coef=0.01, target_kl=0.01, gradient_clip=0.5,
              learning_rate=3e-4, max_num_train_iters=7,
              mini_batch_size=SAMPLES)
TRAJECTORY_FIELDS = ('actions', 'rewards', 'terminals', 'values', 'logps',
                     'bootstrap_value')


def _torch_trajectory(jtraj) -> buffer.Trajectory:
    def obs(o):
        return Observation(elements=torch.from_numpy(
                               np.asarray(o.elements).astype(np.int64)),
                           positions=torch.from_numpy(np.array(o.positions)),
                           bag=torch.from_numpy(
                               np.asarray(o.bag).astype(np.int64)))
    return buffer.Trajectory(
        obs=obs(jtraj.obs), next_obs=obs(jtraj.next_obs),
        **{k: torch.from_numpy(np.array(getattr(jtraj, k)))
           for k in TRAJECTORY_FIELDS})


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_successive_updates_match_the_jax_package():
    space = JaxObservationSpace(AGENT['canvas_size'], list(ZS))
    env = JaxMolecularEnv(reward_fn=jax_lj(), observation_space=space,
                          formulas=BASE, stochastic_size_range=(4, 9))
    jagent = JaxCovariantAC(**AGENT)
    key = jax.random.PRNGKey(7)
    states = env.init_states(key, NUM_ENVS)
    params = jax.jit(lambda o, k: jagent.init(k, o, k, method=jagent.act))(
        states.observation(), key)
    agent = CovariantAC(**AGENT, device='cpu')
    agent.load_state_dict(covariant_params_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(params, sep='/').items()}),
        strict=True)

    jconfig = jppo.PPOConfig(**CONFIG)
    joptimizer = jppo.make_optimizer(jconfig)
    jopt_state = joptimizer.init(params)
    jtrain = jppo.make_train_fn(jagent, joptimizer, jconfig, SAMPLES)
    rollout = jax_rollout_fn(env, jagent, STEPS)
    config = ppo.PPOConfig(**CONFIG)
    optimizer = ppo.make_optimizer(config, agent)
    train = ppo.make_train_fn(agent, optimizer, config, SAMPLES)

    steps_taken, stops = 0, 0
    for iteration in range(ITERATIONS):
        key, rollout_key, train_key = jax.random.split(key, 3)
        states, jtraj = rollout(params, states, rollout_key)
        sizes = (np.asarray(jtraj.obs.bag).sum(-1)
                 + (np.asarray(jtraj.obs.elements) != 0).sum(-1))
        assert len(np.unique(sizes)) > 1   # the masks vary in the batch

        jdata = jbuffer.compute_ppo_data(jtraj, jconfig.gamma, jconfig.lam)
        params, jopt_state, jinfo = jtrain(params, jopt_state, jdata,
                                           train_key)
        data = buffer.compute_ppo_data(_torch_trajectory(jtraj),
                                       config.gamma, config.lam)
        info = train(data, torch.Generator().manual_seed(iteration))

        assert info['num_opt_steps'] == int(jinfo['num_opt_steps']), (
            iteration, info, jinfo)
        steps_taken += info['num_opt_steps']
        stops += info['num_opt_steps'] < config.max_num_train_iters
        for k in ppo.INFO_KEYS + ('grad_norm', ):
            np.testing.assert_allclose(info[k], float(jinfo[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=(iteration, k))
        assert_params_close(agent, params, config.learning_rate, steps_taken)
        assert optimizer.count == int(jopt_state[1][0].count) == steps_taken
    assert stops >= 1, 'the KL stop never fired'
