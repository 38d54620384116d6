"""The solvation and scaffold training paths of the port held against the JAX
package step by step, at the recorded runs' full configurations: the
machinery of tests/test_torch_solvation_training.py and
tests/test_torch_scaffold_training.py (two files, so that `--dist
loadfile` puts them on two workers).

Each family is built from its record by both packages' env builders and
`make_reward_fn` (`solvation` from experiments/solvation/logs/
solv_run-1.json: SchNet width 64, 3 interactions, canvas 12, X,H,C,O,
the CO solute, 2 refills, the device LJ less 0.01 |x|, min_reward -0.6,
10 envs x 14 steps, minibatch 140, up to 7 epochs; `scaffold` from
`recorded_run.UNLOGGED['scaffold']`: width 128, canvas 12, X,H,O,Ar, the
cube, 8 envs x 32 steps, minibatch 128 of 256), with one Flax init
carried into the port by `convert.internal_params_from_jax`.

`Family.iterations` runs ITERATIONS PPO iterations: each, the port rolls
out on the CPU from a seeded generator with a recorder on its env (the
element and position each step was given, the placements' validity, the
state after each step and each auto-reset), then both packages run
`compute_ppo_data` and `train` on that trajectory, each from its own
current parameters and optimizer state. `replay` steps the JAX env through
a recorded rollout from the same start and scores the port's actions with
the JAX agent at the port's parameters of that iteration.

`Family.draws` samples many actions at a few observations of the first
rollout in both packages, in chunks of at most CHUNK rows, and
`Family.heads` computes the JAX distributions (each head given the
sub-actions before it) at any actions."""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import scripts.run_scaffold as jax_run_scaffold
import scripts.run_solvation as jax_run_solvation
from molgym_tpu.distributions.discrete import (categorical_log_prob,
                                               masked_categorical_probs,
                                               normal_log_prob)
from molgym_tpu.ops.masked import to_one_hot
from molgym_tpu.rl import buffer as jbuffer
from molgym_tpu.rl import ppo as jppo
from molgym_tpu.spaces import Observation as JaxObservation
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu.tools import driver as jax_driver
from molgym_tpu.tools.model_util import build_model as jax_build_model
from molgym_tpu_torch.agents.internal import HeadDistributions
from molgym_tpu_torch.convert import internal_params_from_jax
from molgym_tpu_torch.rl import buffer, ppo
from molgym_tpu_torch.rl.rollout import make_rollout_fn
from molgym_tpu_torch.spaces import (Observation, ObservationSpace,
                                     symbols_to_zs)
from molgym_tpu_torch.tools import head_draws
from molgym_tpu_torch.tools.driver import ppo_config_from
from molgym_tpu_torch.tools.head_draws import (CHUNK, FAMILIES, StepRecorder,
                                               chunks)
from molgym_tpu_torch.tools.model_util import build_model
from molgym_tpu_torch.tools.sampling_checks import (P_MIN, check_draws,
                                                     compare_draws, failures)

ITERATIONS = 3
TOL = 1e-4
JAX_DRIVERS = {'solvation': jax_run_solvation, 'scaffold': jax_run_scaffold}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def jax_obs(obs: Observation) -> JaxObservation:
    return JaxObservation(jnp.asarray(_np(obs.elements).astype(np.int32)),
                          jnp.asarray(_np(obs.positions)),
                          jnp.asarray(_np(obs.bag).astype(np.int32)))


STATE_FIELDS = ('elements', 'bag', 'n_atoms', 'formula_cursor',
                'refill_count')


def assert_states_equal(states, jstates, where) -> None:
    """Every discrete field exactly, the positions within 1e-5."""
    for name in STATE_FIELDS:
        np.testing.assert_array_equal(_np(getattr(states, name)),
                                      np.asarray(getattr(jstates, name)),
                                      err_msg=f'{where}: {name}')
    np.testing.assert_allclose(_np(states.positions),
                               np.asarray(jstates.positions), rtol=0,
                               atol=1e-5, err_msg=f'{where}: positions')


@dataclasses.dataclass
class Iteration:
    start: object                 # the port's EnvState before the rollout
    params: dict                  # the port's parameters it rolled out with
    traj: buffer.Trajectory
    steps: List[dict]             # StepRecorder's
    end: object                   # the port's EnvState after it
    info: dict                    # the port's train info
    jinfo: dict                   # the JAX package's
    data: Dict[str, np.ndarray]   # the port's compute_ppo_data
    jdata: Dict[str, np.ndarray]  # the JAX package's
    after: dict                   # the port's parameters after the update
    jparams: dict                 # the JAX parameters after it
    opt_count: int
    jopt_count: int


class Family:
    """One family's two environments, agents and jitted JAX functions, from
    one Flax init (JAX PRNG key 0 over the envs' first observation)."""

    def __init__(self, name: str):
        self.name = name
        self.config = config = head_draws.recorded_config(name)[1]
        zs = symbols_to_zs(config['symbols'])
        self.space = ObservationSpace(config['canvas_size'], zs)
        jspace = JaxObservationSpace(config['canvas_size'], zs)
        self.env = head_draws.family_env(name, config, 'cpu')
        self.jenv = getattr(JAX_DRIVERS[name], f'{name}_envs')(
            config, jspace, jax_driver.make_reward_fn(
                config, FAMILIES[name]['solvation'])[0])[0]
        self.num_envs = config['num_envs']
        self.num_steps = config['num_steps_per_iter'] // self.num_envs
        self.jagent = jagent = jax_build_model(config, jspace, None)
        key = jax.random.PRNGKey(0)
        self.init_params = jax.jit(
            lambda o, k: jagent.init(k, o, k, method=jagent.act))(
                self.jenv.init_states(key, self.num_envs).observation(), key)
        self.agent = build_model(config, self.space, device='cpu')
        self.load(self.agent, self.init_params)
        self.ppo_config = ppo_config_from(config)
        self.jppo_config = jppo.PPOConfig(**self.ppo_config._asdict())

        self.jstep = jax.jit(self.jenv.step)
        self.jvalid = jax.jit(lambda s, e, p: self.jenv.reward_inputs(
            s, e, p)[1])
        self.jreset = jax.jit(jax.vmap(self.jenv.reset))
        self.jreset_if_terminal = jax.jit(self.jenv.reset_if_terminal)
        self.jscore = jax.jit(lambda prm, o, a: jagent.apply(
            prm, o, a, None, False, method=jagent._step))
        self.jact = jax.jit(lambda prm, o, k: jagent.apply(
            prm, o, k, False, method=jagent.act))
        self.jevaluate = jax.jit(lambda prm, o, a: jagent.apply(
            prm, o, a, method=jagent.evaluate)[0])
        self.jheads = jax.jit(lambda prm, o, a: jagent.apply(
            prm, o, a, method=_jax_heads))

    @staticmethod
    def load(agent, jparams) -> None:
        agent.load_state_dict(internal_params_from_jax(
            {k: np.asarray(v)
             for k, v in flatten_dict(jparams, sep='/').items()}),
            strict=True)

    def jax_params_of(self, state: dict) -> dict:
        """The port's state_dict as a Flax param tree (the inverse of
        internal_params_from_jax)."""
        flat = {}
        for key, value in flatten_dict(self.init_params, sep='/').items():
            name, = internal_params_from_jax({key: np.asarray(value)})
            array = state[name].detach().cpu().numpy()
            flat[key] = jnp.asarray(array.T if key.endswith('/kernel')
                                    else array)
        return unflatten_dict(flat, sep='/')

    @functools.cached_property
    def iterations(self) -> List[Iteration]:
        """ITERATIONS PPO iterations from the port's rollouts (see the
        module docstring)."""
        agent, config = self.agent, self.ppo_config
        optimizer = ppo.make_optimizer(config, agent)
        samples = self.num_envs * self.num_steps
        train = ppo.make_train_fn(agent, optimizer, config, samples)
        joptimizer = jppo.make_optimizer(self.jppo_config)
        jtrain = jax.jit(jppo.make_train_fn(self.jagent, joptimizer,
                                            self.jppo_config, samples))
        jparams = self.init_params
        jopt_state = joptimizer.init(jparams)
        recorder = StepRecorder(self.env)
        rollout = make_rollout_fn(self.env, agent, self.num_steps)
        generator = torch.Generator().manual_seed(1)
        states = self.env.init_states(self.num_envs)
        out = []
        for i in range(ITERATIONS):
            params = {k: v.clone() for k, v in agent.state_dict().items()}
            start = states
            states, traj = rollout(agent, states, generator)
            steps = recorder.take()
            data = buffer.compute_ppo_data(traj, config.gamma, config.lam)
            info = train(data, torch.Generator().manual_seed(i))
            jdata = jbuffer.compute_ppo_data(jax_trajectory(traj),
                                             config.gamma, config.lam)
            jparams, jopt_state, jinfo = jtrain(
                jparams, jopt_state, jdata, jax.random.PRNGKey(i))
            out.append(Iteration(
                start=start, params=params, traj=traj, steps=steps, end=states,
                info=info, jinfo={k: float(v) for k, v in jinfo.items()},
                data={k: _np(v) for k, v in data.items() if k != 'obs'},
                jdata={k: np.asarray(v) for k, v in jdata.items()
                       if k != 'obs'},
                after={k: v.clone() for k, v in agent.state_dict().items()},
                jparams=jparams, opt_count=optimizer.count,
                jopt_count=int(jopt_state[1][0].count)))
        return out

    @functools.cached_property
    def trained(self):
        """(JAX params, the port's agent) at head_draws.trained_state's
        weights (the archive's, the kappa head's output layer scaled)."""
        agent = build_model(self.config, self.space, device='cpu')
        agent.load_state_dict(head_draws.trained_state(self.name),
                              strict=True)
        return self.jax_params_of(agent.state_dict()), agent

    def draws(self, per_observation: int, seed: int = 0):
        """(port actions, JAX actions, observation ids, the rows drawn at):
        `per_observation` sampled actions at each of FAMILIES' observations
        of the first rollout in both packages at the trained weights,
        CHUNK rows an `act` (the port from one generator seeded with
        `seed`, the JAX package from PRNG key `seed` split per chunk)."""
        jparams, agent = self.trained
        rows, ids = head_draws.repeat_rows(head_draws.select_observations(
            self.name, self.iterations[0].traj.obs), per_observation)
        port = head_draws.draw_actions(agent, rows,
                                       torch.Generator().manual_seed(seed))
        key = jax.random.PRNGKey(seed)
        jax_actions = []
        for chunk in chunks(rows):
            key, sub = jax.random.split(key)
            jax_actions.append(np.asarray(self.jact(
                jparams, jax_obs(chunk), sub).action_flat))
        return port, np.concatenate(jax_actions), ids, rows

    def heads(self, jparams, rows: Observation, actions: np.ndarray):
        """(HeadDistributions, logp): the JAX agent's distributions at
        `actions` and their log-probability, chunked."""
        parts = [self.jheads(jparams, jax_obs(chunk), jnp.asarray(a))
                 for chunk, a in zip(chunks(rows),
                                     np.split(actions, _splits(len(actions))))]
        out = [np.asarray(parts[0][i]) if i == 3 else
               np.concatenate([np.asarray(p[i]) for p in parts])
               for i in range(6)]
        return HeadDistributions(*out[:5]), out[5]


def _splits(n: int) -> List[int]:
    return list(range(CHUNK, n, CHUNK))


def _jax_heads(m, obs: JaxObservation, actions: jnp.ndarray):
    """The JAX InternalAC's distributions of each sub-action of `actions`,
    given the ones before it, and their log-probability as `evaluate` sums
    it: the steps of InternalAC._step (molgym_tpu/agents/internal.py) with
    the actions given."""
    batch = obs.elements.shape[0]
    n_atoms = jnp.sum((obs.elements != 0).astype(jnp.int32), axis=-1)
    _occupied, focus_mask, action_mask = m._masks(n_atoms)
    atom_feats = m._encode(obs)
    bag_f = obs.bag.astype(jnp.float32)
    latent_bag = m.phi_beta(bag_f)
    latent = jnp.concatenate([atom_feats, jnp.broadcast_to(
        latent_bag[:, None, :], (batch, m.canvas_size, latent_bag.shape[-1]))],
        axis=-1)
    focus_probs = masked_categorical_probs(m.phi_focus(latent)[..., 0],
                                           focus_mask)
    focus = jnp.round(actions[:, 1]).astype(jnp.int32)
    focused = jnp.einsum('bn,bnl->bl', to_one_hot(focus, m.canvas_size), latent)
    element_probs = masked_categorical_probs(m.phi_element(focused),
                                             obs.bag > 0)
    element = jnp.round(actions[:, 2]).astype(jnp.int32)
    element_oh = to_one_hot(element, m.num_zs)
    means = jnp.tanh(m.phi_continuous(jnp.concatenate([focused, element_oh],
                                                      axis=-1)))
    means = means * (m.ranges_width / 2) + m.ranges_center
    stds = jnp.exp(1e-6 + m.log_stds)
    distance, angle, dihedral = actions[:, 3], actions[:, 4], actions[:, 5]
    kappa_logits = m._surrogate_kappa_logits(
        obs, n_atoms, focus, element, distance, angle, dihedral,
        m.phi_beta(bag_f - element_oh))
    kappa_probs = jax.nn.softmax(kappa_logits, axis=-1)
    kappa = jnp.round(actions[:, 6]).astype(jnp.int32)
    logp = jnp.sum(jnp.stack([
        categorical_log_prob(focus_probs, focus),
        categorical_log_prob(element_probs, element),
        normal_log_prob(distance, means[:, 0], stds[0]),
        normal_log_prob(angle, means[:, 1], stds[1]),
        normal_log_prob(dihedral, means[:, 2], stds[2]),
        categorical_log_prob(kappa_probs, kappa)], axis=-1) * action_mask,
        axis=-1)
    return focus_probs, element_probs, means, stds, kappa_probs, logp


def jax_trajectory(traj: buffer.Trajectory) -> jbuffer.Trajectory:
    return jbuffer.Trajectory(
        obs=jax_obs(traj.obs), next_obs=jax_obs(traj.next_obs),
        actions=jnp.asarray(_np(traj.actions)),
        rewards=jnp.asarray(_np(traj.rewards)),
        terminals=jnp.asarray(_np(traj.terminals)),
        values=jnp.asarray(_np(traj.values)),
        logps=jnp.asarray(_np(traj.logps)),
        bootstrap_value=jnp.asarray(_np(traj.bootstrap_value)))


def replay(family: Family, iteration: Iteration, jstates) -> dict:
    """Steps the JAX env through `iteration`'s rollout from `jstates` (the
    JAX states before it): the reset at rollout start, each step with the
    element and position the port's env was given, the auto-reset; at each
    step the JAX agent scores the port's observation and action at the
    port's parameters. Asserts the two agree (see the test files) and
    returns the JAX states after it and the cases the rollout went through."""
    env, jenv, traj = family.env, family.jenv, iteration.traj
    jparams = family.jax_params_of(iteration.params)
    jstates, jobs = family.jreset(jstates)
    cases = dict(refills=0, hull_refusals=0, low_or_invalid=0, resets=0,
                 refused=0, cut=0)
    min_reward = env.min_reward
    for t, rec in enumerate(iteration.steps):
        where = f'{family.name} step {t}'
        obs = Observation(traj.obs.elements[t], traj.obs.positions[t],
                          traj.obs.bag[t])
        np.testing.assert_array_equal(_np(obs.elements),
                                      np.asarray(jobs.elements), err_msg=where)
        np.testing.assert_array_equal(_np(obs.bag), np.asarray(jobs.bag),
                                      err_msg=where)
        np.testing.assert_allclose(_np(obs.positions),
                                   np.asarray(jobs.positions), rtol=0,
                                   atol=1e-5, err_msg=where)
        out = family.jscore(jparams, jobs, jnp.asarray(_np(traj.actions[t])))
        for got, ref, what in ((traj.logps[t], out.logp, 'logp'),
                               (traj.values[t], out.v, 'v')):
            np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=TOL,
                                       atol=TOL, err_msg=f'{where}: {what}')
        np.testing.assert_array_equal(_np(rec['element']),
                                      np.asarray(out.element), err_msg=where)
        np.testing.assert_allclose(_np(rec['position']),
                                   np.asarray(out.position), rtol=0,
                                   atol=1e-5, err_msg=f'{where}: position')

        element = jnp.asarray(_np(rec['element']).astype(np.int32))
        position = jnp.asarray(_np(rec['position']))
        valid = np.asarray(family.jvalid(jstates, element, position))
        np.testing.assert_array_equal(_np(rec['valid']), valid,
                                      err_msg=f'{where}: refused')
        result = family.jstep(jstates, element, position)
        np.testing.assert_allclose(_np(traj.rewards[t]),
                                   np.asarray(result.reward), rtol=0,
                                   atol=1e-5, err_msg=f'{where}: reward')
        done = np.asarray(result.done)
        np.testing.assert_array_equal(_np(traj.terminals[t]), done,
                                      err_msg=f'{where}: done')
        assert_states_equal(rec['state'], result.state, where)

        before_refills = np.asarray(jstates.refill_count)
        cases['refills'] += int((np.asarray(result.state.refill_count)
                                 > before_refills).sum())
        cases['refused'] += int((~valid).sum())
        if jenv.hull_a is not None:
            hull = np.asarray(position) @ np.asarray(jenv.hull_a).T + np.asarray(
                jenv.hull_b)
            cases['hull_refusals'] += int((~valid & (hull > 1e-6).any(-1)).sum())
        cases['low_or_invalid'] += int((done & (np.asarray(result.reward)
                                                <= min_reward + 1e-6)).sum())
        cases['resets'] += int(done.sum())
        jstates, jobs = family.jreset_if_terminal(result.state, result.done)
        assert_states_equal(rec['reset'], jstates, f'{where}: auto-reset')
    # the episodes cut at the iteration's end, with atoms placed
    cases['cut'] = int((~done & (np.asarray(jstates.n_atoms)
                                 > env.initial_n_atoms)).sum())
    assert_states_equal(iteration.end, jstates, f'{family.name}: end')
    bootstrap = family.jscore(jparams, jobs, jnp.zeros(
        (family.num_envs, 7), jnp.float32)).v
    np.testing.assert_allclose(_np(traj.bootstrap_value),
                               np.asarray(bootstrap), rtol=TOL, atol=TOL,
                               err_msg=f'{family.name}: bootstrap value')
    return dict(states=jstates, cases=cases)


def assert_internal_params_close(state: dict, jparams, lr, steps) -> None:
    """tests/test_torch_ppo.py's counting rule for the internal agent's
    state_dict: 1e-5, except at most 1% of the elements, whose Adam update
    flips sign at the float32 noise floor, by at most 2 lr per step taken
    so far."""
    ref = internal_params_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(jparams, sep='/').items()})
    assert set(ref) == set(state)
    n_total = n_off = 0
    for name, p in state.items():
        diff = (p.detach() - ref[name]).abs()
        assert float(diff.max()) <= 2 * lr * steps + 1e-5, name
        n_off += int((diff > 1e-5).sum())
        n_total += diff.numel()
    assert n_off <= 0.01 * n_total, (n_off, n_total)


# -- the tests both files collect (each file's module fixture `family`) ----


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_rollout_replays_through_the_jax_env(family):
    """A1: the port's ITERATIONS rollouts, stepped again through the JAX
    env (the reset at each rollout's start from the states the last one
    left, each step, the auto-resets) with the element and position each
    port step was given, and scored by the JAX agent at the port's
    parameters: the observations, every discrete field of every state
    (elements, bags, atom counts, refill counts, formula cursors), the
    terminals and which placements were refused exactly; positions and
    rewards within 1e-5; logp, v, the placement the JAX z-matrix makes of
    the action and the bootstrap value within 1e-4. The rollouts go
    through every case: a refill (solvation), a hull refusal (scaffold),
    a low-reward or refused termination, an episode cut at an iteration's
    end, which the next rollout's reset discards."""
    first = family.iterations[0].start
    jstates = family.jenv.init_states(jax.random.PRNGKey(0), family.num_envs)
    assert_states_equal(first, jstates, f'{family.name}: init_states')
    totals = {}
    for iteration in family.iterations:
        out = replay(family, iteration, jstates)
        jstates = out['states']
        for k, v in out['cases'].items():
            totals[k] = totals.get(k, 0) + v
    # the next rollout's reset discards the cut episodes as the JAX one does
    reset, _obs = family.env.reset(family.iterations[-1].end)
    assert_states_equal(reset, family.jreset(jstates)[0],
                        f'{family.name}: the next rollout\'s reset')
    print(family.name, totals)
    assert totals['low_or_invalid'] > 0 and totals['resets'] > 0, totals
    assert totals['cut'] > 0, totals
    if family.name == 'solvation':
        assert totals['refills'] > 0, totals
    else:
        assert totals['hull_refusals'] > 0, totals


def test_successive_ppo_updates_match_the_jax_package(family):
    """A2: each iteration both packages run compute_ppo_data and train on
    the port's rollout, each from its own parameters and optimizer state.
    An epoch sums its minibatches' gradients and steps once (scaffold's
    128 of 256: two full minibatches, no padding), so the permutations do
    not matter. Held: the advantages (standardised) and returns within
    1e-4, the last stepping epoch's losses, approx_kl, clip_fraction and
    grad_norm within 1e-4 relative and absolute (the scaffold's refusals
    leave its raw advantages within a standard deviation of 0.012 about
    -0.84, so their standardisation carries float32 order into the fifth
    digit: the JAX package's standardised advantages are 2.4e-5 off their
    float64 value, the port's 8.4e-6, and the policy loss, a sum of such
    terms that cancel to -0.029, 1.5e-5 apart), num_opt_steps and the
    optimizers' step
    counts exactly, the parameters by the counting rule
    (assert_internal_params_close). Prints whether the KL stop fired."""
    config = family.ppo_config
    steps = 0
    for i, it in enumerate(family.iterations):
        for k in ('adv', 'ret', 'logp'):
            np.testing.assert_allclose(it.data[k], it.jdata[k], rtol=TOL,
                                       atol=TOL, err_msg=(i, k))
        assert it.info['num_opt_steps'] == int(it.jinfo['num_opt_steps']), (
            i, it.info, it.jinfo)
        for k in ppo.INFO_KEYS + ('grad_norm', ):
            np.testing.assert_allclose(it.info[k], it.jinfo[k], rtol=TOL,
                                       atol=TOL, err_msg=(i, k))
        steps += it.info['num_opt_steps']
        assert it.opt_count == it.jopt_count == steps
        assert_internal_params_close(it.after, it.jparams,
                                     config.learning_rate, steps)
    print(family.name, 'num_opt_steps',
          [it.info['num_opt_steps'] for it in family.iterations], 'of',
          config.max_num_train_iters, '(the KL stop fired where fewer)')


@pytest.fixture(scope='module')
def draws(family):
    """The two packages' draws at the trained weights, and the JAX
    distributions at each set."""
    port, jax_actions, ids, rows = family.draws(
        FAMILIES[family.name]['draws_per_observation'])
    jparams, agent = family.trained
    port_heads, port_logp = family.heads(jparams, rows, port)
    jax_heads, _ = family.heads(jparams, rows, jax_actions)
    return dict(port=port, jax=jax_actions, ids=ids, rows=rows,
                port_heads=port_heads, port_logp=port_logp,
                jax_heads=jax_heads, agent=agent)


def test_head_distributions_match_the_jax_package(family, draws):
    """The port's head_distributions at its first CHUNK draws of each
    observation against the JAX heads (each given the sub-actions before
    it) within 1e-4, kappa's within 1e-3 (its output layer scaled: see
    Family.trained); the JAX heads' log-probability, summed as `evaluate`
    sums it, against the JAX `evaluate` at the same draws within 1e-4
    relative (1e-3 absolute at the kappa scale), which holds the heads to
    the reference's own scoring."""
    agent, ids, port = draws['agent'], draws['ids'], draws['port']
    first = np.concatenate([np.nonzero(ids == i)[0][:CHUNK]
                            for i in np.unique(ids)])
    rows = Observation(*(getattr(draws['rows'], f)[torch.from_numpy(first)]
                         for f in ('elements', 'positions', 'bag')))
    ref = draws['port_heads']
    got = []
    for chunk, a in zip(chunks(rows),
                        np.split(port[first], _splits(len(first)))):
        with torch.no_grad():
            got.append(agent.head_distributions(chunk, torch.from_numpy(a)))
    for i, name in enumerate(HeadDistributions._fields):
        value = (got[0][i].numpy() if name == 'stds' else
                 np.concatenate([g[i].numpy() for g in got]))
        want = getattr(ref, name)
        np.testing.assert_allclose(
            value, want if name == 'stds' else want[first], rtol=TOL,
            atol=1e-3 if name == 'kappa' else TOL, err_msg=name)
    logp = np.concatenate([
        np.asarray(family.jevaluate(family.trained[0], jax_obs(chunk),
                                    jnp.asarray(a)))
        for chunk, a in zip(chunks(rows),
                            np.split(port[first], _splits(len(first))))])
    np.testing.assert_allclose(draws['port_logp'][first], logp, rtol=TOL,
                               atol=1e-3)


def test_sampled_heads_draw_from_their_distributions(draws):
    """A3: each package's draws against the JAX distributions at them
    (sampling_checks.check_draws: focus, element given the focus, each
    continuous sub-action's KS and scale, kappa given the continuous
    ones), every p-value at or above P_MIN. No distance was clamped at
    0.001."""
    for name in ('port', 'jax'):
        p = check_draws(draws[name], draws['ids'], draws[f'{name}_heads'])
        print(name, {k: round(v, 6) for k, v in p.items()})
        assert not failures(p), (name, p)
        assert (draws[name][:, 3] > 0.001).all()


def test_the_two_packages_draw_alike(draws):
    """A3: the port's draws against the JAX package's at the same
    observations by the two-sample forms (compare_draws), every p-value at
    or above P_MIN."""
    p = compare_draws(draws['port'], draws['port_heads'], draws['jax'],
                      draws['jax_heads'], draws['ids'], draws['ids'])
    print({k: round(v, 6) for k, v in p.items()})
    assert not failures(p), p


def _std_fault(actions, heads, ids, rng):
    """The angle's standard deviation 1.1 times the learned one."""
    out = actions.copy()
    mean = heads.means[:, 1]
    out[:, 4] = mean + 1.1 * (actions[:, 4] - mean)
    return out


def _focus_fault(actions, heads, ids, rng):
    """At every observation, 0.02 of the focus's probability moved from its
    most to its least likely atom."""
    out = actions.copy()
    for i in np.unique(ids):
        rows = ids == i
        probs = heads.focus[rows].mean(axis=0)
        donor = int(np.argmax(probs))
        recipient = int(np.argmin(np.where(probs > 0, probs, np.inf)))
        move = rows & (actions[:, 1] == donor) & (
            rng.uniform(size=len(actions)) < 0.02 / probs[donor])
        out[move, 1] = recipient
    return out


def _kappa_fault(actions, heads, ids, rng):
    """Kappa flipped on 5% of the rows."""
    out = actions.copy()
    flip = rng.uniform(size=len(actions)) < 0.05
    out[flip, 6] = 1 - out[flip, 6]
    return out


@pytest.mark.parametrize('fault,statistic', [
    (_std_fault, 'angle_scale'), (_focus_fault, 'focus'),
    (_kappa_fault, 'kappa')], ids=['std_x1.1', 'focus_mass_0.02',
                                   'kappa_flip_5pct'])
def test_planted_faults_are_rejected(draws, fault, statistic):
    """The check's teeth: a fault planted post hoc in the port's draws (no
    program code changes) is rejected by the statistic that watches its
    head, at P_MIN, against the same distributions."""
    rng = np.random.RandomState(0)
    faulty = fault(draws['port'], draws['port_heads'], draws['ids'], rng)
    p = check_draws(faulty, draws['ids'], draws['port_heads'])
    print(statistic, p[statistic])
    assert p[statistic] < P_MIN, p
