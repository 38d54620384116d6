"""The covariant trained checkpoints evaluated greedily in both packages on
the CPU with the greedy distance taken from shared candidates
(molgym_tpu_torch/tools/shared_draws.py), so that every greedy episode is
a deterministic function of the weights and the packages are held at float
tolerance, not at the spread of their draws. This file holds the three
device-LJ checkpoints (stochastic, sf6_bf16, organics) and the machinery;
tests/test_torch_shared_draws_pm6.py the six PM6 ones (a file of its own,
so that the suite's workers take the two apart).

The covariant agent's greedy act takes its distance as the best of 128 GMM
draws (distributions/gmm.py::gmm_argmax in both packages), which the two
packages make from different generators: the gates of
tests/test_torch_checkpoint.py, test_torch_host_rollout.py and
test_torch_driver_checkpoints.py are the spread of those draws (5e-4 to
0.07) and stay as they are. Here `gmm_argmax` is replaced, from the test
only, in both agents' modules by one pure function of (log-weights, means,
stds), written once per package in its own float32: 128 candidates, each
component's mean plus its std times shared_draws.QUANTILES, and the one of
highest mixture log-prob. The rest of the greedy act draws nothing: the
focus and element are argmaxes, the orientation the best point of a fixed
grid.

Each checkpoint is played by the protocol of its existing test (8 envs,
one greedy episode per evaluation formula): stochastic and sf6_bf16 as
test_torch_checkpoint.py plays them (device LJ), sf6_pm6 as
test_torch_host_rollout.py (PM6), the rest through each package's driver
as test_torch_driver_checkpoints.py::evaluate_both. Held at every step of
every env:
  * float32: the same focus, element and done, every distance and
    orientation (the unit vector that carries both angles) within 1e-5,
    every episode's return within 1e-4;
  * sf6_bf16: the same focus, element and done, distances within 0.01 and
    returns within 0.02 (measured here: 0.0044 and 0.0138; the gate on the
    mean with draws is 0.05). The two packages round the encoder to bf16 at
    other places, so its GMM means already differ by 6e-4 at the second
    action, and then its orientation's ring tie (below) goes either way;
  * a ring tie: on a canvas whose atoms lie on one line the orientation's
    density is symmetric about that line, and where its mode is not on the
    line it is a ring, whose best grid points tie. The packages may take
    two points of the ring: a rotation about the line apart, the same
    energy. Where the orientations part, the step is a ring tie only if
    everything else of the action is held and the JAX package's
    orientation scores, in the port's own density, within F32_TIE (bf16:
    BF16_TIE, measured 8.2e-4) of the grid's best; the rest of that
    episode is held but for its orientations, which the grid then
    discretises in two frames. The ties are listed, RING_TIES: halides_pm6's
    CH3Cl at its third action (H on a C-H line; the port's best two grid
    logits equal, and the JAX pick scores the same), and sf6_bf16's third
    action (F on an S-F line).
Any other parting fails with its step, both packages' actions and the
port's margins between the best two choices of each sub-action. Each
port mean is also the one chip_smoke.py's phase 14d holds the card to
(SHARED).

The JAX agent's rollout is traced after the patch (jax.clear_caches()
then, and again after the patch is undone, so that no later test on this
worker meets a trace of it). The files read experiments/ and write
nothing there."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import chip_smoke
import molgym_tpu.agents.covariant as jax_covariant
from molgym_tpu.calculators import native as jnative
from molgym_tpu.calculators.reward_host import \
    make_host_reward as jax_host_reward
from molgym_tpu.distributions.gmm import gmm_log_prob as jax_gmm_log_prob
from molgym_tpu.envs.environment import MolecularEnv as JaxMolecularEnv
from molgym_tpu.envs.reward import make_lennard_jones_reward as jax_lj
from molgym_tpu.rl.rollout import make_rollout_fn as jax_rollout_fn
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu_torch.calculators.native import (METHOD_PM6,
                                                 NativeBatchCalculator)
from molgym_tpu_torch.calculators.reward_host import make_host_reward
from molgym_tpu_torch.distributions import spherical
from molgym_tpu_torch.envs.environment import MolecularEnv
from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
from molgym_tpu_torch.formula import string_to_formula
from molgym_tpu_torch.rl.rollout import make_rollout_fn
from molgym_tpu_torch.spaces import ObservationSpace
from molgym_tpu_torch.tools import shared_draws

from .test_torch_checkpoint import NUM_ENVS, _restore, agent_pair
from .test_torch_checkpoint import RUNS as CHECKPOINT_RUNS
from .test_torch_driver_checkpoints import episode_returns, evaluate_both
from .test_torch_host_reward import one_torch_thread  # noqa: F401

F32_TOL = dict(action=1e-5, returns=1e-4)
BF16_TOL = dict(action=0.01, returns=0.02)
F32_TIE, BF16_TIE = 1e-5, 2e-3
# name -> the steps of its ring ties (see the docstring)
RING_TIES = {'halides_pm6': [2, 12], 'sf6_bf16': [2]}

# chip_smoke.TRAINED's name of a run where it is not the driver test's
SMOKE_NAMES = {'stochastic_pm6-run-1': 'stochastic_pm6'}
# name -> (protocol, the run of test_torch_checkpoint.py or
# test_torch_host_rollout.py); the driver runs go by their
# test_torch_driver_checkpoints.RUNS names
CASES = {
    'stochastic': ('checkpoint', CHECKPOINT_RUNS['stochastic']),
    'sf6_bf16': ('checkpoint', CHECKPOINT_RUNS['sf6_bf16']),
    'organics': ('driver', None),
}


def jax_gmm_argmax_shared(_rng, log_weights, means, stds, count=128):
    """shared_draws.gmm_argmax_shared in JAX: the same candidates, from the
    same float32 quantiles, and the first best."""
    assert count == shared_draws.COUNT
    comp = np.arange(count) % means.shape[-1]
    stds = jnp.broadcast_to(stds, means.shape)
    cand = jnp.moveaxis(means[..., comp] + stds[..., comp]
                        * jnp.asarray(shared_draws.QUANTILES), -1, 0)
    logp = jax_gmm_log_prob(log_weights, means, stds, cand)
    best = jnp.argmax(logp, axis=0)
    return jnp.take_along_axis(cand, best[None], axis=0)[0]


@pytest.fixture(scope='module', autouse=True)
def shared_greedy_draws():
    """Both agents' greedy distance from the shared candidates for a
    module's tests; the JAX traces made with it are dropped after."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax_covariant, 'gmm_argmax', jax_gmm_argmax_shared)
        jax.clear_caches()
        with shared_draws.shared_greedy_draws():
            yield
    jax.clear_caches()


def _single_formula(run, pm6):
    """(port trajectory, JAX trajectory, port agent, returns of both
    [NUM_ENVS, 1]) of the run's formula, each env's first greedy episode,
    with the device LJ reward (test_torch_checkpoint.py) or PM6
    (test_torch_host_rollout.py)."""
    jspace = JaxObservationSpace(run['canvas_size'], list(run['zs']))
    jagent, agent, params_from_jax = agent_pair(run)
    params = _restore(run, jagent, jspace)
    agent.load_state_dict(params_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(params, sep='/').items()}),
        strict=True)
    bag = np.stack([jspace.bag_from_formula(
        string_to_formula(run['formula']))])
    steps = run['canvas_size'] + 1
    jreward = (jax_host_reward(jnative.NativeBatchCalculator(
        jnative.METHOD_PM6)) if pm6 else jax_lj())
    jenv = JaxMolecularEnv(reward_fn=jreward, observation_space=jspace,
                           formulas=bag)
    _s, jtraj = jax_rollout_fn(jenv, jagent, steps, deterministic=True)(
        params, jenv.init_states(jax.random.PRNGKey(1), NUM_ENVS),
        jax.random.PRNGKey(2))
    reward = (make_host_reward(NativeBatchCalculator(METHOD_PM6)) if pm6
              else make_lennard_jones_reward())
    env = MolecularEnv(reward, ObservationSpace(run['canvas_size'],
                                                list(run['zs'])),
                       bag, device='cpu')
    gen = torch.Generator().manual_seed(1)
    _s, traj = make_rollout_fn(env, agent, steps, deterministic=True)(
        agent, env.init_states(NUM_ENVS, gen), gen)
    return (traj, jtraj, agent,
            episode_returns(traj.rewards.numpy(), traj.terminals.numpy(), 1),
            episode_returns(jtraj.rewards, jtraj.terminals, 1))


def margins(agent, obs, b, orientation):
    """The port's act of env b at `obs`: the gap between the best two
    choices of each greedy sub-action (focus and element probabilities,
    the shared distance candidates' log-probs, the orientation grid's
    logits), and how far below the grid's best logit `orientation` (the
    JAX package's choice) scores."""
    def gap(x):
        top = torch.topk(x.flatten(), 2).values
        return float(top[0] - top[1])
    one = obs.map(lambda x: x[b:b + 1])
    with torch.no_grad():
        _out, dists = agent.act_with_dists(one, torch.Generator(),
                                           deterministic=True)
        _c, logp = shared_draws.candidate_log_probs(*dists['gmm'])
        grid = spherical._fibonacci_grid(spherical._ARGMAX_GRID_N, 'cpu')
        so3 = spherical.log_prob_unnormalized(dists['so3_dist'],
                                              grid[:, None, :])
        other = spherical.log_prob_unnormalized(
            dists['so3_dist'], torch.tensor(orientation)[None, None])
    return dict(focus=gap(dists['focus_probs']),
                element=gap(dists['element_probs']), distance=gap(logp),
                orientation=gap(so3),
                other_orientation_below=float(so3.max() - other.max()))


def compare(traj, jtraj, tol, tie, port_agent):
    """Holds the two trajectories step by step, env by env: the same focus,
    element and done, distances within tol['action'], orientations within
    it but after a ring tie. Returns the ring ties, [(step, env)]; fails
    with a report at any other parting; `port_agent` gives the margins."""
    ours, theirs = traj.actions.numpy(), np.asarray(jtraj.actions)
    dones = traj.terminals.numpy()
    assert ours.shape == theirs.shape
    assert (dones == np.asarray(jtraj.terminals)).all(), 'another done'
    ties = []
    for b in range(ours.shape[1]):
        tied = False   # since a ring tie of this env's current episode
        for t in range(ours.shape[0]):
            a, ja = ours[t, b], theirs[t, b]
            held = ((a[:2] == ja[:2]).all()
                    and abs(a[2] - ja[2]) <= tol['action'])
            if not held or (not tied and (np.abs(a[3:] - ja[3:])
                                          > tol['action']).any()):
                found = margins(port_agent, traj.obs.map(lambda x: x[t]),
                                b, ja[3:])
                if not held or found['other_orientation_below'] > tie:
                    pytest.fail(f'the packages part at step {t}, env {b}: '
                                f'port {a.tolist()}, JAX {ja.tolist()}, the '
                                f"port's margins {found}")
                tied = True
                ties.append((t, b))
            if dones[t, b]:
                tied = False
    return ties


def check(name, protocol, run):
    """Plays checkpoint `name` in both packages by `protocol` and holds
    them (see the docstring)."""
    if protocol == 'driver':
        tret, jret, _env, traj, _config, jtraj, agent = evaluate_both(name)
    else:
        traj, jtraj, agent, tret, jret = _single_formula(
            run, pm6=protocol == 'pm6')
    bf16 = name == 'sf6_bf16'
    tol = BF16_TOL if bf16 else F32_TOL
    ties = compare(traj, jtraj, tol, BF16_TIE if bf16 else F32_TIE, agent)
    assert sorted(set(t for t, _b in ties)) == RING_TIES.get(name, []), ties
    assert np.isfinite(tret).all() and np.isfinite(jret).all()
    assert np.abs(tret - np.asarray(jret)).max() <= tol['returns'], (
        tret, jret)
    # what phase 14d holds the card to: this mean and these discrete actions
    shared = chip_smoke.SHARED[SMOKE_NAMES.get(name, name)]
    assert abs(float(tret.mean()) - shared['cpu']) <= 1e-6, tret.mean()
    assert chip_smoke.discrete_actions(traj) == shared['actions']


@pytest.mark.parametrize('name', list(CASES))
def test_greedy_evaluation_from_shared_draws_is_the_same(name):
    check(name, *CASES[name])


def test_shared_candidates():
    """The candidates: component j mod K's mean plus its std times the
    j-th quantile, the quantiles at (j + 1/4) / 128, none the mirror of
    another; the best is the candidate of highest mixture log-prob in
    both packages, and the generator is not used."""
    q = shared_draws.QUANTILES.astype(np.float64)
    assert len(q) == 128 and (np.diff(q) > 0).all()
    assert np.abs(q[:, None] + q[None, :]).min() > 1e-3
    log_w = torch.tensor([[0.0, -1.0, -2.0], [-3.0, 0.5, 0.0]])
    means = torch.tensor([[1.0, 1.5, 2.0], [1.2, 1.1, 1.9]])
    stds = torch.tensor([0.1, 0.2, 0.3])
    cand = shared_draws.candidates(means, stds)
    assert cand.shape == (128, 2)
    j = torch.arange(128)
    assert torch.equal(cand[:, 1], means[1, j % 3] + stds[j % 3]
                       * torch.from_numpy(shared_draws.QUANTILES))
    best = shared_draws.gmm_argmax_shared(None, log_w, means, stds)
    logp = np.asarray(jax_gmm_log_prob(
        jnp.asarray(log_w.numpy()), jnp.asarray(means.numpy()),
        jnp.asarray(stds.numpy()), jnp.asarray(cand.numpy())))
    assert np.array_equal(best.numpy(),
                          cand.numpy()[logp.argmax(axis=0), [0, 1]])
    assert np.array_equal(best.numpy(), np.asarray(jax_gmm_argmax_shared(
        None, jnp.asarray(log_w.numpy()), jnp.asarray(means.numpy()),
        jnp.asarray(stds.numpy()))))
