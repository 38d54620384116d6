"""The port's internal agents (molgym_tpu_torch/agents/internal.py and
schnet.py) against molgym_tpu's, from one Flax init carried over by
convert.internal_params_from_jax: the `internal` SchNet agent at a small
size (width 32, 2 interactions, canvas 5, zs X,H,C,O) and at SF6's full
width (width 128, 3 interactions, canvas 7, zs X,F,S), and the `mlp`
agent (width 32, canvas 5, zs X,H,C,O).

Held: the encoder's features; `evaluate` (logp, ent, v) at actions JAX
sampled; the PPO loss's gradient of every leaf; the greedy `act` (the same
actions and positions: it draws nothing); a sampled `act` re-scored by the
JAX `evaluate` (the two packages' random streams differ); and a fresh
init's scale per leaf against Flax's.

Tolerance: 1e-4 relative and absolute in float32 (each gradient: 1e-4 of
its leaf's largest |g|), as tests/test_torch_covariant.py; the encoder's
features within 1e-4 of their largest magnitude. A fresh init's RMS per
leaf within four standard errors of Flax's (two random draws)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from molgym_tpu.agents.internal import \
    make_mlp_internal_agent as jax_mlp_agent
from molgym_tpu.agents.schnet import make_schnet_agent as jax_schnet_agent
from molgym_tpu.ops import zmat as jzmat
from molgym_tpu.rl import ppo as jppo
from molgym_tpu.spaces import Observation as JaxObservation
from molgym_tpu_torch.agents.internal import make_mlp_internal_agent
from molgym_tpu_torch.agents.schnet import make_schnet_agent
from molgym_tpu_torch.convert import internal_params_from_jax
from molgym_tpu_torch.rl import ppo
from molgym_tpu_torch.spaces import Observation

TOL = 1e-4

CONFIGS = {
    'small': dict(model='internal', zs=(0, 1, 6, 8), canvas_size=5,
                  network_width=32, min_max_distance=(0.9, 1.8),
                  n_interactions=2),
    'sf6': dict(model='internal', zs=(0, 9, 16), canvas_size=7,
                network_width=128, min_max_distance=(1.1, 2.1),
                n_interactions=3),
    'mlp': dict(model='mlp', zs=(0, 1, 6, 8), canvas_size=5,
                network_width=32, min_max_distance=(0.8, 1.8)),
}
PPO_CONFIG = ppo.PPOConfig(entropy_coef=0.01, vf_coef=0.5)


def make_batch(cfg, batch, seed):
    """Random canvases with atoms 0.9-2.1 A apart along a random walk, an
    empty canvas first, then one of each atom count (0 to full)."""
    rng = np.random.RandomState(seed)
    n, nz = cfg['canvas_size'], len(cfg['zs'])
    n_atoms = np.arange(batch) % (n + 1)
    elements = np.zeros((batch, n), np.int64)
    positions = np.zeros((batch, n, 3), np.float32)
    bag = np.zeros((batch, nz), np.int64)
    for b in range(batch):
        k = n_atoms[b]
        elements[b, :k] = rng.randint(1, nz, size=k)
        steps = rng.randn(k, 3)
        steps *= rng.uniform(0.9, 2.1, (k, 1)) / np.linalg.norm(
            steps, axis=-1, keepdims=True)
        positions[b, :k] = np.cumsum(steps, axis=0) - steps[:1]
        bag[b, 1:] = rng.randint(0, 3, size=nz - 1)
        bag[b, 1] += 1
    return elements, positions, bag


def jax_fields(arrays):
    return tuple(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
                 for a in arrays)


def jax_obs(arrays):
    return JaxObservation(*jax_fields(arrays))


def torch_obs(arrays):
    return Observation(*(torch.from_numpy(a) for a in arrays))


def _agent_makers(cfg):
    kwargs = dict(num_zs=len(cfg['zs']), canvas_size=cfg['canvas_size'],
                  network_width=cfg['network_width'],
                  min_max_distance=cfg['min_max_distance'])
    if cfg['model'] == 'mlp':
        return (jax_mlp_agent(**kwargs),
                lambda: make_mlp_internal_agent(**kwargs, device='cpu'))
    extra = dict(n_interactions=cfg['n_interactions'])
    return (jax_schnet_agent(**kwargs, **extra),
            lambda: make_schnet_agent(**kwargs, **extra, device='cpu'))


class Pair:
    """One Flax init of a config carried over to the port, with the JAX
    functions jitted once for every test of the config."""

    def __init__(self, name):
        self.cfg = cfg = CONFIGS[name]
        self.jagent, self.build = _agent_makers(cfg)
        jagent = self.jagent
        self.params = jax.jit(
            lambda o, k: jagent.init(k, o, k, method=jagent.act))(
                jax_obs(make_batch(cfg, 2, seed=0)), jax.random.PRNGKey(0))
        self.flat = {k: np.asarray(v)
                     for k, v in flatten_dict(self.params, sep='/').items()}
        self.agent = self.build()
        missing, unexpected = self.agent.load_state_dict(
            internal_params_from_jax(self.flat), strict=True)
        assert not missing and not unexpected
        self.encoder = jax.jit(lambda prm, e, p, b: jagent.apply(
            prm, e, p, b, method=lambda m, e_, p_, b_: m.encoder(e_, p_, b_)))
        self.evaluate = jax.jit(lambda prm, o, a: jagent.apply(
            prm, o, a, method=jagent.evaluate))
        self.act = jax.jit(lambda prm, o, k, det: jagent.apply(
            prm, o, k, det, method=jagent.act), static_argnums=3)
        self.grad = jax.jit(jax.grad(jppo.make_loss_fn(jagent, PPO_CONFIG),
                                     has_aux=True))


@pytest.fixture(scope='module', params=list(CONFIGS))
def pair(request):
    return Pair(request.param)


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol)


def test_param_tree_carries_over(pair):
    """Every Flax leaf lands on a port parameter of its size, and the
    port has no other."""
    state = pair.agent.state_dict()
    assert len(pair.flat) == len(state)
    assert sum(v.size for v in pair.flat.values()) == sum(
        v.numel() for v in state.values())
    if pair.cfg['model'] == 'internal':
        assert 'encoder.interactions.1.in2f.weight' in state
        assert 'encoder.interactions.1.in2f.bias' not in state
    else:
        assert 'encoder.mlp.layers.1.weight' in state


def test_encoder_matches(pair):
    arrays = make_batch(pair.cfg, 12, seed=1)
    ref = np.asarray(pair.encoder(pair.params, *jax_fields(arrays)))
    with torch.no_grad():
        got = pair.agent.encoder(*map(torch.from_numpy, arrays))
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL * scale)
    if pair.cfg['model'] == 'internal':
        # SchNet's features are zero on the empty slots
        assert not got[torch.from_numpy(arrays[0] == 0)].any()


def _jax_sampled_actions(pair, arrays, seed):
    return np.array(pair.act(pair.params, jax_obs(arrays),
                             jax.random.PRNGKey(seed), False).action_flat)


def test_evaluate_matches(pair):
    """logp, ent, v at actions JAX sampled, on canvases of every size."""
    arrays = make_batch(pair.cfg, 12, seed=2)
    actions = _jax_sampled_actions(pair, arrays, 2)
    jlogp, jent, jv = pair.evaluate(pair.params, jax_obs(arrays),
                                    jnp.asarray(actions))
    with torch.no_grad():
        logp, ent, v = pair.agent.evaluate(torch_obs(arrays),
                                           torch.from_numpy(actions))
    for got, ref in ((logp, jlogp), (ent, jent), (v, jv)):
        _close(got, ref)


def test_loss_gradients_match(pair):
    """The PPO loss (clipped surrogate, value, entropy) and the gradient of
    every leaf, within 1e-4 of the leaf's largest |g|; a leaf whose
    gradient is below 1e-3 of the largest leaf's (the focus and kappa
    heads' last biases: a softmax does not see a shift of its logits) is
    held against 1e-3 of the largest leaf's instead."""
    arrays = make_batch(pair.cfg, 12, seed=3)
    actions = _jax_sampled_actions(pair, arrays, 3)
    rng = np.random.RandomState(3)
    logp, adv, ret = (rng.randn(12).astype(np.float32) for _ in range(3))
    weights = np.ones(12, np.float32)
    jgrads, jinfo = pair.grad(pair.params, jax_obs(arrays), *map(
        jnp.asarray, (actions, logp, adv, ret, weights)))
    agent = pair.build()
    agent.load_state_dict(pair.agent.state_dict())
    loss, info = ppo.make_loss_fn(agent, PPO_CONFIG)(
        torch_obs(arrays), *map(torch.from_numpy,
                                (actions, logp, adv, ret, weights)))
    loss.backward()
    for key in ppo.INFO_KEYS:
        np.testing.assert_allclose(float(info[key]), float(jinfo[key]),
                                   rtol=TOL, atol=1e-6)
    ref = internal_params_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(jgrads, sep='/').items()})
    floor = 1e-3 * max(float(g.abs().max()) for g in ref.values())
    for name, p in agent.named_parameters():
        assert p.grad is not None, name
        scale = max(float(ref[name].abs().max()), floor)
        err = float((p.grad - ref[name]).abs().max())
        assert err <= TOL * scale, (name, err, scale)


def test_greedy_act_matches(pair):
    """The greedy act draws nothing: the same focus and element, the
    continuous means, and the same kappa, log-probs, values and
    placements. On a canvas of at most 3 atoms (coplanar) SchNet's two
    kappa candidates are mirror images with the same distances, so their
    logits tie up to rounding and kappa may go either way there; its
    placement is then the mirror one, which the JAX z-matrix placement at
    the port's kappa must give."""
    arrays = make_batch(pair.cfg, 12, seed=4)
    jout = pair.act(pair.params, jax_obs(arrays), jax.random.PRNGKey(0), True)
    with torch.no_grad():
        out = pair.agent.act(torch_obs(arrays), torch.Generator(), True)
    got, ref = out.action_flat.numpy(), np.asarray(jout.action_flat)
    np.testing.assert_array_equal(got[:, :3], ref[:, :3])
    _close(out.action_flat[:, 3:6], ref[:, 3:6])
    np.testing.assert_array_equal(out.element.numpy(), np.asarray(jout.element))
    n_atoms = (arrays[0] != 0).sum(-1)
    same = got[:, 6] == ref[:, 6]
    mirror_tie = (n_atoms <= 3) & (pair.cfg['model'] == 'internal')
    assert (same | mirror_tie).all(), (got[:, 6], ref[:, 6])
    _close(out.position[same], np.asarray(jout.position)[same])
    for field in ('logp', 'ent', 'v'):
        _close(getattr(out, field), getattr(jout, field))
    sign = np.where(got[:, 6] == 1, -1.0, 1.0).astype(np.float32)
    _close(out.position, jax.vmap(jzmat.position_atom)(
        jnp.asarray(arrays[1]), jnp.asarray(n_atoms),
        jnp.asarray(got[:, 1].astype(np.int32)), *(
            jnp.asarray(x) for x in (got[:, 3], got[:, 4],
                                     sign * got[:, 5]))))
    # an empty canvas places at the origin
    assert not out.position[torch.from_numpy(n_atoms == 0)].any()


def test_sampled_act_is_rescored_alike(pair):
    """Actions the port samples score under the JAX `evaluate` the logp,
    ent and v the port's act reported; a sampled distance is >= 0.001."""
    arrays = make_batch(pair.cfg, 12, seed=5)
    with torch.no_grad():
        out = pair.agent.act(torch_obs(arrays),
                             torch.Generator().manual_seed(5))
    actions = out.action_flat.numpy()
    assert actions.shape == (12, 7) and (actions[:, 3] >= 0.001).all()
    assert not actions[:, 0].any()
    jlogp, jent, jv = pair.evaluate(pair.params, jax_obs(arrays),
                                    jnp.asarray(actions))
    for got, ref in ((out.logp, jlogp), (out.ent, jent), (out.v, jv)):
        _close(got, ref)
    # the act draws from its generator alone: the same seed, the same act
    with torch.no_grad():
        again = pair.agent.act(torch_obs(arrays),
                               torch.Generator().manual_seed(5))
    torch.testing.assert_close(again.action_flat, out.action_flat, rtol=0,
                               atol=0)


def test_fresh_init_scale_matches_flax(pair):
    """A fresh port agent's leaves have the shapes of Flax's, and each
    leaf's RMS is Flax's within four standard errors of two draws
    (orthogonal weights and zero biases are exact; lecun_normal's and the
    embedding's RMS are estimates from the leaf's entries)."""
    torch.manual_seed(11)
    fresh = {k: v.numpy() for k, v in pair.build().state_dict().items()}
    flax = internal_params_from_jax(pair.flat)
    assert set(fresh) == set(flax)
    for name, ref in flax.items():
        ref = ref.numpy()
        got = fresh[name]
        assert got.shape == ref.shape, name
        rms_got = float(np.sqrt(np.mean(got.astype(np.float64) ** 2)))
        rms_ref = float(np.sqrt(np.mean(ref.astype(np.float64) ** 2)))
        if rms_ref == 0.0:
            assert rms_got == 0.0, name
            continue
        # the RMS of n draws has a relative standard error <= 1/sqrt(2n)
        assert abs(rms_got - rms_ref) <= 4 * np.sqrt(2.0 / (2 * ref.size)) * (
            rms_ref), (name, rms_got, rms_ref)
        if name.startswith('encoder.interactions'):
            # lecun_normal is truncated at two standard deviations
            bound = 2.0 * np.sqrt(1.0 / ref.shape[1]) / 0.87962566103423978
            assert np.abs(got).max() <= bound * (1 + 1e-6), name
            assert np.abs(ref).max() <= bound * (1 + 1e-6), name


def test_normal_helpers_match():
    """The port's normal log-density and entropy (the continuous heads')
    against the JAX package's, and normal_sample's draw: mean + std times
    one torch.randn draw of the generator."""
    from molgym_tpu.distributions import discrete as jdiscrete
    from molgym_tpu_torch.distributions import discrete
    rng = np.random.RandomState(7)
    x, mean = (rng.randn(5, 3).astype(np.float32) for _ in range(2))
    std = rng.uniform(0.1, 2.0, (5, 3)).astype(np.float32)
    _close(discrete.normal_log_prob(*map(torch.from_numpy, (x, mean, std))),
           jdiscrete.normal_log_prob(*map(jnp.asarray, (x, mean, std))))
    _close(discrete.normal_entropy(torch.from_numpy(std)),
           jdiscrete.normal_entropy(jnp.asarray(std)))
    got = discrete.normal_sample(torch.Generator().manual_seed(3),
                                 torch.from_numpy(mean), torch.from_numpy(std))
    noise = torch.randn((5, 3), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(got, torch.from_numpy(mean) +
                               torch.from_numpy(std) * noise, rtol=0, atol=0)
