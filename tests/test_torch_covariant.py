"""The port's CovariantAC against molgym_tpu's, from one Flax init carried
over by convert.covariant_params_from_jax.

Tolerance: 1e-4 relative and absolute (encoder covariants scaled by their
largest magnitude) in float32: three CG levels and the heads sum in another
order than XLA. Sampling is held through log-probs: the RNG streams differ,
so actions the port samples are re-scored by the JAX `evaluate`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from molgym_tpu.agents.cormorant import CormorantMixer as JaxCormorantMixer
from molgym_tpu.agents.covariant import CovariantAC as JaxCovariantAC
from molgym_tpu.ops import cg as jcg
from molgym_tpu.spaces import Observation as JaxObservation
from molgym_tpu_torch.agents.cormorant import CormorantMixer
from molgym_tpu_torch.agents.covariant import CovariantAC
from molgym_tpu_torch.convert import covariant_params_from_jax
from molgym_tpu_torch.spaces import Observation

TOL = 1e-4

SF6 = dict(zs=(0, 9, 16), canvas_size=7, network_width=128, maxl=4,
           num_cg_levels=3, num_channels_hidden=10, num_channels_per_element=4,
           num_gaussians=3, bag_scale=5, min_max_distance=(1.10, 2.10),
           beta=-10.0)
SMALL = dict(zs=(0, 1, 6, 8), canvas_size=5, network_width=32, maxl=2,
             num_cg_levels=2, num_channels_hidden=6, num_channels_per_element=3,
             num_gaussians=3, bag_scale=1, min_max_distance=(0.9, 1.8),
             beta=None)
# the stochastic-bag configuration (4 elements, canvas 10, maxl 3, 2 CG
# levels, 4 channels per element, beta -10), narrow: width 32, hidden 6
STOCH = dict(zs=(0, 1, 6, 8), canvas_size=10, network_width=32, maxl=3,
             num_cg_levels=2, num_channels_hidden=6, num_channels_per_element=4,
             num_gaussians=3, bag_scale=6, min_max_distance=(0.9, 1.8),
             beta=-10.0)


def make_batch(cfg, batch, seed):
    """Random canvases (the bench.py recipe), one of them empty."""
    rng = np.random.RandomState(seed)
    n, nz = cfg['canvas_size'], len(cfg['zs'])
    n_atoms = rng.randint(1, n, size=batch)
    n_atoms[0] = 0
    elements = np.zeros((batch, n), np.int32)
    positions = np.zeros((batch, n, 3), np.float32)
    bag = np.zeros((batch, nz), np.int32)
    for b in range(batch):
        elements[b, :n_atoms[b]] = rng.randint(1, nz, size=n_atoms[b])
        positions[b, :n_atoms[b]] = rng.randn(n_atoms[b], 3) * 1.2
        bag[b, 1:] = rng.randint(0, 3, size=nz - 1)
        bag[b, 1] += 1
    return elements, positions, bag


def jax_obs(arrays):
    return JaxObservation(*(jnp.asarray(a) for a in arrays))


def torch_obs(arrays):
    e, p, b = arrays
    return Observation(elements=torch.from_numpy(e.astype(np.int64)),
                       positions=torch.from_numpy(p),
                       bag=torch.from_numpy(b.astype(np.int64)))


class Pair:
    """One Flax init of a config, carried over to the port, with the JAX
    functions jitted once (every test of a config shares their compiles)."""

    def __init__(self, cfg, arrays):
        self.jagent = jagent = JaxCovariantAC(**cfg)
        self.params = jax.jit(
            lambda o, k: jagent.init(k, o, k, method=jagent.act))(
                jax_obs(arrays), jax.random.PRNGKey(0))
        flat = {k: np.asarray(v)
                for k, v in flatten_dict(self.params, sep='/').items()}
        self.agent = CovariantAC(**cfg, device='cpu')
        missing, unexpected = self.agent.load_state_dict(
            covariant_params_from_jax(flat), strict=True)
        assert not missing and not unexpected
        self.encoder = jax.jit(lambda prm, e, p, b: jagent.apply(
            prm, e, p, b, method=lambda m, e_, p_, b_: m.encoder(
                e_, p_, b_, m.zs_array)))
        self.evaluate = jax.jit(lambda prm, o, a: jagent.apply(
            prm, o, a, method=jagent.evaluate))


@pytest.fixture(scope='module')
def sf6():
    return Pair(SF6, make_batch(SF6, 4, seed=4))


@pytest.fixture(scope='module')
def small():
    return Pair(SMALL, make_batch(SMALL, 3, seed=3))


def check_encoder_and_evaluate(pair, arrays, actions):
    jcov = pair.encoder(pair.params, *(jnp.asarray(a) for a in arrays))
    tobs = torch_obs(arrays)
    with torch.no_grad():
        tcov = pair.agent.encoder(tobs.elements, tobs.positions, tobs.bag,
                                  pair.agent.zs_array)
        tlogp, tent, tv = pair.agent.evaluate(tobs, torch.from_numpy(actions))
    for j, t in zip(jcov, tcov):
        scale = max(float(np.abs(np.asarray(j)).max()), 1.0)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL * scale)
    jlogp, jent, jv = pair.evaluate(pair.params, jax_obs(arrays),
                                    jnp.asarray(actions))
    for t, j in ((tlogp, jlogp), (tent, jent), (tv, jv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


def test_small_encoder_and_evaluate_match(small):
    """Actions sampled by JAX, scored by both."""
    arrays = make_batch(SMALL, 3, seed=3)
    jagent = small.jagent
    jout = jax.jit(lambda prm, o, k: jagent.apply(
        prm, o, k, False, method=jagent.act))(small.params, jax_obs(arrays),
                                              jax.random.PRNGKey(3))
    check_encoder_and_evaluate(small, arrays, np.array(jout.action_flat))


@pytest.mark.parametrize('deterministic', [False, True])
def test_sf6_encoder_and_evaluate_match(sf6, deterministic):
    """Full SF6 width, B = 4: actions the port samples (or picks greedily)
    score the same log-prob and value under both."""
    arrays = make_batch(SF6, 4, seed=9 + deterministic)
    with torch.no_grad():
        out = sf6.agent.act(torch_obs(arrays),
                            torch.Generator().manual_seed(0),
                            deterministic=deterministic)
    assert out.action_flat.shape == (4, sf6.agent.num_subactions)
    # the empty canvas places its first atom at the origin
    np.testing.assert_array_equal(out.position[0].numpy(), np.zeros(3))
    check_encoder_and_evaluate(sf6, arrays, out.action_flat.numpy())
    # act_with_dists: the same draw, plus the distributions behind it
    with torch.no_grad():
        out2, dists = sf6.agent.act_with_dists(
            torch_obs(arrays), torch.Generator().manual_seed(0),
            deterministic=deterministic)
    torch.testing.assert_close(out2.action_flat, out.action_flat)
    torch.testing.assert_close(dists['focus_probs'].sum(-1), torch.ones(4))
    assert dists['so3_dist'].beta == SF6['beta']
    jlogp, _jent, jv = sf6.evaluate(sf6.params, jax_obs(arrays),
                                    jnp.asarray(out.action_flat.numpy()))
    np.testing.assert_allclose(out.logp.numpy(), np.asarray(jlogp), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(out.v.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


@pytest.fixture(scope='module')
def stoch():
    return Pair(STOCH, make_batch(STOCH, 5, seed=6))


def test_stochastic_config_converts_and_evaluates(stoch):
    """The stochastic configuration's parameter tree (4 elements, maxl 3,
    2 levels) carries over name for name, and both packages compute the same
    on canvases whose bags, atom counts and element masks differ."""
    flat = flatten_dict(stoch.params, sep='/')
    state = stoch.agent.state_dict()
    assert len(flat) == len(state)
    assert sum(int(np.prod(v.shape)) for v in flat.values()) == sum(
        v.numel() for v in state.values())
    assert 'encoder.cg_level_1.cat_mix.w_r_l3_s1' in state
    assert 'encoder.cg_level_2.ag_mix.w_r_l0_s0' not in state
    arrays = make_batch(STOCH, 5, seed=6)
    assert len({tuple(b > 0) for b in arrays[2]}) > 1    # element masks differ
    with torch.no_grad():
        out = stoch.agent.act(torch_obs(arrays),
                              torch.Generator().manual_seed(1))
    check_encoder_and_evaluate(stoch, arrays, out.action_flat.numpy())


@pytest.mark.parametrize('maxl,tau,n_other', [(3, 4, 1), (4, 4, 1), (2, 3, 3)])
def test_mixer_matches(maxl, tau, n_other):
    """CormorantMixer alone, its JAX products through the Pallas kernel in
    interpret mode: the distance rep (one l, as in the agent) or a full rep
    conditions the atom's covariants."""
    rng = np.random.RandomState(maxl)
    atom = [rng.randn(5, tau, 2 * l + 1, 2).astype(np.float32)
            for l in range(maxl + 1)]
    other = [rng.randn(5, tau, 2 * l + 1, 2).astype(np.float32)
             for l in range(n_other)]
    jmixer = JaxCormorantMixer(maxl=maxl, tau_out=tau)
    jatom, jother = [jnp.asarray(x) for x in atom], [jnp.asarray(x) for x in other]
    params = jmixer.init(jax.random.PRNGKey(0), jatom, jother)
    jcg.set_cg_backend('pallas_interpret')
    try:
        ref = jmixer.apply(params, jatom, jother)
    finally:
        jcg.set_cg_backend('einsum')
    mixer = CormorantMixer(maxl=maxl, tau=tau, tau_out=tau, n_other=n_other,
                           n_atom=maxl + 1)
    mixer.load_state_dict(covariant_params_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(params, sep='/').items()}),
        strict=True)
    with torch.no_grad():
        out = mixer([torch.from_numpy(x) for x in atom],
                    [torch.from_numpy(x) for x in other])
    for t, j in zip(out, ref):
        scale = max(float(np.abs(np.asarray(j)).max()), 1.0)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL * scale)
