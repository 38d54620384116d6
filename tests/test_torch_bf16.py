"""The port's bf16 encoder path (`encoder_dtype='bfloat16'`) against
molgym_tpu's: the plain bf16 aggregate and square (what the bf16 kernels
compute: bf16 in, f32 math, bf16 out) against the JAX package's Pallas
kernels on bf16 operands in interpret mode, forward and gradients; then the
whole bf16 agent against the JAX bf16 agent, and against the port's own f32
agent, from one set of parameters.

Inputs are seeded numpy arrays rounded to bf16 first, so that a comparison
sees the compute precision, not the quantization of the inputs.
Tolerances:
  * kernels: 0.03 of the reference's max |value| absolute and 0.05
    relative, the JAX package's own bf16 gate (tests/covariant/
    test_so3_ops.py): the TPU kernels also round the CG coefficients and
    the pair tensor to bf16, the port's keep them in f32;
  * bf16 agents, port vs JAX: log-prob and value within 0.05, greedy
    discrete actions equal, every gradient within 0.03 of its leaf's max
    |g| (leaves below 1e-3 of the largest leaf's held against that floor);
  * port bf16 vs port f32: value within 0.15, log-prob within 0.3 (and 0.2
    relative), greedy discrete actions equal, the JAX package's gates for
    the same comparison (tests/covariant/test_covariant_agent.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from molgym_tpu.agents.covariant import CovariantAC as JaxCovariantAC
from molgym_tpu.ops import cg as jcg
from molgym_tpu.ops import pallas_agg
from molgym_tpu_torch.agents.covariant import CovariantAC
from molgym_tpu_torch.convert import covariant_params_from_jax
from molgym_tpu_torch.ops import cg as tcg
from molgym_tpu_torch.ops import fused_agg
from tests.test_torch_covariant import SMALL, jax_obs, make_batch, torch_obs

BF16 = torch.bfloat16


def bf16_round(x):
    """float32 numpy values rounded to bf16 (the JAX package's `bfr`)."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def to_torch(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(BF16)


def to_jax(x):
    return jnp.asarray(x, jnp.bfloat16)


def assert_bf16_close(got, ref):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=0.03 * scale, rtol=0.05)


def _tables(lib, maxl, atom_n_ells):
    n_ells = maxl + 1
    table3, _sl = lib._fused_cg_table(n_ells, atom_n_ells, maxl)
    g = lib.fused_cg_table_grouped(n_ells, atom_n_ells, maxl)
    return table3, None if g is None else (g[0], g[1])


@pytest.mark.parametrize('maxl,atom_n_ells', [(2, 3), (3, 1), (4, 5)])
@pytest.mark.parametrize('B,path', [(4, 'grouped'), (3, 'fallback')])
def test_bf16_aggregate_matches_pallas(B, path, maxl, atom_n_ells):
    """Forward and the gradients of rad and the atom rep, on both of the
    JAX aggregate's strategies."""
    N, tau = 3, 2
    assert (pallas_agg._grouped_tile(B, N, tau) is not None) == (path == 'grouped')
    rng = np.random.RandomState(10 * maxl + B)
    m1, m2 = (maxl + 1) ** 2, atom_n_ells ** 2
    sph, rad, ar, ai = (bf16_round(rng.randn(*shape)) for shape in (
        (B, N, N, m1, 2), (B, N, N, tau, maxl + 1), (B, N, tau, m2),
        (B, N, tau, m2)))
    jtable, jgrouped = _tables(jcg, maxl, atom_n_ells)

    def jax_fn(rad_, ar_, ai_):
        return pallas_agg.cg_aggregate_edge_fused_ri(
            to_jax(sph), rad_, ar_, ai_, jtable, interpret=True,
            grouped=jgrouped)
    jout = jax_fn(to_jax(rad), to_jax(ar), to_jax(ai))
    assert jout[0].dtype == jnp.bfloat16
    cot = [bf16_round(rng.randn(*jout[0].shape)) for _ in range(2)]
    jgrads = jax.grad(lambda *x: sum(
        jnp.sum(o.astype(jnp.float32) * c) for o, c in zip(jax_fn(*x), cot)),
        argnums=(0, 1, 2))(to_jax(rad), to_jax(ar), to_jax(ai))

    ttable, tgrouped = _tables(tcg, maxl, atom_n_ells)
    leaves = [to_torch(x).requires_grad_() for x in (rad, ar, ai)]
    tout = fused_agg.cg_aggregate_edge_fused_ri(to_torch(sph), *leaves, ttable,
                                                grouped=tgrouped)
    assert all(o.dtype == BF16 for o in tout)
    for t, j in zip(tout, jout):
        assert_bf16_close(t.detach(), j)
    tgrads = torch.autograd.grad(tout, leaves,
                                 [to_torch(c) for c in cot])
    for t, j in zip(tgrads, jgrads):
        assert t.dtype == BF16
        assert_bf16_close(t, j)


@pytest.mark.parametrize('maxl', [2, 3, 4])
def test_bf16_tri_square_matches_pallas(maxl):
    """The tri-fold square, forward and gradient of the rep."""
    n_ells = maxl + 1
    rng = np.random.RandomState(17 + maxl)
    ar, ai = (bf16_round(rng.randn(2, 3, 5, n_ells ** 2)) for _ in range(2))
    jtable, _sl = jcg._fused_cg_table(n_ells, n_ells, maxl)
    jpairs, jgroups, _perm, _si = jcg.fused_cg_table_tri(n_ells, maxl)

    def jax_fn(ar_, ai_):
        return pallas_agg.cg_square_fused_ri(ar_, ai_, jtable,
                                             tri=(jpairs, jgroups),
                                             interpret=True)
    jout = jax_fn(to_jax(ar), to_jax(ai))
    assert jout[0].dtype == jnp.bfloat16
    cot = [bf16_round(rng.randn(*jout[0].shape)) for _ in range(2)]
    jgrads = jax.grad(lambda *x: sum(
        jnp.sum(o.astype(jnp.float32) * c) for o, c in zip(jax_fn(*x), cot)),
        argnums=(0, 1))(to_jax(ar), to_jax(ai))

    ttable, _sl = tcg._fused_cg_table(n_ells, n_ells, maxl)
    tpairs, tgroups, _perm, _si = tcg.fused_cg_table_tri(n_ells, maxl)
    leaves = [to_torch(x).requires_grad_() for x in (ar, ai)]
    tout = fused_agg.cg_square_fused_ri(*leaves, ttable, tri=(tpairs, tgroups))
    for t, j in zip(tout, jout):
        assert t.dtype == BF16
        assert_bf16_close(t.detach(), j)
    tgrads = torch.autograd.grad(tout, leaves, [to_torch(c) for c in cot])
    for t, j in zip(tgrads, jgrads):
        assert t.dtype == BF16
        assert_bf16_close(t, j)


def test_wrappers_refuse_a_mix_of_dtypes():
    """One dtype for all operands, on the CPU as on the card: a bf16 rep
    with f32 harmonics is refused, not cast."""
    table3, grouped = _tables(tcg, 2, 3)
    sph = torch.zeros(1, 2, 2, 9, 2)
    rad = torch.zeros(1, 2, 2, 1, 3, dtype=BF16)
    q = torch.zeros(1, 2, 1, 9, dtype=BF16)
    with pytest.raises(TypeError, match='one dtype'):
        fused_agg.cg_aggregate_edge_fused_ri(sph, rad, q, q, table3,
                                             grouped=grouped)
    with pytest.raises(TypeError, match='float16'):
        fused_agg.cg_square_fused_ri(q.half(), q.half(), table3)


# ---------------------------------------------------------------------------
# the agent
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def bf16_pair():
    """One Flax init of the small configuration, the JAX agent in f32 and
    in bf16, the port's bf16 and f32 agents carrying its parameters."""
    arrays = make_batch(SMALL, 4, seed=21)
    jagent = JaxCovariantAC(**SMALL)
    params = jax.jit(lambda o, k: jagent.init(k, o, k, method=jagent.act))(
        jax_obs(arrays), jax.random.PRNGKey(0))
    state = covariant_params_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(params, sep='/').items()})
    agents = {}
    for dtype in ('bfloat16', 'float32'):
        agents[dtype] = CovariantAC(**SMALL, encoder_dtype=dtype, device='cpu')
        agents[dtype].load_state_dict(state, strict=True)
    return dict(arrays=arrays, params=params, agents=agents,
                jagent=JaxCovariantAC(**SMALL, encoder_dtype='bfloat16'))


def _loss(logp, ent, v):
    return logp.mean() + 0.5 * (v ** 2).mean() + 0.01 * ent.mean()


def test_bf16_agent_matches_jax_bf16_agent(bf16_pair):
    """Greedy act and evaluate, and every parameter's gradient of a loss on
    the evaluated log-prob, entropy and value. The JAX aggregate and square
    run their Pallas kernels on bf16 operands in interpret mode."""
    arrays, params = bf16_pair['arrays'], bf16_pair['params']
    jagent, agent = bf16_pair['jagent'], bf16_pair['agents']['bfloat16']
    jcg.set_aggregate_backend('pallas_interpret')
    try:
        jout = jax.jit(lambda prm, o, k: jagent.apply(
            prm, o, k, True, method=jagent.act))(params, jax_obs(arrays),
                                                 jax.random.PRNGKey(3))
        actions = np.array(jout.action_flat)

        def jloss(prm, o, a):
            return _loss(*jagent.apply(prm, o, a, method=jagent.evaluate))
        jlogp, jent, jv = jax.jit(lambda prm, o, a: jagent.apply(
            prm, o, a, method=jagent.evaluate))(params, jax_obs(arrays),
                                                jnp.asarray(actions))
        jgrads = jax.jit(jax.grad(jloss))(params, jax_obs(arrays),
                                          jnp.asarray(actions))
    finally:
        jcg.set_aggregate_backend('auto')

    # a bf16 encoder makes the card's bf16 matrix products sum in f32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    with torch.no_grad():
        out = agent.act(torch_obs(arrays), torch.Generator().manual_seed(3),
                        deterministic=True)
    assert out.v.dtype == torch.float32
    np.testing.assert_array_equal(out.action_flat[:, :2].numpy(),
                                  actions[:, :2])
    np.testing.assert_allclose(out.v.numpy(), np.asarray(jout.v), atol=0.05)

    logp, ent, v = agent.evaluate(torch_obs(arrays), torch.from_numpy(actions))
    assert logp.dtype == v.dtype == torch.float32
    np.testing.assert_allclose(logp.detach().numpy(), np.asarray(jlogp),
                               atol=0.05)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), atol=0.05)
    agent.zero_grad(set_to_none=True)
    _loss(logp, ent, v).backward()
    ref = covariant_params_from_jax(
        {k: np.asarray(g) for k, g in flatten_dict(jgrads, sep='/').items()})
    floor = 1e-3 * max(float(g.abs().max()) for g in ref.values())
    for name, p in agent.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        scale = max(float(ref[name].abs().max()), floor)
        err = float((p.grad - ref[name]).abs().max())
        assert err <= 0.03 * scale, (name, err, scale)


def test_bf16_agent_close_to_f32_agent(bf16_pair):
    """The same parameters in bf16 and in f32: close values, the same
    greedy discrete decisions."""
    arrays = bf16_pair['arrays']
    bf16, f32 = bf16_pair['agents']['bfloat16'], bf16_pair['agents']['float32']
    with torch.no_grad():
        out16 = bf16.act(torch_obs(arrays), torch.Generator().manual_seed(1),
                         deterministic=True)
        out32 = f32.act(torch_obs(arrays), torch.Generator().manual_seed(1),
                        deterministic=True)
        logp16, _ent, _v = bf16.evaluate(torch_obs(arrays), out32.action_flat)
        logp32, _ent, _v = f32.evaluate(torch_obs(arrays), out32.action_flat)
    np.testing.assert_allclose(out16.v.numpy(), out32.v.numpy(), atol=0.15,
                               rtol=0.15)
    np.testing.assert_array_equal(out16.action_flat[:, :2].numpy(),
                                  out32.action_flat[:, :2].numpy())
    np.testing.assert_allclose(logp16.numpy(), logp32.numpy(), atol=0.3,
                               rtol=0.2)
    # the encoder ran in bf16: its covariants differ from f32's, a little
    obs = torch_obs(arrays)
    with torch.no_grad():
        cov16 = bf16.encoder(obs.elements, obs.positions, obs.bag,
                             bf16.zs_array)
        cov32 = f32.encoder(obs.elements, obs.positions, obs.bag,
                            f32.zs_array)
    assert all(c.dtype == torch.float32 for c in cov16)
    assert any(not torch.equal(a, b) for a, b in zip(cov16, cov32))
