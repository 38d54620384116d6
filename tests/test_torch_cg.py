"""The port's CG tables and plain SO(3) ops against molgym_tpu's.

Tables are compared bit for bit (both are built in numpy by the same
algorithm); the float32 tensor ops at 1e-5 relative (summation order
differs between XLA and PyTorch)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molgym_tpu.ops import cg as jcg
from molgym_tpu.ops import sph as jsph
from molgym_tpu_torch.ops import cg as tcg
from molgym_tpu_torch.ops import sph as tsph

RTOL = 1e-5
ATOL = 1e-5

CONFIGS = [(1, 5, 4), (5, 1, 4), (5, 5, 4), (3, 3, 2), (4, 2, 3)]


@pytest.mark.parametrize('n1,n2,maxl', CONFIGS)
def test_fused_table_bit_equal(n1, n2, maxl):
    jt, jsl = jcg._fused_cg_table(n1, n2, maxl)
    tt, tsl = tcg._fused_cg_table(n1, n2, maxl)
    assert jt.dtype == tt.dtype and np.array_equal(jt, tt)
    assert jsl == tsl


@pytest.mark.parametrize('n1,n2,maxl', CONFIGS)
def test_grouped_table_bit_equal(n1, n2, maxl):
    jg = jcg.fused_cg_table_grouped(n1, n2, maxl)
    tg = tcg.fused_cg_table_grouped(n1, n2, maxl)
    assert (jg is None) == (tg is None)
    if jg is None:
        return
    assert len(jg[0]) == len(tg[0])
    for a, b in zip(jg[0], tg[0]):
        assert a.shape == b.shape and np.array_equal(a, b)
    assert np.array_equal(jg[1], tg[1])
    assert jg[2] == tg[2]


@pytest.mark.parametrize('n_ells,maxl', [(5, 4), (3, 2), (4, 3)])
def test_tri_table_bit_equal(n_ells, maxl):
    jp, jgr, jperm, jsi = jcg.fused_cg_table_tri(n_ells, maxl)
    tp, tgr, tperm, tsi = tcg.fused_cg_table_tri(n_ells, maxl)
    assert np.array_equal(jp, tp)
    for (ja, jb, jt), (ta, tb, tt) in zip(jgr, tgr):
        assert (ja, jb) == (ta, tb)
        assert jt.shape == tt.shape and np.array_equal(jt, tt)
    assert np.array_equal(jperm, tperm)
    assert jsi == tsi


@pytest.mark.parametrize('conj', [False, True])
def test_spherical_harmonics_rel(conj):
    rng = np.random.RandomState(0)
    pos = rng.randn(3, 5, 3).astype(np.float32)
    js, jn = jsph.spherical_harmonics_rel(4, jnp.asarray(pos), jnp.asarray(pos),
                                          conj=conj)
    ts, tn = tsph.spherical_harmonics_rel(4, torch.from_numpy(pos),
                                          torch.from_numpy(pos), conj=conj)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=RTOL, atol=ATOL)
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize('n1,n2,maxl', [(5, 5, 4), (1, 5, 4), (3, 2, 3)])
def test_cg_product_packed_ri(n1, n2, maxl):
    rng = np.random.RandomState(1)
    m1, m2 = n1 * n1, n2 * n2
    ar, ai = rng.randn(2, 3, 4, m1).astype(np.float32)
    br, bi = rng.randn(2, 3, 4, m2).astype(np.float32)
    (jr, ji), jsl = jcg.cg_product_packed_ri(*map(jnp.asarray, (ar, ai, br, bi)),
                                             n1, n2, maxl)
    (tr, ti), tsl = tcg.cg_product_packed_ri(
        *map(torch.from_numpy, (ar, ai, br, bi)), n1, n2, maxl)
    assert jsl == tsl
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('n_edge,n_atom,maxl', [(5, 1, 4), (5, 5, 4), (3, 3, 2)])
def test_cg_aggregate_packed(n_edge, n_atom, maxl):
    rng = np.random.RandomState(2)
    edge = rng.randn(2, 4, 4, 3, n_edge * n_edge, 2).astype(np.float32)
    atom = rng.randn(2, 4, 3, n_atom * n_atom, 2).astype(np.float32)
    jo, jsl = jcg.cg_aggregate_packed(jnp.asarray(edge), jnp.asarray(atom),
                                      n_edge, n_atom, maxl)
    to, tsl = tcg.cg_aggregate_packed(torch.from_numpy(edge),
                                      torch.from_numpy(atom), n_edge, n_atom,
                                      maxl)
    assert jsl == tsl
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)


def test_pack_unpack_and_m_slices():
    rng = np.random.RandomState(3)
    rep = [rng.randn(2, 3, 2 * l + 1, 2).astype(np.float32) for l in range(4)]
    packed = tcg.pack_so3([torch.from_numpy(r) for r in rep])
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jcg.pack_so3([jnp.asarray(r) for r in rep])))
    for a, b in zip(tcg.unpack_so3(packed, 4), rep):
        np.testing.assert_array_equal(a.numpy(), b)
    assert tcg.m_slices(3, 4) == jcg.m_slices(3, 4)


def _so3vec(rng, taus, batch=(3, )):
    return [rng.randn(*batch, t, 2 * l + 1, 2).astype(np.float32)
            for l, t in enumerate(taus)]


# (taus of rep1, taus of rep2, maxl): even taus, a rep of tau 1 broadcast
# against tau 3 (the mixer's distance rep, then a two-l rep), and maxl below
# l1 + l2
PRODUCT_CASES = [((2, 2, 2), (2, 2, 2), 2), ((1, ), (3, 3, 3), 2),
                 ((3, 3, 3), (1, 1), 3), ((2, 2, 2, 2), (2, 2), 3)]


@pytest.mark.parametrize('taus1,taus2,maxl', PRODUCT_CASES)
def test_cg_product_per_l(taus1, taus2, maxl):
    """The per-l product against the JAX one (einsum backend and the Pallas
    kernel in interpret mode, 2e-5 as the JAX test) and the loop oracles."""
    rng = np.random.RandomState(4)
    a, b = _so3vec(rng, taus1), _so3vec(rng, taus2)
    ja, jb = [jnp.asarray(x) for x in a], [jnp.asarray(x) for x in b]
    ref = jcg.cg_product(ja, jb, maxl)
    jcg.set_cg_backend('pallas_interpret')
    try:
        ref_kernel = jcg.cg_product(ja, jb, maxl)
    finally:
        jcg.set_cg_backend('einsum')
    ta, tb = [torch.from_numpy(x) for x in a], [torch.from_numpy(x) for x in b]
    out = tcg.cg_product(ta, tb, maxl)
    loops = tcg._cg_product_loops(ta, tb, maxl)
    jloops = jcg._cg_product_loops(ja, jb, maxl)
    assert len(out) == maxl + 1
    taus = tcg.cg_output_taus(taus1, taus2, maxl)
    assert taus == jcg.cg_output_taus(taus1, taus2, maxl)
    for l, (o, r, rk, lo, jl) in enumerate(zip(out, ref, ref_kernel, loops,
                                               jloops)):
        assert o.shape == (3, taus[l], 2 * l + 1, 2)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(rk), atol=2e-5)
        np.testing.assert_allclose(lo.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(o.numpy(), lo.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('taus_e,taus_a,maxl', [((2, 2, 2), (2, 2, 2), 2),
                                                ((3, 3, 3), (1, ), 2),
                                                ((1, 2), (2, 2, 2), 3)])
def test_cg_aggregate_per_l(taus_e, taus_a, maxl):
    rng = np.random.RandomState(5)
    edge = _so3vec(rng, taus_e, batch=(2, 4, 4))
    atom = _so3vec(rng, taus_a, batch=(2, 4))
    je, ja = [jnp.asarray(x) for x in edge], [jnp.asarray(x) for x in atom]
    te = [torch.from_numpy(x) for x in edge]
    ta = [torch.from_numpy(x) for x in atom]
    out = tcg.cg_aggregate(te, ta, maxl)
    loops = tcg._cg_aggregate_loops(te, ta, maxl)
    for o, lo, r, jl in zip(out, loops, jcg.cg_aggregate(je, ja, maxl),
                            jcg._cg_aggregate_loops(je, ja, maxl)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(lo.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(o.numpy(), lo.numpy(), rtol=RTOL, atol=ATOL)


def test_cg_product_gradient_matches_jax():
    """d/d rep of sum(cg_product * cot), against jax.grad through the Pallas
    custom VJP in interpret mode (3e-4, the JAX test's)."""
    import jax
    rng = np.random.RandomState(6)
    a, b = _so3vec(rng, (2, 2, 2)), _so3vec(rng, (1, 2))
    maxl = 2
    cots = [rng.randn(3, t, 2 * l + 1, 2).astype(np.float32)
            for l, t in enumerate(tcg.cg_output_taus((2, 2, 2), (1, 2), maxl))]

    def jloss(ja, jb):
        return sum(jnp.sum(o * c) for o, c in zip(jcg.cg_product(ja, jb, maxl),
                                                  cots))
    jcg.set_cg_backend('pallas_interpret')
    try:
        ga, gb = jax.grad(jloss, argnums=(0, 1))(
            [jnp.asarray(x) for x in a], [jnp.asarray(x) for x in b])
    finally:
        jcg.set_cg_backend('einsum')
    ta = [torch.from_numpy(x).requires_grad_() for x in a]
    tb = [torch.from_numpy(x).requires_grad_() for x in b]
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip(tcg.cg_product(ta, tb, maxl), cots))
    grads = torch.autograd.grad(loss, ta + tb)
    for t, j in zip(grads, list(ga) + list(gb)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=3e-4, atol=3e-4)


def test_taus_that_do_not_pair_are_refused():
    rng = np.random.RandomState(7)
    a = [torch.from_numpy(x) for x in _so3vec(rng, (2, 2))]
    b = [torch.from_numpy(x) for x in _so3vec(rng, (3, 3))]
    with pytest.raises(ValueError, match='taus'):
        tcg.cg_product(a, b, 2)
    with pytest.raises(ValueError, match='taus'):
        tcg.cg_output_taus((2, ), (3, ), 1)


def test_pack_so3_ri_gives_contiguous_parts():
    rng = np.random.RandomState(8)
    rep = [torch.from_numpy(x) for x in _so3vec(rng, (3, 3, 3))]
    r, i = tcg.pack_so3_ri(rep)
    packed = tcg.pack_so3(rep)
    assert r.is_contiguous() and i.is_contiguous()
    assert not packed[..., 0].is_contiguous()
    torch.testing.assert_close(r, packed[..., 0], rtol=0, atol=0)
    torch.testing.assert_close(i, packed[..., 1], rtol=0, atol=0)
    # one l block of a stacked rep is a strided view too
    r1, i1 = tcg.pack_so3_ri(rep[:1])
    assert r1.is_contiguous() and r1.shape == (3, 3, 1)
