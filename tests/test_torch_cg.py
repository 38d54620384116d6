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
