"""The port's fused CG aggregate and CG square against molgym_tpu's Pallas
kernels (run in interpret mode, as the JAX package's own tests run them on
the CPU), on both of the JAX aggregate's strategies: grouped (B % 4 == 0
here) and the row fallback (B % 4 != 0).

Tolerance: 1e-5 relative, 2e-5 absolute on O(1) random inputs, float32 with
a different summation order. The sparse-column tables the CUDA kernels read
are held against the plain version here by contracting them in PyTorch; the
kernels themselves are compared with the plain version on the card
(tests/test_torch_kernels.py and chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molgym_tpu.ops import cg as jcg
from molgym_tpu.ops import pallas_agg
from molgym_tpu_torch.ops import cg as tcg
from molgym_tpu_torch.ops import fused_agg

RTOL = 1e-5
ATOL = 2e-5


def _agg_inputs(B, N, tau, maxl, atom_n_ells, seed):
    rng = np.random.RandomState(seed)
    n_ells = maxl + 1
    m1, m2 = n_ells ** 2, atom_n_ells ** 2
    sph = rng.randn(B, N, N, m1, 2).astype(np.float32)
    rad = rng.randn(B, N, N, tau, n_ells).astype(np.float32)
    atom_r = rng.randn(B, N, tau, m2).astype(np.float32)
    atom_i = rng.randn(B, N, tau, m2).astype(np.float32)
    return sph, rad, atom_r, atom_i


def _agg_tables(maxl, atom_n_ells, lib):
    n_ells = maxl + 1
    table3, _sl = lib._fused_cg_table(n_ells, atom_n_ells, maxl)
    g = lib.fused_cg_table_grouped(n_ells, atom_n_ells, maxl)
    return table3, None if g is None else (g[0], g[1])


def _csc_contract(z_r, z_i, blocks):
    """What the kernels do after forming z: a sparse-column contraction."""
    colptr, pair, coef = fused_agg.sparse_columns(blocks)
    out_r = torch.zeros(z_r.shape[:-1] + (len(colptr) - 1, ))
    out_i = torch.zeros_like(out_r)
    col = np.repeat(np.arange(len(colptr) - 1), np.diff(colptr))
    c = torch.from_numpy(coef)
    out_r.index_add_(-1, torch.from_numpy(col), z_r[..., pair] * c)
    out_i.index_add_(-1, torch.from_numpy(col), z_i[..., pair] * c)
    return out_r, out_i


@pytest.mark.parametrize('maxl,atom_n_ells', [(2, 1), (2, 3), (4, 1), (4, 5)])
@pytest.mark.parametrize('B,path', [(4, 'grouped'), (3, 'fallback')])
def test_aggregate_plain_matches_pallas(B, path, maxl, atom_n_ells):
    N, tau = 3, 2
    assert (pallas_agg._grouped_tile(B, N, tau) is not None) == (path == 'grouped')
    sph, rad, ar, ai = _agg_inputs(B, N, tau, maxl, atom_n_ells, seed=maxl)
    jtable, jgrouped = _agg_tables(maxl, atom_n_ells, jcg)
    jr, ji = pallas_agg.cg_aggregate_edge_fused_ri(
        jnp.asarray(sph), jnp.asarray(rad), jnp.asarray(ar), jnp.asarray(ai),
        jtable, interpret=True, grouped=jgrouped)
    ttable, tgrouped = _agg_tables(maxl, atom_n_ells, tcg)
    args = tuple(map(torch.from_numpy, (sph, rad, ar, ai)))
    tr, ti = fused_agg.cg_aggregate_edge_fused_ri_plain(*args, ttable,
                                                        grouped=tgrouped)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)
    # the public wrapper takes the plain version for CPU tensors
    wr, wi = fused_agg.cg_aggregate_edge_fused_ri(*args, ttable,
                                                  grouped=tgrouped)
    assert torch.equal(wr, tr) and torch.equal(wi, ti)


@pytest.mark.parametrize('maxl,atom_n_ells', [(2, 3), (4, 1), (4, 5)])
def test_aggregate_kernel_tables_match_plain(maxl, atom_n_ells):
    B, N, tau = 2, 3, 2
    sph, rad, ar, ai = map(torch.from_numpy,
                           _agg_inputs(B, N, tau, maxl, atom_n_ells, seed=7))
    table3, grouped = _agg_tables(maxl, atom_n_ells, tcg)
    ref_r, ref_i = fused_agg.cg_aggregate_edge_fused_ri_plain(
        sph, rad, ar, ai, table3, grouped=grouped)
    reps = torch.tensor([2 * l + 1 for l in range(maxl + 1)])
    rad_m = torch.repeat_interleave(rad, reps, dim=-1)
    e_r = rad_m * sph[..., 0][:, :, :, None, :]
    e_i = rad_m * sph[..., 1][:, :, :, None, :]
    z_r = (torch.einsum('bijtm,bjtn->bitmn', e_r, ar) -
           torch.einsum('bijtm,bjtn->bitmn', e_i, ai)).flatten(-2)
    z_i = (torch.einsum('bijtm,bjtn->bitmn', e_r, ai) +
           torch.einsum('bijtm,bjtn->bitmn', e_i, ar)).flatten(-2)
    out_r, out_i = _csc_contract(z_r, z_i,
                                 fused_agg._aggregate_blocks(table3, grouped))
    np.testing.assert_allclose(out_r.numpy(), ref_r.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_i.numpy(), ref_i.numpy(), rtol=RTOL, atol=ATOL)


def _square_args(mode, maxl, lib):
    n_ells = maxl + 1
    table3, _sl = lib._fused_cg_table(n_ells, n_ells, maxl)
    grouped = tri = None
    if mode == 'grouped':
        g = lib.fused_cg_table_grouped(n_ells, n_ells, maxl)
        grouped = None if g is None else (g[0], g[1])
    elif mode == 'tri':
        pairs, groups, _perm, _si = lib.fused_cg_table_tri(n_ells, maxl)
        tri = (pairs, groups)
    return table3, grouped, tri


@pytest.mark.parametrize('mode', ['dense', 'grouped', 'tri'])
@pytest.mark.parametrize('maxl', [2, 4])
def test_square_plain_matches_pallas(mode, maxl):
    rng = np.random.RandomState(11 + maxl)
    m = (maxl + 1) ** 2
    ar, ai = rng.randn(2, 2, 3, 4, m).astype(np.float32)
    jtable, jg, jtri = _square_args(mode, maxl, jcg)
    jr, ji = pallas_agg.cg_square_fused_ri(jnp.asarray(ar), jnp.asarray(ai),
                                           jtable, grouped=jg, tri=jtri,
                                           interpret=True)
    ttable, tg, ttri = _square_args(mode, maxl, tcg)
    args = (torch.from_numpy(ar), torch.from_numpy(ai))
    tr, ti = fused_agg.cg_square_fused_ri_plain(*args, ttable, grouped=tg,
                                                tri=ttri)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL, atol=ATOL)
    wr, wi = fused_agg.cg_square_fused_ri(*args, ttable, grouped=tg, tri=ttri)
    assert torch.equal(wr, tr) and torch.equal(wi, ti)


@pytest.mark.parametrize('mode', ['dense', 'tri'])
def test_square_kernel_tables_match_plain(mode):
    maxl = 4
    rng = np.random.RandomState(5)
    m = (maxl + 1) ** 2
    ar, ai = map(torch.from_numpy, rng.randn(2, 6, m).astype(np.float32))
    table3, grouped, tri = _square_args(mode, maxl, tcg)
    ref_r, ref_i = fused_agg.cg_square_fused_ri_plain(ar, ai, table3,
                                                      grouped=grouped, tri=tri)
    pairs, blocks = fused_agg._square_blocks(table3, grouped, tri)
    pm, pn = torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1])
    z_r = ar[..., pm] * ar[..., pn] - ai[..., pm] * ai[..., pn]
    z_i = ar[..., pm] * ai[..., pn] + ai[..., pm] * ar[..., pn]
    out_r, out_i = _csc_contract(z_r, z_i, blocks)
    np.testing.assert_allclose(out_r.numpy(), ref_r.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out_i.numpy(), ref_i.numpy(), rtol=RTOL, atol=ATOL)
