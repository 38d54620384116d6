"""The backward of the port's fused CG aggregate and CG square against
molgym_tpu's custom VJPs (jax.vjp of the Pallas functions in interpret
mode), on both of the JAX aggregate's strategies (grouped, B = 4; the row
fallback, B = 3) and all three square table modes (dense, grouped, tri).

The plain backward versions are also held against torch.autograd through
the plain forward versions, and the tables the CUDA backward kernels read
(compressed sparse rows, the square's pair incidence) are held against the
dense tables by running the kernels' loops in PyTorch. The kernels
themselves are compared with the plain versions on the card
(tests/test_torch_kernels.py and chip_smoke.py).

Tolerance: 1e-5 relative, 2e-5 absolute on O(1) random inputs, float32 with
a different summation order (as for the forward tests)."""
import jax
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
AGG_CONFIGS = [(2, 1), (2, 3), (4, 1), (4, 3), (4, 5)]


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)


def _agg_case(B, N, tau, maxl, atom_n_ells, seed, lib):
    rng = np.random.RandomState(seed)
    n_ells = maxl + 1
    m1, m2 = n_ells ** 2, atom_n_ells ** 2
    arrays = dict(sph=rng.randn(B, N, N, m1, 2), rad=rng.randn(B, N, N, tau, n_ells),
                  ar=rng.randn(B, N, tau, m2), ai=rng.randn(B, N, tau, m2))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    table3, _sl = lib._fused_cg_table(n_ells, atom_n_ells, maxl)
    g = lib.fused_cg_table_grouped(n_ells, atom_n_ells, maxl)
    k = table3.shape[-1]
    grads = rng.randn(2, B, N, tau, k).astype(np.float32)
    return arrays, grads, table3, None if g is None else (g[0], g[1])


def _square_case(mode, maxl, lib, seed):
    rng = np.random.RandomState(seed)
    n_ells = maxl + 1
    m = n_ells ** 2
    table3, _sl = lib._fused_cg_table(n_ells, n_ells, maxl)
    grouped = tri = None
    if mode == 'grouped':
        g = lib.fused_cg_table_grouped(n_ells, n_ells, maxl)
        grouped = None if g is None else (g[0], g[1])
    elif mode == 'tri':
        pairs, groups, _perm, _si = lib.fused_cg_table_tri(n_ells, maxl)
        tri = (pairs, groups)
    a = rng.randn(2, 2, 3, 4, m).astype(np.float32)
    grads = rng.randn(2, 2, 3, 4, table3.shape[-1]).astype(np.float32)
    return a, grads, table3, grouped, tri


@pytest.mark.parametrize('maxl,atom_n_ells', AGG_CONFIGS)
@pytest.mark.parametrize('B,path', [(4, 'grouped'), (3, 'fallback')])
def test_aggregate_bwd_plain_matches_pallas_vjp(B, path, maxl, atom_n_ells):
    N, tau = 3, 2
    assert (pallas_agg._grouped_tile(B, N, tau) is not None) == (path == 'grouped')
    arrays, grads, jtable, jgrouped = _agg_case(B, N, tau, maxl, atom_n_ells,
                                                maxl + atom_n_ells, jcg)
    sph = jnp.asarray(arrays['sph'])

    def fn(rad, ar, ai):
        return pallas_agg.cg_aggregate_edge_fused_ri(
            sph, rad, ar, ai, jtable, interpret=True, grouped=jgrouped)

    _out, vjp = jax.vjp(fn, *(jnp.asarray(arrays[k]) for k in ('rad', 'ar', 'ai')))
    jrad, jar, jai = vjp((jnp.asarray(grads[0]), jnp.asarray(grads[1])))

    _t, _a, ttable, tgrouped = _agg_case(B, N, tau, maxl, atom_n_ells, 0, tcg)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    trad, tar, tai = fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(
        t['sph'], t['rad'], t['ar'], t['ai'], *map(torch.from_numpy, grads),
        ttable, grouped=tgrouped)
    for tt, jj in ((trad, jrad), (tar, jar), (tai, jai)):
        _close(tt, jj)


@pytest.mark.parametrize('mode', ['dense', 'grouped', 'tri'])
@pytest.mark.parametrize('maxl', [2, 4])
def test_square_bwd_plain_matches_pallas_vjp(mode, maxl):
    a, grads, jtable, jg, jtri = _square_case(mode, maxl, jcg, seed=3 + maxl)

    def fn(ar, ai):
        return pallas_agg.cg_square_fused_ri(ar, ai, jtable, grouped=jg,
                                             tri=jtri, interpret=True)

    _out, vjp = jax.vjp(fn, jnp.asarray(a[0]), jnp.asarray(a[1]))
    jar, jai = vjp((jnp.asarray(grads[0]), jnp.asarray(grads[1])))
    _a, _g, ttable, tg, ttri = _square_case(mode, maxl, tcg, seed=0)
    tar, tai = fused_agg.cg_square_fused_ri_bwd_plain(
        *map(torch.from_numpy, a), *map(torch.from_numpy, grads), ttable,
        grouped=tg, tri=ttri)
    _close(tar, jar)
    _close(tai, jai)


@pytest.mark.parametrize('maxl,atom_n_ells', [(2, 3), (4, 5)])
def test_aggregate_bwd_plain_matches_autograd(maxl, atom_n_ells):
    """Through the public wrapper on CPU tensors (the plain forward, which
    autograd differentiates); the spherical harmonics get no gradient."""
    arrays, grads, table3, grouped = _agg_case(2, 3, 2, maxl, atom_n_ells, 5, tcg)
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in arrays.items()}
    out = fused_agg.cg_aggregate_edge_fused_ri(t['sph'], t['rad'], t['ar'],
                                               t['ai'], table3, grouped=grouped)
    g = tuple(map(torch.from_numpy, grads))
    auto = torch.autograd.grad(out, (t['rad'], t['ar'], t['ai']), g,
                               retain_graph=True)
    plain = fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(
        *(t[k].detach() for k in ('sph', 'rad', 'ar', 'ai')), *g, table3,
        grouped=grouped)
    for a, p in zip(auto, plain):
        torch.testing.assert_close(p, a, rtol=RTOL, atol=ATOL)
    (out[0].sum() + out[1].sum()).backward()
    assert t['sph'].grad is None


@pytest.mark.parametrize('mode', ['dense', 'grouped', 'tri'])
def test_square_bwd_plain_matches_autograd(mode):
    a, grads, table3, grouped, tri = _square_case(mode, 4, tcg, seed=8)
    a_r, a_i = (torch.from_numpy(x).requires_grad_() for x in a)
    out = fused_agg.cg_square_fused_ri(a_r, a_i, table3, grouped=grouped,
                                       tri=tri)
    g = tuple(map(torch.from_numpy, grads))
    auto = torch.autograd.grad(out, (a_r, a_i), g)
    plain = fused_agg.cg_square_fused_ri_bwd_plain(
        a_r.detach(), a_i.detach(), *g, table3, grouped=grouped, tri=tri)
    for x, p in zip(auto, plain):
        torch.testing.assert_close(p, x, rtol=RTOL, atol=ATOL)


def _dense(blocks, n_rows):
    """[P, K] table from the blocks: what sparse_rows must transpose."""
    k = sum(t.shape[1] for _a, _b, t in blocks)
    out = np.zeros((n_rows, k), np.float32)
    ka = 0
    for a, b, t in blocks:
        out[a:b, ka:ka + t.shape[1]] += t
        ka += t.shape[1]
    return out


def _table_cases():
    out = []
    for maxl, n in ((2, 3), (4, 1), (4, 5)):
        table3, grouped = (tcg._fused_cg_table(maxl + 1, n, maxl)[0],
                           tcg.fused_cg_table_grouped(maxl + 1, n, maxl))
        for g in (None, grouped):
            if g is not None or n == 5:
                out.append((fused_agg._aggregate_blocks(
                    table3, None if g is None else (g[0], g[1])),
                    table3.shape[0] * table3.shape[1]))
    for mode in ('dense', 'grouped', 'tri'):
        _a, _g, table3, grouped, tri = _square_case(mode, 4, tcg, seed=0)
        pairs, blocks = fused_agg._square_blocks(table3, grouped, tri)
        out.append((blocks, pairs.shape[0]))
    return out


@pytest.mark.parametrize('case', range(len(_table_cases())))
def test_sparse_rows_is_the_dense_transpose(case):
    blocks, n_rows = _table_cases()[case]
    dense = _dense(blocks, n_rows)
    rowptr, col, coef = fused_agg.sparse_rows(blocks, n_rows)
    assert rowptr.shape == (n_rows + 1, ) and rowptr[-1] == len(col)
    rebuilt = np.zeros_like(dense)
    for p in range(n_rows):
        for e in range(rowptr[p], rowptr[p + 1]):
            rebuilt[p, col[e]] += coef[e]
    np.testing.assert_array_equal(rebuilt, dense)
    # the forward's columns describe the same table
    colptr, pair, coef_c = fused_agg.sparse_columns(blocks)
    by_cols = np.zeros_like(dense)
    for k in range(len(colptr) - 1):
        by_cols[pair[colptr[k]:colptr[k + 1]], k] += coef_c[colptr[k]:colptr[k + 1]]
    np.testing.assert_array_equal(by_cols, dense)


def _rows_contract(g, rowptr, col, coef):
    """The backward kernels' first phase: dz[..., p] over the CSR rows."""
    row = torch.from_numpy(np.repeat(np.arange(len(rowptr) - 1), np.diff(rowptr)))
    dz = g.new_zeros(g.shape[:-1] + (len(rowptr) - 1, ))
    return dz.index_add_(-1, row, g[..., torch.from_numpy(col).long()] *
                         torch.from_numpy(coef))


@pytest.mark.parametrize('mode', ['dense', 'grouped', 'tri'])
def test_square_bwd_kernel_tables_match_plain(mode):
    """The square's backward kernel loop, run in PyTorch: dz from the CSR
    rows, then for each slot m the pairs of its incidence list."""
    a, grads, table3, grouped, tri = _square_case(mode, 4, tcg, seed=2)
    a_r, a_i, g_r, g_i = (torch.from_numpy(x) for x in (*a, *grads))
    ref_r, ref_i = fused_agg.cg_square_fused_ri_bwd_plain(
        a_r, a_i, g_r, g_i, table3, grouped=grouped, tri=tri)
    pairs, blocks = fused_agg._square_blocks(table3, grouped, tri)
    csr = fused_agg.sparse_rows(blocks, pairs.shape[0])
    dz_r, dz_i = _rows_contract(g_r, *csr), _rows_contract(g_i, *csr)
    mptr, inc_pair, inc_other = fused_agg.pair_incidence(pairs, table3.shape[0])
    assert len(inc_pair) == 2 * len(pairs)
    slot = torch.from_numpy(np.repeat(np.arange(len(mptr) - 1), np.diff(mptr)))
    p, o = torch.from_numpy(inc_pair).long(), torch.from_numpy(inc_other).long()
    zr, zi, ar, ai = dz_r[..., p], dz_i[..., p], a_r[..., o], a_i[..., o]
    da_r = torch.zeros_like(a_r).index_add_(-1, slot, zr * ar + zi * ai)
    da_i = torch.zeros_like(a_i).index_add_(-1, slot, zi * ar - zr * ai)
    torch.testing.assert_close(da_r, ref_r, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(da_i, ref_i, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('maxl,atom_n_ells', [(2, 3), (4, 1), (4, 5)])
def test_aggregate_bwd_kernel_tables_match_plain(maxl, atom_n_ells):
    """The aggregate's backward kernel loop, run in PyTorch: dz from the
    CSR rows, then de, drad and dq per (b, t) block as the kernel forms
    them."""
    arrays, grads, table3, grouped = _agg_case(2, 3, 2, maxl, atom_n_ells, 9, tcg)
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    g_r, g_i = map(torch.from_numpy, grads)
    ref = fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(
        t['sph'], t['rad'], t['ar'], t['ai'], g_r, g_i, table3,
        grouped=grouped)
    m1, m2 = t['sph'].shape[-2], t['ar'].shape[-1]
    csr = fused_agg.sparse_rows(fused_agg._aggregate_blocks(table3, grouped),
                                m1 * m2)
    dz_r = _rows_contract(g_r, *csr).unflatten(-1, (m1, m2))   # [b,i,t,m,n]
    dz_i = _rows_contract(g_i, *csr).unflatten(-1, (m1, m2))
    l_of_m = torch.tensor([l for l in range(maxl + 1) for _ in range(2 * l + 1)])
    y_r, y_i = t['sph'][..., 0], t['sph'][..., 1]                # [b,i,j,m]
    rad_m = t['rad'][..., l_of_m]                                # [b,i,j,t,m]
    e_r = rad_m * y_r[:, :, :, None]
    e_i = rad_m * y_i[:, :, :, None]
    qr, qi = t['ar'], t['ai']                                    # [b,j,t,n]
    de_r = (dz_r[:, :, None] * qr[:, None, :, :, None] +
            dz_i[:, :, None] * qi[:, None, :, :, None]).sum(-1)
    de_i = (dz_i[:, :, None] * qr[:, None, :, :, None] -
            dz_r[:, :, None] * qi[:, None, :, :, None]).sum(-1)
    term = de_r * y_r[:, :, :, None] + de_i * y_i[:, :, :, None]
    drad = torch.stack([term[..., l * l:(l + 1) * (l + 1)].sum(-1)
                        for l in range(maxl + 1)], dim=-1)
    dq_r = (dz_r[:, :, None] * e_r[..., None] +
            dz_i[:, :, None] * e_i[..., None]).sum((1, 4))
    dq_i = (dz_i[:, :, None] * e_r[..., None] -
            dz_r[:, :, None] * e_i[..., None]).sum((1, 4))
    for mine, plain in zip((drad, dq_r, dq_i), ref):
        torch.testing.assert_close(mine, plain, rtol=RTOL, atol=ATOL)
