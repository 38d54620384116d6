"""The backward of the port's fused CG aggregate and CG square against
molgym_tpu's custom VJPs (jax.vjp of the Pallas functions in interpret
mode), on both of the JAX aggregate's strategies (grouped, B = 4; the row
fallback, B = 3) and all three square table modes (dense, grouped, tri).

The plain backward versions are also held against torch.autograd through
the plain forward versions, and the tables the CUDA backward kernels read
(compressed sparse rows, the square's dense incidence table) are held
against the dense tables by running the kernels' loops in PyTorch and numpy.
The kernels themselves are compared with the plain versions on the card
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
    """The square's backward kernel tables, contracted in PyTorch: dz from
    the CSR rows, then for each slot m the (pair, other slot) entries of its
    line of the dense incidence table."""
    a, grads, table3, grouped, tri = _square_case(mode, 4, tcg, seed=2)
    a_r, a_i, g_r, g_i = (torch.from_numpy(x) for x in (*a, *grads))
    ref_r, ref_i = fused_agg.cg_square_fused_ri_bwd_plain(
        a_r, a_i, g_r, g_i, table3, grouped=grouped, tri=tri)
    pairs, blocks = fused_agg._square_blocks(table3, grouped, tri)
    csr = fused_agg.sparse_rows(blocks, pairs.shape[0])
    dz_r, dz_i = _rows_contract(g_r, *csr), _rows_contract(g_i, *csr)
    inc_pair, inc_other = fused_agg.incidence_lines(pairs, table3.shape[0])
    assert inc_pair.size == 2 * len(pairs) and (inc_pair >= 0).all()
    slot = torch.arange(inc_pair.shape[0]).repeat_interleave(inc_pair.shape[1])
    p = torch.from_numpy(inc_pair.ravel())
    o = torch.from_numpy(inc_other.ravel())
    zr, zi, ar, ai = dz_r[..., p], dz_i[..., p], a_r[..., o], a_i[..., o]
    da_r = torch.zeros_like(a_r).index_add_(-1, slot, zr * ar + zi * ai)
    da_i = torch.zeros_like(a_i).index_add_(-1, slot, zi * ar - zr * ai)
    torch.testing.assert_close(da_r, ref_r, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(da_i, ref_i, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('mode', ['dense', 'grouped', 'tri'])
@pytest.mark.parametrize('maxl', [2, 3, 4])
def test_incidence_lines_are_dense_and_ordered(mode, maxl):
    """Every slot's line is M + 1 (tri) or 2 M (all pairs) long and lists
    exactly the pairs that hold the slot, each with its other slot; the
    first M steps name the same other slot on every line (so that the
    threads of one step of da read the same a), the rest the second
    listings."""
    _a, _g, table3, grouped, tri = _square_case(mode, maxl, tcg, seed=0)
    pairs, _blocks = fused_agg._square_blocks(table3, grouped, tri)
    m = table3.shape[0]
    inc_pair, inc_other = fused_agg.incidence_lines(pairs, m)
    assert inc_pair.shape == (m, m + 1 if mode == 'tri' else 2 * m)
    for s in range(m):
        listed = sorted(zip(inc_pair[s].tolist(), inc_other[s].tolist()))
        held = sorted([(p, int(n)) for p, (mm, n) in enumerate(pairs) if mm == s] +
                      [(p, int(mm)) for p, (mm, n) in enumerate(pairs) if n == s])
        assert listed == held
    np.testing.assert_array_equal(inc_other[:, :m],
                                  np.broadcast_to(np.arange(m), (m, m)))
    if mode == 'tri':      # the diagonal pair's second listing
        np.testing.assert_array_equal(inc_other[:, m], np.arange(m))


def _walk_square_backward(a_r, a_i, g_r, g_i, tabs, rows, n_blocks):
    """The backward kernel's loops in numpy (f32): persistent blocks over
    tiles of `rows` rows, dz of the live pairs at their rank from the packed
    rows sorted by length, the slot of zeros, then da per (row, m) over the
    line of the dense incidence table in its order."""
    n_rows, m = a_r.shape
    grp_ptr, ent, inc = tabs['bwd_ptr'], tabs['bwd_ent'], tabs['inc']
    coef = ent[:, 1].copy().view(np.float32)
    n_groups = len(grp_ptr) - 1
    zero = 32 * n_groups
    a = (a_r + 1j * a_i).astype(np.complex64)
    g = (g_r + 1j * g_i).astype(np.complex64)
    da = np.full((2, n_rows, m), np.nan, np.float32)
    n_tiles = -(-n_rows // rows)
    for block in range(min(n_blocks, n_tiles)):
        dz = np.full((zero + 1, rows), np.nan, np.complex64)
        dz[zero] = 0
        for tile in range(block, n_tiles, n_blocks):
            row0 = tile * rows
            nr = min(rows, n_rows - row0)
            sg = np.full((rows, g.shape[1]), np.nan, np.complex64)
            sg[:nr] = g[row0:row0 + nr]
            for grp in range(n_groups):       # a lane per live pair
                acc = np.zeros((32, rows), np.complex64)
                for step in range((grp_ptr[grp + 1] - grp_ptr[grp]) // 32):
                    at = grp_ptr[grp] + 32 * step + np.arange(32)
                    acc += coef[at][:, None] * sg[:, ent[at, 0]].T
                dz[32 * grp:32 * grp + 32] = acc
            for slot in range(m):             # a thread per (row, m)
                for r in range(nr):
                    acc_r, acc_i = np.float32(0), np.float32(0)
                    for v in inc[slot]:
                        z, x = dz[v >> 8, r], a[row0 + r, v & 255]
                        acc_r = np.float32(z.real * x.real + np.float32(
                            z.imag * x.imag + acc_r))
                        acc_i = np.float32(z.imag * x.real + np.float32(
                            -z.real * x.imag + acc_i))
                    da[:, row0 + r, slot] = acc_r, acc_i
    return da


@pytest.mark.parametrize('mode,maxl,n_rows,n_blocks', [
    ('tri', 4, 9, 2),            # SF6, a short last tile
    ('tri', 4, 5, 3),
    ('tri', 3, 11, 1),           # stochastic, one block over every tile
    ('tri', 3, 6, 2),
    ('tri', 2, 1, 2),            # more blocks than tiles, a short tile
    ('dense', 4, 5, 2),
    ('grouped', 3, 6, 1),
    ('dense', 2, 3, 1)])
def test_square_bwd_kernel_walk_matches_plain(mode, maxl, n_rows, n_blocks):
    _a, _g, table3, grouped, tri = _square_case(mode, maxl, tcg, seed=0)
    pairs, blocks = fused_agg._square_blocks(table3, grouped, tri)
    tabs = fused_agg.square_tables(pairs, blocks, table3.shape[0])
    rng = np.random.RandomState(n_rows + n_blocks)
    a_r, a_i = rng.randn(2, n_rows, table3.shape[0]).astype(np.float32)
    g_r, g_i = rng.randn(2, n_rows, tabs['k']).astype(np.float32)
    rows = fused_agg.SQUARE_BWD_ROWS
    ref = fused_agg.cg_square_fused_ri_bwd_plain(
        *map(torch.from_numpy, (a_r, a_i, g_r, g_i)), table3, grouped=grouped,
        tri=tri)
    got = _walk_square_backward(a_r, a_i, g_r, g_i, tabs, rows, n_blocks)
    again = _walk_square_backward(a_r, a_i, g_r, g_i, tabs, rows, n_blocks)
    np.testing.assert_array_equal(got, again)      # a fixed order of sums
    for mine, plain in zip(got, ref):
        assert np.isfinite(mine).all()
        scale = float(plain.abs().max())
        np.testing.assert_allclose(mine, plain.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)


def test_square_bwd_tables_skip_the_empty_pairs():
    """Only pairs with entries get lanes; the incidence table sends the
    empty ones to the slot of zeros past the last group (38 of 325 at SF6,
    24 of 136 at the stochastic shapes)."""
    for maxl, n_empty in ((4, 38), (3, 24)):
        _a, _g, table3, grouped, tri = _square_case('tri', maxl, tcg, seed=0)
        pairs, blocks = fused_agg._square_blocks(table3, grouped, tri)
        tabs = fused_agg.square_tables(pairs, blocks, table3.shape[0])
        zero = 32 * (len(tabs['bwd_ptr']) - 1)
        assert tabs['n_live'] == len(pairs) - n_empty
        dz_slot = tabs['inc'] >> 8
        assert (dz_slot == zero).sum() == 2 * n_empty
        live = dz_slot[dz_slot != zero]
        assert len(np.unique(live)) == tabs['n_live'] and live.max() < zero
        # no group of the packed rows is empty
        assert (np.diff(tabs['bwd_ptr']) > 0).all()


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


# ---------------------------------------------------------------------------
# the aggregate's backward kernel (csrc/cg_aggregate_bwd.cu) walked in numpy
# as it runs: one block per (b, t), rows i in steps, dz from the packed rows
# sorted by length into rows padded to the plan's stride, dq and de from
# strided strips and chunks added by a fixed xor tree. 1e-5 relative, f32.
# ---------------------------------------------------------------------------

PLAN_CASES = [  # N, n_l, m1, m2, k, groups, n_ent
    (7, 5, 25, 25, 375, 20, 1472), (7, 5, 25, 1, 25, 1, 32),
    (10, 4, 16, 16, 156, 8, 544), (10, 4, 16, 1, 16, 1, 32),
    (3, 3, 9, 9, 51, 3, 192), (3, 5, 25, 9, 165, 8, 480), (1, 3, 9, 1, 9, 1, 32)]


@pytest.mark.parametrize('case', PLAN_CASES)
def test_backward_plan_covers_every_output_once(case):
    N, n_l, m1, m2 = case[:4]
    plan = fused_agg.aggregate_bwd_plan(*case)
    threads = fused_agg.BWD_THREADS
    ns, ms, mc, nc = plan['ns'], plan['ms'], plan['mc'], plan['nc']
    assert m2 % ns == 0 and m1 % ms == 0
    for lanes, length, chunk in ((mc, m1, plan['m_chunk']),
                                 (nc, m2, plan['n_chunk'])):
        assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
        assert lanes * chunk >= length          # the chunks cover the axis
    assert N * (m2 // ns) * mc <= threads and N * (m1 // ms) * nc <= threads
    assert 1 <= plan['rows'] <= N and m2 <= plan['m2_stride'] <= m2 + 8
    smem = fused_agg.aggregate_bwd_smem(*case, plan['rows'], plan['m2_stride'])
    assert plan['rows'] == 1 or smem <= fused_agg.BWD_SMEM_TARGET
    # the stride is no worse than unpadded rows
    roles = {k: plan[k] for k in ('ns', 'ms', 'mc', 'm_chunk', 'nc', 'n_chunk')}
    assert (fused_agg.dz_conflicts(N, m1, m2, plan['m2_stride'], threads, **roles)
            <= fused_agg.dz_conflicts(N, m1, m2, m2, threads, **roles))


def test_backward_plan_choices_at_the_main_shapes():
    sf6 = fused_agg.aggregate_bwd_plan(7, 5, 25, 25, 375, 20, 1472)
    assert (sf6['rows'], sf6['ns'], sf6['ms'], sf6['mc'], sf6['nc']) == (1, 5, 5, 4, 4)
    # level 0 (M2 = 1): all rows at once, 16 lanes on each of the N outputs
    for case in ((7, 5, 25, 1, 25, 1, 32), (10, 4, 16, 1, 16, 1, 32)):
        plan = fused_agg.aggregate_bwd_plan(*case)
        assert plan['rows'] == case[0] and plan['mc'] == 16 and plan['nc'] == 1
    # every load of dz at M = 16 is free of bank conflicts with 17-slot rows
    stoch = fused_agg.aggregate_bwd_plan(10, 4, 16, 16, 156, 8, 544)
    assert stoch['m2_stride'] == 17
    roles = {k: stoch[k] for k in ('ns', 'ms', 'mc', 'm_chunk', 'nc', 'n_chunk')}
    assert fused_agg.dz_conflicts(10, 16, 16, 17, 192, **roles) == 20
    assert fused_agg.dz_conflicts(10, 16, 16, 16, 192, **roles) == 80
    with pytest.raises(ValueError, match='more than 192 outputs'):
        fused_agg.aggregate_bwd_plan(64, 5, 25, 25, 375, 20, 1472)


def _xor_tree(partials):
    """Sum over the last axis (a power of two of lanes) as the kernel's
    __shfl_xor tree does; every lane ends with the total."""
    lanes = partials.shape[-1]
    off = 1
    while off < lanes:
        partials = partials + partials[..., np.arange(lanes) ^ off]
        off <<= 1
    return partials[..., 0]


def _walk_backward(sph, rad, q_r, q_i, g_r, g_i, table3, grouped, rows=None):
    B, N, _, tau, n_l = rad.shape
    m1, m2 = sph.shape[-2], q_r.shape[-1]
    blocks = fused_agg._aggregate_blocks(table3, grouped)
    rowptr, col, coef_t = fused_agg.sparse_rows(blocks, m1 * m2)
    grp_ptr, line_of, ent = fused_agg.warp_padded(rowptr, col, coef_t,
                                                  by_length=True)
    packed = fused_agg.pack_pairs(line_of, m2)
    coef = ent[:, 1].copy().view(np.float32)
    k = g_r.shape[-1]
    plan = fused_agg.aggregate_bwd_plan(N, n_l, m1, m2, k, len(grp_ptr) - 1,
                                        len(ent))
    rows = rows or plan['rows']
    ns, ms, mc, nc = plan['ns'], plan['ms'], plan['mc'], plan['nc']
    m_chunk, n_chunk, stride = plan['m_chunk'], plan['n_chunk'], plan['m2_stride']
    sq, se = m2 // ns, m1 // ms
    l_of_m = np.array([l for l in range(n_l) for _ in range(2 * l + 1)])
    drad = np.full(rad.shape, np.nan, np.float32)
    dq = np.full((B, N, tau, m2), np.nan, np.complex64)
    g = (g_r + 1j * g_i).astype(np.complex64)
    for b in range(B):
        for t in range(tau):
            q = (q_r[b, :, t] + 1j * q_i[b, :, t]).astype(np.complex64)  # [N, M2]
            acc = np.zeros((N, sq, ns, mc), np.complex64)     # dq in registers
            for i0 in range(0, N, rows):
                for i in range(i0, min(i0 + rows, N)):
                    dz = np.full((m1, stride), np.nan, np.complex64)
                    for grp in range(len(grp_ptr) - 1):
                        trips = (grp_ptr[grp + 1] - grp_ptr[grp]) // 32
                        a = np.zeros(32, np.complex64)
                        for step in range(trips):
                            at = grp_ptr[grp] + 32 * step + np.arange(32)
                            a += coef[at] * g[b, i, t, ent[at, 0]]
                        mn = packed[32 * grp:32 * grp + 32]
                        on = mn >= 0
                        dz[mn[on] >> 16, mn[on] & 0xffff] = a[on]
                    assert np.isfinite(dz[:, :m2]).all()      # every pair written
                    y = sph[b, i, :, :, 0] + 1j * sph[b, i, :, :, 1]       # [N, M1]
                    e = (rad[b, i, :, t][:, l_of_m] * y).astype(np.complex64)
                    for j in range(N):
                        for s in range(sq):                   # dq: strided strip
                            n_of = s + sq * np.arange(ns)
                            for c in range(mc):
                                for m in range(min(c * m_chunk, m1),
                                               min((c + 1) * m_chunk, m1)):
                                    acc[j, s, :, c] += dz[m, n_of] * np.conj(e[j, m])
                        term = np.zeros(m1, np.float32)
                        for s in range(se):                   # de: strided strip
                            m_of = s + se * np.arange(ms)
                            part = np.zeros((ms, nc), np.complex64)
                            for c in range(nc):
                                for n in range(min(c * n_chunk, m2),
                                               min((c + 1) * n_chunk, m2)):
                                    part[:, c] += dz[m_of, n] * np.conj(q[j, n])
                            de = _xor_tree(part)
                            term[m_of] = (de * np.conj(y[j, m_of])).real
                        for l in range(n_l):
                            total = np.float32(0)
                            for m in range(l * l, (l + 1) * (l + 1)):
                                total += term[m]
                            drad[b, i, j, t, l] = total
            summed = _xor_tree(acc)                           # [N, sq, ns]
            for s in range(sq):
                dq[b, :, t, s + sq * np.arange(ns)] = summed[:, s].T
    return drad, dq.real, dq.imag


@pytest.mark.parametrize('maxl,atom_n_ells,N,tau,rows,use_grouped', [
    (4, 5, 7, 2, None, True),     # SF6 levels 1-2: one row a step
    (4, 5, 7, 1, 3, False),       # dense table, steps of 3, 3 and 1 rows
    (4, 1, 7, 3, None, False),    # SF6 level 0 (M2 = 1): all rows at once
    (3, 4, 10, 2, None, False),   # stochastic level 1: padded dz rows
    (3, 1, 10, 2, None, False),   # stochastic level 0
    (2, 3, 3, 5, 2, False),       # strips of 3, chunks of 2
    (4, 3, 3, 2, None, True)])    # atom rep narrower than the harmonics
def test_aggregate_bwd_kernel_walk_matches_plain(maxl, atom_n_ells, N, tau,
                                                 rows, use_grouped):
    arrays, grads, table3, grouped = _agg_case(1, N, tau, maxl, atom_n_ells,
                                               N + tau, tcg)
    grouped = grouped if use_grouped else None
    a = [arrays[k] for k in ('sph', 'rad', 'ar', 'ai')]
    if grouped is None:
        k = table3.shape[-1]
    else:
        k = sum(t.shape[1] for t in grouped[0])
    assert grads.shape[-1] == k
    ref = fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(
        *map(torch.from_numpy, a), *map(torch.from_numpy, grads), table3,
        grouped=grouped)
    got = _walk_backward(*a, grads[0], grads[1], table3, grouped, rows)
    again = _walk_backward(*a, grads[0], grads[1], table3, grouped, rows)
    for mine, twice, plain in zip(got, again, ref):
        assert np.isfinite(mine).all()
        np.testing.assert_array_equal(mine, twice)    # a fixed order of sums
        scale = float(plain.abs().max())
        np.testing.assert_allclose(mine, plain.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# the backwards' staging of g and Y (csrc/cg_aggregate_bwd.cu and
# csrc/cg_square_bwd.cu, `stage_row`), walked in numpy for both operand
# types: f32 rows by 16-byte copies from the line that holds their first
# value (the row lies `lead` floats into its buffer), bf16 rows converted
# value by value to the buffer's start. Rows of odd width start on any
# 4-byte (f32) or 2-byte (bf16) boundary.
# ---------------------------------------------------------------------------

def _stage_row(flat, off, n, elem_bytes, buf_len):
    """One row of n values at element `off` of `flat` (an allocation that
    starts on a 256-byte boundary, as the caching allocator's do) staged into
    a buffer of `buf_len` floats; returns (buffer, lead). Asserts that every
    write stays in the buffer and every read inside the 16-byte lines that
    hold the tensor's values."""
    buf = np.full(buf_len, np.nan, np.float32)
    if elem_bytes == 2:
        lead = 0
        for c in range(n):
            buf[c] = flat[off + c]
        return buf, lead
    lead = (off * 4 % 16) // 4
    line_end = -(-len(flat) // 4) * 4    # the last line that holds a value
    c = 0
    while 4 * c < lead + n:
        src = off - lead + 4 * c
        assert 0 <= src and src + 4 <= line_end
        assert 4 * c + 4 <= buf_len
        padded = np.concatenate([flat, np.zeros(4, np.float32)])
        buf[4 * c:4 * c + 4] = padded[src:src + 4]
        c += 1
    return buf, lead


@pytest.mark.parametrize('elem_bytes', [4, 2], ids=['f32', 'bf16'])
@pytest.mark.parametrize('N,n_l,m2,k,tau', [
    (7, 5, 25, 375, 10),     # SF6 levels 1-2
    (7, 5, 1, 25, 3),        # SF6 level 0, odd channels
    (10, 4, 16, 156, 7),     # stochastic level 1
    (10, 4, 1, 16, 10),      # stochastic level 0
    (3, 3, 9, 51, 5)])       # maxl 2: odd widths everywhere
def test_staged_rows_land_where_the_kernels_read_them(elem_bytes, N, n_l, m2,
                                                      k, tau):
    """Every row of g and every run of Y rows a backward block stages, at
    storage offsets that put f32 rows on each 4-byte and bf16 rows on each
    2-byte position of a 16-byte line, reads back equal at its lead and fits
    the buffers the host sizes (aggregate_bwd_smem, square_bwd_smem)."""
    m1 = n_l * n_l
    kp = fused_agg._padded_row(k)
    plan = fused_agg.aggregate_bwd_plan(N, n_l, m1, m2, k, 1, 32)
    ni = plan['rows']
    rng = np.random.RandomState(k + tau)
    B = 2
    for shift in range(4):
        g = rng.randn(B * N * tau * k + shift).astype(np.float32)
        for row in range(B * N * tau):         # (b, i, t): one row of g
            off = shift + row * k
            buf, lead = _stage_row(g, off, k, elem_bytes, kp)
            np.testing.assert_array_equal(buf[lead:lead + k], g[off:off + k])
        if elem_bytes == 4 and shift % 2:
            continue        # f32 harmonics are pairs, 8-byte aligned
        nm = N * m1
        y = rng.randn(B * N * nm * 2 + shift).astype(np.float32)
        y_len = 2 * (ni * nm + 2)                # float2s with their slack
        for b in range(B):
            for i0 in range(0, N, ni):
                n = 2 * min(ni, N - i0) * nm
                off = shift + (b * N + i0) * nm * 2
                buf, lead = _stage_row(y, off, n, elem_bytes, y_len)
                assert lead % 2 == 0                 # whole pairs
                np.testing.assert_array_equal(buf[lead:lead + n],
                                              y[off:off + n])
