"""The port's fused CG aggregate and CG square against molgym_tpu's Pallas
kernels (run in interpret mode, as the JAX package's own tests run them on
the CPU), on both of the JAX aggregate's strategies: grouped (B % 4 == 0
here) and the row fallback (B % 4 != 0).

Tolerance: 1e-5 relative, 2e-5 absolute on O(1) random inputs, float32 with
a different summation order. The sparse-column tables the CUDA kernels read
are held against the plain version here by contracting them in PyTorch; the
kernels themselves are compared with the plain version on the card
(tests/test_torch_kernels.py and chip_smoke.py)."""
from collections import Counter

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


# ---------------------------------------------------------------------------
# the aggregate kernel's host tables and tiling, walked here as the kernel
# (csrc/cg_aggregate.cu) walks them: persistent blocks over (b, i, tile of
# channels), z from pairs of m and strips of n, the warp-padded packed table
# with one entry read for two channels. 1e-5 relative, f32.
# ---------------------------------------------------------------------------

def _padded_dense(grp_ptr, line_of, ent, n_lines, n_idx):
    """[n_idx, n_lines] table rebuilt from a warp-padded one, read group by
    group and step by step as a warp reads it."""
    dense = np.zeros((n_idx, n_lines), np.float32)
    assert len(ent) == grp_ptr[-1] and len(ent) % 32 == 0
    for g in range(len(grp_ptr) - 1):
        trips = (grp_ptr[g + 1] - grp_ptr[g]) // 32
        for e in range(trips):
            for lane in range(32):
                idx, bits = ent[grp_ptr[g] + 32 * e + lane]
                coef = np.int32(bits).view(np.float32)
                line = line_of[32 * g + lane]
                if line < 0:
                    assert coef == 0.0
                else:
                    dense[idx, line] += coef
    return dense


@pytest.mark.parametrize('by_length', [False, True], ids=['in_order', 'sorted'])
@pytest.mark.parametrize('maxl,atom_n_ells,use_grouped',
                         [(4, 5, True), (4, 5, False), (4, 1, False),
                          (3, 4, False), (3, 1, False), (2, 3, False)])
def test_warp_padded_table_is_the_sparse_table(maxl, atom_n_ells, use_grouped,
                                               by_length):
    table3, grouped = _agg_tables(maxl, atom_n_ells, tcg)
    blocks = fused_agg._aggregate_blocks(table3, grouped if use_grouped else None)
    colptr, pair, coef = fused_agg.sparse_columns(blocks)
    k, p = len(colptr) - 1, table3.shape[0] * table3.shape[1]
    ref = np.zeros((p, k), np.float32)
    for col in range(k):
        ref[pair[colptr[col]:colptr[col + 1]], col] = coef[colptr[col]:colptr[col + 1]]
    grp_ptr, line_of, ent = fused_agg.warp_padded(colptr, pair, coef, by_length)
    assert sorted(line_of[line_of >= 0]) == list(range(k))
    if not by_length:
        np.testing.assert_array_equal(line_of[:k], np.arange(k))
    np.testing.assert_array_equal(_padded_dense(grp_ptr, line_of, ent, k, p), ref)
    # sorted by length, no group is longer than the one before it
    if by_length:
        assert (np.diff(np.diff(grp_ptr)) <= 0).all()


def test_warp_padded_takes_empty_lines_and_a_ragged_last_group():
    # 35 lines: line 3 and the last two are empty, line 0 is the longest
    counts = np.array([4, 1, 2, 0] + [1] * 29 + [0, 0])
    ptr = np.concatenate([[0], np.cumsum(counts)])
    idx = np.arange(ptr[-1]) % 7
    coef = (1.0 + np.arange(ptr[-1])).astype(np.float32)
    ref = np.zeros((7, 35), np.float32)
    for line in range(35):
        ref[idx[ptr[line]:ptr[line + 1]], line] += coef[ptr[line]:ptr[line + 1]]
    for by_length in (False, True):
        grp_ptr, line_of, ent = fused_agg.warp_padded(ptr, idx, coef, by_length)
        assert len(grp_ptr) == 3 and len(line_of) == 64
        assert (line_of[35:] == -1).all()
        np.testing.assert_array_equal(
            _padded_dense(grp_ptr, line_of, ent, 35, 7), ref)
    assert list(np.diff(fused_agg.warp_padded(ptr, idx, coef)[0])) == [128, 32]
    assert list(np.diff(fused_agg.warp_padded(ptr, idx, coef, True)[0])) == [128, 0]
    packed = fused_agg.pack_pairs(np.array([-1, 0, 26, 51]), 25)
    assert packed.tolist() == [-1, 0, (1 << 16) | 1, (2 << 16) | 1]


@pytest.mark.parametrize('B', [1, 10, 140])
@pytest.mark.parametrize('N,m1,m2,groups,n_ent', [
    (7, 25, 25, 12, 2496), (7, 25, 1, 1, 32), (10, 16, 16, 5, 960),
    (10, 16, 1, 1, 32)])
def test_forward_tile_fills_the_card_and_fits(B, N, m1, m2, groups, n_ent):
    tau, sms = 10, 132
    tile = fused_agg.aggregate_fwd_tile(B, N, tau, m1, m2, groups, n_ent, sms)
    assert 1 <= tile <= tau
    smem = fused_agg.aggregate_fwd_smem(N, tile, m1, m2, groups, n_ent)
    assert tile == 1 or smem <= fused_agg.FWD_SMEM_TARGET
    blocks = B * N * -(-tau // tile)
    assert tile == 1 or blocks >= 2 * sms
    # the rollout's batch still gives every SM a block
    if B == 10:
        assert blocks >= sms
    # no larger tile would have done as well
    if tile < tau:
        bigger = tile + 1
        while -(-tau // bigger) == -(-tau // tile) and bigger < tau:
            bigger += 1
        assert (fused_agg.aggregate_fwd_smem(N, bigger, m1, m2, groups, n_ent)
                > fused_agg.FWD_SMEM_TARGET
                or B * N * -(-tau // bigger) < 2 * sms)
    assert fused_agg.strip_of(m2) in (1, 3, 4, 5)
    assert m2 % fused_agg.strip_of(m2) == 0
    assert [fused_agg.strip_of(m) for m in (1, 4, 9, 16, 25, 36, 7)] == [
        1, 1, 3, 4, 5, 1, 1]


def _walk_forward(sph, rad, q_r, q_i, table3, grouped, tile, n_blocks):
    """The forward kernel's loops in numpy (f32)."""
    B, N, _, tau, n_l = rad.shape
    m1, m2 = sph.shape[-2], q_r.shape[-1]
    blocks = fused_agg._aggregate_blocks(table3, grouped)
    grp_ptr, _line, ent = fused_agg.warp_padded(*fused_agg.sparse_columns(blocks))
    k, n_groups = len(fused_agg.sparse_columns(blocks)[0]) - 1, len(grp_ptr) - 1
    coef = ent[:, 1].copy().view(np.float32)
    ns = fused_agg.strip_of(m2)
    l_of_m = np.array([l for l in range(n_l) for _ in range(2 * l + 1)])
    out = np.full((2, B, N, tau, k), np.nan, np.float32)
    n_tiles = -(-tau // tile)
    n_work = B * N * n_tiles
    visited = 0
    for block in range(min(n_blocks, n_work)):          # persistent blocks
        for work in range(block, n_work, n_blocks):
            visited += 1
            bi, t0 = work // n_tiles, (work % n_tiles) * tile
            b, i = bi // N, bi % N
            tn = min(tile, tau - t0)
            y = sph[b, i, :, :, 0] + 1j * sph[b, i, :, :, 1]           # [N, M1]
            e = (rad[b, i, :, t0:t0 + tn][:, :, l_of_m] * y[:, None, :]
                 ).astype(np.complex64)                                # [N, tn, M1]
            q = (q_r[b, :, t0:t0 + tn] + 1j * q_i[b, :, t0:t0 + tn]
                 ).astype(np.complex64)                                # [N, tn, M2]
            z = np.zeros((tn, m1 * m2), np.complex64)
            for tt in range(tn):
                for s in range(m2 // ns):                # strip of n
                    for mp in range((m1 + 1) // 2):      # pair of m
                        for m in range(2 * mp, min(2 * mp + 2, m1)):
                            acc = np.zeros(ns, np.complex64)
                            for j in range(N):
                                acc += e[j, tt, m] * q[j, tt, s * ns:(s + 1) * ns]
                            z[tt, m * m2 + s * ns:m * m2 + (s + 1) * ns] = acc
            for pair in range((tn + 1) // 2):            # two channels an entry
                tts = [tt for tt in (2 * pair, 2 * pair + 1) if tt < tn]
                for g in range(n_groups):
                    trips = (grp_ptr[g + 1] - grp_ptr[g]) // 32
                    acc = np.zeros((len(tts), 32), np.complex64)
                    for step in range(trips):
                        at = grp_ptr[g] + 32 * step + np.arange(32)
                        acc += coef[at] * z[tts][:, ent[at, 0]]
                    lanes = np.arange(32)[32 * g + np.arange(32) < k]
                    for n, tt in enumerate(tts):
                        out[0, b, i, t0 + tt, 32 * g + lanes] = acc[n, lanes].real
                        out[1, b, i, t0 + tt, 32 * g + lanes] = acc[n, lanes].imag
    assert visited == n_work
    return out


@pytest.mark.parametrize('maxl,atom_n_ells,N,tau,tile,use_grouped', [
    (4, 5, 7, 10, 2, True),      # SF6 levels 1-2, the update's tile
    (4, 5, 7, 10, 3, False),     # dense table, tau no multiple of the tile
    (4, 1, 7, 10, 10, False),    # SF6 level 0 (M2 = 1), every channel a block
    (4, 1, 7, 10, 1, False),     # an evaluation's forward
    (3, 4, 10, 10, 5, False),    # stochastic level 1
    (3, 1, 10, 10, 4, False),    # stochastic level 0, ragged last tile
    (2, 3, 3, 5, 2, False),      # strips of 3, tau = 5 in tiles of 2
    (4, 3, 3, 1, 1, True)])      # tau = 1
def test_aggregate_kernel_walk_matches_plain(maxl, atom_n_ells, N, tau, tile,
                                             use_grouped):
    B = 2
    arrays = _agg_inputs(B, N, tau, maxl, atom_n_ells, seed=tile + N)
    table3, grouped = _agg_tables(maxl, atom_n_ells, tcg)
    grouped = grouped if use_grouped else None
    ref = fused_agg.cg_aggregate_edge_fused_ri_plain(
        *map(torch.from_numpy, arrays), table3, grouped=grouped)
    # fewer blocks than tiles, so that blocks walk several tiles
    got = _walk_forward(*arrays, table3, grouped, tile, n_blocks=5)
    assert np.isfinite(got).all()
    for mine, plain in zip(got, ref):
        scale = float(plain.abs().max())
        np.testing.assert_allclose(mine, plain.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# the square's forward kernel (csrc/cg_square.cu) walked in numpy as it runs:
# persistent blocks over tiles of R rows, z pair-major in the slots of the
# pairs some column reads, the columns packed warp by warp in output order
# and taken by warps in a snake over their lengths, one entry read for all R
# rows. 1e-5 relative, f32.
# ---------------------------------------------------------------------------

SMS = 132
# rows of the square at both configurations' shapes: B * N * tau at the
# update's batch (140), the rollout's (10) and an evaluation's (1)
SQUARE_ROW_CASES = [(maxl, B * N * tau) for maxl, N, taus in
                    ((4, 7, (10, 12)), (3, 10, (10, 16)))
                    for tau in taus for B in (140, 10, 1)]


def _square_np_tables(mode, maxl):
    table3, grouped, tri = _square_args(mode, maxl, tcg)
    pairs, blocks = fused_agg._square_blocks(table3, grouped, tri)
    return (table3, grouped, tri,
            fused_agg.square_tables(pairs, blocks, table3.shape[0]))


def _snake(i, c, ways):
    return i * ways + (ways - 1 - c if i & 1 else c)


def _walk_square_forward(a_r, a_i, tabs, rows, threads, n_blocks):
    """The forward kernel's loops in numpy (f32); every output is written
    exactly once."""
    n_rows, m = a_r.shape
    zs = fused_agg.square_slot_stride(rows)
    k, grp_ptr, seq = tabs['k'], tabs['fwd_ptr'], tabs['fwd_seq']
    ent, slot_mn = tabs['fwd_ent'], tabs['slot_mn']
    coef = ent[:, 1].copy().view(np.float32)
    n_groups, n_warps = len(grp_ptr) - 1, threads // 32
    a = (a_r + 1j * a_i).astype(np.complex64)
    out = np.full((2, n_rows, k), np.nan, np.float32)
    writes = np.zeros((n_rows, k), np.int64)
    n_tiles = -(-n_rows // rows)
    for block in range(min(n_blocks, n_tiles)):       # persistent blocks
        for tile in range(block, n_tiles, n_blocks):
            row0 = tile * rows
            nr = min(rows, n_rows - row0)
            # a slot-major, [M][zs]; the rows past a short tile hold garbage
            sa = np.full((m, zs), np.nan, np.complex64)
            sa[:, :nr] = a[row0:row0 + nr].T
            z = np.full((len(slot_mn), zs), np.nan, np.complex64)
            for s, mn in enumerate(slot_mn):          # a thread per slot
                z[s, :rows] = sa[mn >> 16, :rows] * sa[mn & 0xffff, :rows]
            for warp in range(n_warps):
                for j in range(n_groups):
                    pos = _snake(j, warp, n_warps)
                    if pos >= n_groups:
                        break
                    g = seq[pos]
                    acc = np.zeros((32, rows), np.complex64)
                    for step in range((grp_ptr[g + 1] - grp_ptr[g]) // 32):
                        at = grp_ptr[g] + 32 * step + np.arange(32)
                        acc += coef[at][:, None] * z[ent[at, 0], :rows]
                    for lane in range(32):
                        col = 32 * g + lane
                        if col < k:
                            out[0, row0:row0 + nr, col] = acc[lane, :nr].real
                            out[1, row0:row0 + nr, col] = acc[lane, :nr].imag
                            writes[row0:row0 + nr, col] += 1
    assert (writes == 1).all()
    return out


@pytest.mark.parametrize('mode', ['dense', 'grouped', 'tri'])
@pytest.mark.parametrize('maxl', [2, 3, 4])
def test_square_tables_are_the_sparse_table(mode, maxl):
    """z slots for exactly the pairs some column reads; the packed columns,
    read through the slots, rebuild the dense table; the group order is
    longest first; a column without entries is all padding."""
    table3, grouped, tri, tabs = _square_np_tables(mode, maxl)
    pairs, blocks = fused_agg._square_blocks(table3, grouped, tri)
    colptr, pair, coef = fused_agg.sparse_columns(blocks)
    k = len(colptr) - 1
    assert tabs['k'] == k and tabs['nnz'] == len(coef)
    used = np.unique(pair)
    mn = tabs['slot_mn']
    np.testing.assert_array_equal(mn >> 16, pairs[used, 0])
    np.testing.assert_array_equal(mn & 0xffff, pairs[used, 1])
    ref = np.zeros((len(pairs), k), np.float32)
    for col in range(k):
        ref[pair[colptr[col]:colptr[col + 1]], col] = coef[colptr[col]:colptr[col + 1]]
    by_slot = _padded_dense(tabs['fwd_ptr'], np.arange(32 * (len(tabs['fwd_ptr']) - 1)),
                            tabs['fwd_ent'], 32 * (len(tabs['fwd_ptr']) - 1),
                            len(mn))[:, :k]
    rebuilt = np.zeros_like(ref)
    rebuilt[used] = by_slot
    np.testing.assert_array_equal(rebuilt, ref)
    trips = np.diff(tabs['fwd_ptr'])[tabs['fwd_seq']]
    assert sorted(tabs['fwd_seq']) == list(range(len(trips)))
    assert (np.diff(trips) <= 0).all()


def test_square_tables_at_the_main_shapes():
    """The counts the kernels' notes and PERF.md quote: SF6 and the
    stochastic configuration's tri tables."""
    for maxl, counts in ((4, (375, 1130, 287, 1728, 1248, 287)),
                         (3, (156, 335, 112, 576, 416, 112))):
        tabs = _square_np_tables('tri', maxl)[3]
        assert (tabs['k'], tabs['nnz'], len(tabs['slot_mn']),
                len(tabs['fwd_ent']), len(tabs['bwd_ent']),
                tabs['n_live']) == counts


@pytest.mark.parametrize('maxl,n_rows', SQUARE_ROW_CASES)
def test_square_plans_fill_the_card_and_fit(maxl, n_rows):
    """The forward's tile is the largest that gives every SM two tiles and
    keeps a block under its target (one row if none does); its threads are
    whole warps, at most one a group. The backward's block of 2 rows fits
    four times on an SM."""
    _t, _g, _tri, tabs = _square_np_tables('tri', maxl)
    m = (maxl + 1) ** 2
    n_groups, n_ent = len(tabs['fwd_ptr']) - 1, len(tabs['fwd_ent'])

    def smem_of(rows):
        return fused_agg.square_fwd_smem(rows, m, n_groups, n_ent,
                                         len(tabs['slot_mn']))
    plan = fused_agg.square_fwd_plan(n_rows, m, n_groups, n_ent,
                                     len(tabs['slot_mn']), SMS)
    rows = plan['rows']
    assert rows in fused_agg.SQUARE_FWD_ROWS and plan['smem'] == smem_of(rows)
    assert plan['threads'] == 32 * min(8, n_groups)
    if rows > 1:
        assert (-(-n_rows // rows) >= 2 * SMS
                and plan['smem'] <= fused_agg.SQUARE_FWD_SMEM_TARGET)
    for bigger in fused_agg.SQUARE_FWD_ROWS:
        if bigger > rows:
            assert (-(-n_rows // bigger) < 2 * SMS
                    or smem_of(bigger) > fused_agg.SQUARE_FWD_SMEM_TARGET)
    # the update's batch takes the widest tiles, an evaluation's one row
    if n_rows >= 140 * 70:
        assert rows == 4
    if n_rows <= 160:
        assert rows == 1
    smem = fused_agg.square_bwd_smem(m, tabs['k'], len(tabs['bwd_ptr']) - 1,
                                     len(tabs['bwd_ent']), tabs['inc'].shape[1])
    assert 4 * smem <= fused_agg.MAX_SMEM


@pytest.mark.parametrize('mode,maxl,n_rows,rows,n_blocks', [
    ('tri', 4, 37, 4, 3),        # SF6, the update's tile, a short last tile
    ('tri', 4, 20, 2, 2),
    ('tri', 3, 21, 2, 4),        # stochastic, rows no multiple of the tile
    ('tri', 3, 5, 1, 2),         # an evaluation's rows, one a tile
    ('tri', 2, 9, 4, 1),         # two groups of columns, one block
    ('dense', 4, 11, 2, 3),
    ('grouped', 4, 10, 4, 2),
    ('dense', 3, 3, 4, 1),       # fewer rows than one tile
    ('grouped', 2, 13, 4, 5)])   # more blocks than tiles
def test_square_kernel_walk_matches_plain(mode, maxl, n_rows, rows, n_blocks):
    table3, grouped, tri, tabs = _square_np_tables(mode, maxl)
    rng = np.random.RandomState(n_rows + rows)
    a_r, a_i = rng.randn(2, n_rows, (maxl + 1) ** 2).astype(np.float32)
    ref = fused_agg.cg_square_fused_ri_plain(torch.from_numpy(a_r),
                                             torch.from_numpy(a_i), table3,
                                             grouped=grouped, tri=tri)
    threads = 32 * min(8, len(tabs['fwd_ptr']) - 1)
    got = _walk_square_forward(a_r, a_i, tabs, rows, threads, n_blocks)
    assert np.isfinite(got).all()
    for mine, plain in zip(got, ref):
        scale = float(plain.abs().max())
        np.testing.assert_allclose(mine, plain.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale)


def _phase_passes(grp_ptr, ent, live, banks, phase):
    """Mean shared-memory passes of one phase of a step: the most distinct
    live indices of the phase on one bank (1 for a phase with none)."""
    passes = []
    for g in range(len(grp_ptr) - 1):
        for at in range(grp_ptr[g], grp_ptr[g + 1], phase):
            idx = {int(ent[i, 0]) for i in range(at, at + phase) if live[i]}
            on_bank = Counter(banks[i] for i in idx)
            passes.append(max(on_bank.values(), default=1))
    return float(np.mean(passes))


@pytest.mark.parametrize('maxl', [3, 4])
@pytest.mark.parametrize('table', ['fwd', 'bwd'])
def test_spread_steps_keeps_the_table_and_cuts_conflicts(maxl, table):
    """The spread table holds each lane's entries (its sum, in another fixed
    order) and padding of coefficient 0 that repeats an index its phase
    reads; a phase of a load takes fewer passes than in the table as
    warp_padded leaves it (SF6: 1.57 -> 1.10 forward, 1.67 -> 1.10
    backward)."""
    _t, _g, _tri, tabs = _square_np_tables('tri', maxl)
    table3, grouped, tri = _square_args('tri', maxl, tcg)
    pairs, blocks = fused_agg._square_blocks(table3, grouped, tri)
    if table == 'fwd':
        colptr, pair, coef = fused_agg.sparse_columns(blocks)
        used = np.unique(pair)
        slot_of = np.zeros(len(pairs), np.int64)
        slot_of[used] = np.arange(len(used))
        grp_ptr, line_of, ent = fused_agg.warp_padded(colptr, slot_of[pair],
                                                      coef)
        counts, banks, phase = np.diff(colptr), np.arange(len(used)) % 8, 8
        spread, before, after = tabs['fwd_ent'], 1.57, 1.10
    else:
        rowptr, col, coef = fused_agg.sparse_rows(blocks, len(pairs))
        counts = np.diff(rowptr)[np.diff(rowptr) > 0]
        grp_ptr, line_of, ent = fused_agg.warp_padded(
            np.concatenate([[0], np.cumsum(counts)]), col, coef, by_length=True)
        banks, phase = np.arange(tabs['k']) % 32, 32
        spread, before, after = tabs['bwd_ent'], 1.67, 1.10
    np.testing.assert_array_equal(tabs[f'{table}_ptr'], grp_ptr)
    slot_counts = np.where(line_of >= 0, counts[np.maximum(line_of, 0)], 0)
    live = np.zeros(len(ent), bool)
    for slot, n in enumerate(slot_counts):
        g, lane = divmod(slot, 32)
        live[grp_ptr[g] + 32 * np.arange(n) + lane] = True
        lane_at = grp_ptr[g] + 32 * np.arange((grp_ptr[g + 1] - grp_ptr[g]) // 32) + lane
        mine = spread[lane_at]
        kept = mine[mine[:, 1] != 0]
        assert sorted(map(tuple, kept)) == sorted(map(tuple, ent[lane_at][:n]))
    # padding repeats an index of its phase
    for at in range(0, len(spread), phase):
        phase_idx = set(spread[at:at + phase][spread[at:at + phase, 1] != 0, 0])
        for idx, bits in spread[at:at + phase]:
            assert bits != 0 or not phase_idx or idx in phase_idx
    live_spread = spread[:, 1] != 0
    old = _phase_passes(grp_ptr, ent, live, banks, phase)
    new = _phase_passes(grp_ptr, spread, live_spread, banks, phase)
    assert new < old
    if maxl == 4:
        assert round(old, 2) == before and round(new, 2) == after
