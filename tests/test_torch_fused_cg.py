"""The port's channel-wise packed CG product (ops/fused_cg.py) against
molgym_tpu's Pallas kernel (ops/pallas_cg.py, run in interpret mode as the
JAX package's own tests run it on the CPU), forward and gradient; its plain
backward against torch.autograd through the plain forward; and the tables
and plans the CUDA kernels read, held against the dense table and, by
walking both kernels' loops in numpy in their order, against the plain
versions at the path's shapes. The kernels themselves are compared with the
plain versions on the card (tests/test_torch_kernels.py and chip_smoke.py).

Tolerance: forward 2e-5 absolute (the JAX test's, tests/covariant/
test_so3_ops.py), gradients 3e-4 relative and absolute (the JAX test's);
PyTorch against PyTorch 1e-5 relative, 2e-5 absolute (float32, another
summation order); the numpy walks 1e-5 of the largest |value| (float32,
another summation order)."""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molgym_tpu.ops import cg as jcg
from molgym_tpu.ops.pallas_cg import cg_contract_pallas
from molgym_tpu_torch.ops import cg as tcg
from molgym_tpu_torch.ops import fused_agg, fused_cg

# (n_ells1, n_ells2, maxl): the mixer's two products at SF6 (M = 1 x 25,
# 25 x 25) and at the stochastic configuration (1 x 16, 16 x 16), and an
# uneven pair
CONFIGS = [(1, 5, 4), (5, 5, 4), (1, 4, 3), (4, 4, 3), (3, 2, 3)]
RTOL, ATOL = 1e-5, 2e-5


def _case(n1, n2, maxl, seed, lead=(3, 4)):
    rng = np.random.RandomState(seed)
    m1, m2 = n1 * n1, n2 * n2
    table3, _sl = tcg._fused_cg_table(n1, n2, maxl)
    parts = [rng.randn(*lead, m).astype(np.float32) for m in (m1, m1, m2, m2)]
    grads = rng.randn(2, *lead, table3.shape[2]).astype(np.float32)
    return parts, grads, table3


def _stacked(r, i):
    return jnp.stack([jnp.asarray(r), jnp.asarray(i)], axis=-1)


@pytest.mark.parametrize('n1,n2,maxl', CONFIGS)
def test_plain_forward_matches_pallas(n1, n2, maxl):
    parts, _grads, table3 = _case(n1, n2, maxl, seed=n1 + n2)
    jtable, _sl = jcg._fused_cg_table(n1, n2, maxl)
    ref = cg_contract_pallas(_stacked(*parts[:2]), _stacked(*parts[2:]),
                             jtable, interpret=True)
    out_r, out_i = fused_cg.cg_contract_ri(*map(torch.from_numpy, parts),
                                           table3)
    np.testing.assert_allclose(out_r.numpy(), np.asarray(ref[..., 0]), atol=2e-5)
    np.testing.assert_allclose(out_i.numpy(), np.asarray(ref[..., 1]), atol=2e-5)


@pytest.mark.parametrize('n1,n2,maxl', CONFIGS)
def test_gradients_match_the_pallas_vjp(n1, n2, maxl):
    """autograd through the plain forward, and the plain backward, against
    jax.grad through the Pallas custom VJP."""
    parts, grads, table3 = _case(n1, n2, maxl, seed=3 + n1 + n2)
    jtable, _sl = jcg._fused_cg_table(n1, n2, maxl)
    cot = _stacked(*grads)

    def loss(a, b):
        return jnp.sum(cg_contract_pallas(a, b, jtable, interpret=True) * cot)

    ja, jb = jax.grad(loss, argnums=(0, 1))(_stacked(*parts[:2]),
                                            _stacked(*parts[2:]))
    ref = [ja[..., 0], ja[..., 1], jb[..., 0], jb[..., 1]]

    leaves = [torch.from_numpy(x).requires_grad_() for x in parts]
    out = fused_cg.cg_contract_ri(*leaves, table3)
    g = tuple(map(torch.from_numpy, grads))
    auto = torch.autograd.grad(out, leaves, g)
    plain = fused_cg.cg_contract_ri_bwd_plain(
        *(x.detach() for x in leaves), *g, table3)
    for a, p, j in zip(auto, plain, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=3e-4, atol=3e-4)
        torch.testing.assert_close(p, a, rtol=RTOL, atol=ATOL)


def test_one_tensor_as_both_operands_sums_both_gradients():
    """The mixer's square: autograd adds da and db of the plain backward."""
    parts, grads, table3 = _case(3, 3, 2, seed=5)
    a_r = torch.from_numpy(parts[0]).requires_grad_()
    a_i = torch.from_numpy(parts[1])
    out = fused_cg.cg_contract_ri(a_r, a_i, a_r, a_i, table3)
    g = tuple(map(torch.from_numpy, grads))
    (auto, ) = torch.autograd.grad(out, a_r, g)
    da_r, _da_i, db_r, _db_i = fused_cg.cg_contract_ri_bwd_plain(
        a_r.detach(), a_i, a_r.detach(), a_i, *g, table3)
    torch.testing.assert_close(da_r + db_r, auto, rtol=RTOL, atol=ATOL)


def _unpack(grp_ptr, line_of, ent, n_lines):
    """A warp-padded table back to {(line, index): coefficient}, padding
    (coefficient 0) left out; each lane's entries in its step order."""
    coef = ent[:, 1].copy().view(np.float32)
    out = {}
    for g in range(len(grp_ptr) - 1):
        for at in range(grp_ptr[g], grp_ptr[g + 1]):
            line = line_of[32 * g + (at - grp_ptr[g]) % 32]
            if coef[at] != 0:
                assert 0 <= line < n_lines and (line, ent[at, 0]) not in out
                out[(line, ent[at, 0])] = coef[at]
    return out


@pytest.mark.parametrize('n1,n2,maxl', CONFIGS)
def test_kernel_tables_match_plain(n1, n2, maxl):
    """The packed 8-byte entries unpack to cg._fused_cg_table: the forward's
    columns as (m << 16 | n, coefficient), column 32 g + l at lane l of
    group g; the backward's live pairs as (k, coefficient) at their dz
    slot. The tables are built once per device."""
    _parts, _grads, table3 = _case(n1, n2, maxl, seed=7 + n1)
    m1, m2, k = table3.shape
    tabs = fused_cg.kernel_tables(table3, torch.device('cpu'))
    assert fused_cg.kernel_tables(table3, torch.device('cpu')) is tabs
    np_tabs = fused_cg.product_tables(table3)
    for name, v in np_tabs.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(tabs[name].numpy(), v)
    assert tabs['fwd_groups'] == tuple(np_tabs['fwd_ptr'])
    assert tabs['k'] == k and tabs['nnz'] == np.count_nonzero(table3)

    n_slots = 32 * (len(np_tabs['fwd_ptr']) - 1)
    assert 0 <= n_slots - k < 32
    fwd = _unpack(np_tabs['fwd_ptr'], np.arange(n_slots), np_tabs['fwd_ent'], k)
    rebuilt = np.zeros_like(table3)
    for (col, mn), c in fwd.items():
        rebuilt[mn >> 16, mn & 0xffff, col] = c
    np.testing.assert_array_equal(rebuilt, table3)

    slot_pair = _dz_slots(np_tabs, m1, m2)
    line_of = np.full((len(np_tabs['bwd_ptr']) - 1) * 32, -1)
    for slot, p in slot_pair.items():
        line_of[slot] = p
    bwd = _unpack(np_tabs['bwd_ptr'], line_of, np_tabs['bwd_ent'], m1 * m2)
    rebuilt = np.zeros_like(table3)
    for (p, col), c in bwd.items():
        rebuilt[p // m2, p % m2, col] = c
    np.testing.assert_array_equal(rebuilt, table3)


def _lines(tabs, m1, m2):
    """The backward's two step-major line tables, [a_steps, M1] and
    [b_steps, M2], each padded to a multiple of 4 words."""
    la, lb = tabs['a_steps'], tabs['b_steps']
    a_words = -(-la * m1 // 4) * 4
    assert len(tabs['lines']) == a_words + -(-lb * m2 // 4) * 4
    return (tabs['lines'][:la * m1].reshape(la, m1),
            tabs['lines'][a_words:a_words + lb * m2].reshape(lb, m2))


def _dz_slots(tabs, m1, m2):
    """{dz slot: pair m * M2 + n} of the backward, read off its lines."""
    zero = 32 * (len(tabs['bwd_ptr']) - 1)
    out = {}
    for part, lines in enumerate(_lines(tabs, m1, m2)):
        for e, t in np.ndindex(lines.shape):
            slot, other = lines[e, t] >> 16, lines[e, t] & 0xffff
            if slot != zero:
                p = t * m2 + other if part == 0 else other * m2 + t
                assert out.setdefault(slot, p) == p
    return out


@pytest.mark.parametrize('n1,n2,maxl', CONFIGS)
def test_backward_skips_the_dead_pairs(n1, n2, maxl):
    """Only pairs with entries get a dz slot and a place in the lines; each
    live pair is on its m's line and its n's line once, in order of the
    other slot; the rest of a line is the slot of zeros; the lanes are
    sorted by length."""
    _parts, _grads, table3 = _case(n1, n2, maxl, seed=1)
    m1, m2, k = table3.shape
    tabs = fused_cg.product_tables(table3)
    live = np.count_nonzero(table3, axis=2)
    slot_pair = _dz_slots(tabs, m1, m2)
    assert sorted(slot_pair.values()) == list(np.flatnonzero(live))
    assert tabs['n_live'] == len(slot_pair)
    zero = 32 * (len(tabs['bwd_ptr']) - 1)
    a_lines, b_lines = _lines(tabs, m1, m2)
    assert tabs['a_steps'] == max(np.count_nonzero(live, axis=1).max(), 1)
    assert tabs['b_steps'] == max(np.count_nonzero(live, axis=0).max(), 1)
    for lines, on in ((a_lines, live != 0), (b_lines, (live != 0).T)):
        for t in range(lines.shape[1]):
            slots, others = lines[:, t] >> 16, lines[:, t] & 0xffff
            n_on = np.count_nonzero(on[t])
            assert (slots[:n_on] != zero).all() and (slots[n_on:] == zero).all()
            assert list(others[:n_on]) == list(np.flatnonzero(on[t]))
    lengths = [live.ravel()[slot_pair[s]] for s in sorted(slot_pair)]
    assert lengths == sorted(lengths, reverse=True)


SMS = 132          # an H100 SXM's
# the mixer's two products at SF6 and at the stochastic configuration
PATH_CONFIGS = [(1, 5, 4), (5, 5, 4), (1, 4, 3), (4, 4, 3)]
# an evaluation's rows, the rollout's, a count no tile divides, the update's
PATH_ROWS = [4, 40, 111, 560]


def _plans(table3, tabs, n_rows):
    m1, m2, k = table3.shape
    return (fused_cg.product_fwd_plan(
                n_rows, m1, m2, tuple(int(x) for x in tabs['fwd_ptr']), SMS),
            fused_cg.product_bwd_plan(
                n_rows, m1, m2, k, len(tabs['bwd_ptr']) - 1,
                len(tabs['bwd_ent']), len(tabs['lines']), SMS))


@pytest.mark.parametrize('n1,n2,maxl', PATH_CONFIGS)
def test_plans_fill_the_card_and_fit(n1, n2, maxl):
    """Forward: tiles of 4 rows at the update's batch, one row a tile at the
    rollout's and an evaluation's; the column groups cut into chunks of 3,
    so that the rows spread over the SMs; whole warps, one a group of the
    chunk and enough that a thread copies one value of a and of b. Backward: the fewest rows a tile that bring half
    the table's bytes, among the tiles that give every SM one and fit the
    target; lanes a line a power of two. Every block of both under the
    default 48 KB, so the host never raises a kernel's limit on the
    path."""
    table3, _sl = tcg._fused_cg_table(n1, n2, maxl)
    m1, m2, _k = table3.shape
    tabs = fused_cg.product_tables(table3)
    groups = tabs['fwd_ptr']
    n_groups = len(groups) - 1
    for n_rows in PATH_ROWS:
        fwd, bwd = _plans(table3, tabs, n_rows)
        tiles = -(-n_rows // fwd['rows'])
        assert fwd['rows'] == (4 if n_rows == 560 else 1)
        assert fwd['per_block'] == min(3, n_groups)
        assert fwd['chunks'] == -(-n_groups // fwd['per_block'])
        warps = max(fwd['per_block'], -(-fwd['rows'] * max(m1, m2) // 32))
        assert fwd['threads'] == 32 * min(warps, 16)
        chunk_ent = [groups[min(n_groups, c * fwd['per_block'] + fwd['per_block'])]
                     - groups[c * fwd['per_block']] for c in range(fwd['chunks'])]
        assert fwd['ent_cap'] == max(chunk_ent)
        assert fwd['smem'] <= 48 * 1024
        if n_rows == 560:
            assert tiles * fwd['chunks'] >= SMS
        assert bwd['smem'] <= fused_cg.PRODUCT_BWD_SMEM_TARGET
        lanes = bwd['lanes']
        assert lanes & (lanes - 1) == 0 and lanes * (m1 + m2) <= bwd['threads']
        assert bwd['threads'] in (128, 256)
    # the update's batch: one row a tile where the table is small, 2 at
    # SF6's second product (4 would pass the target), 4 at the stochastic
    # configuration's second
    _fwd, bwd = _plans(table3, tabs, 560)
    assert bwd['rows'] == {(1, 5, 4): 1, (1, 4, 3): 1, (5, 5, 4): 2,
                           (4, 4, 3): 4}[(n1, n2, maxl)]
    for n_rows in (40, 4):
        assert _plans(table3, tabs, n_rows)[1]['rows'] == 1


def test_forward_plan_takes_only_compiled_tiles():
    """The forward kernel is compiled for tiles of 4 and 1 rows: the plan
    takes 4 exactly where that still gives every SM a tile, else 1."""
    table3, _sl = tcg._fused_cg_table(5, 5, 4)
    groups = tuple(int(x) for x in fused_cg.product_tables(table3)['fwd_ptr'])
    for n_rows in range(1, 1200):
        rows = fused_cg.product_fwd_plan(n_rows, 25, 25, groups, SMS)['rows']
        assert rows == (4 if -(-n_rows // 4) >= SMS else 1), n_rows


def test_kernels_lay_out_slots_as_the_plans_size_them():
    """csrc/cg_product_common.cuh's slot_stride, which both kernels lay out
    their shared memory by, gives the strides fused_cg.slot_stride sizes
    that memory by, at every tile the kernels are compiled for."""
    src = (Path(fused_cg.__file__).resolve().parents[1] / 'csrc' /
           'cg_product_common.cuh').read_text()
    body = re.search(r'constexpr int slot_stride\(\) \{\s*return ([^;]+);',
                     src).group(1)
    cond, then, other = re.fullmatch(r'(.+) \? (.+) : (.+)', body).groups()
    for rows in sorted(set(fused_cg.PRODUCT_FWD_ROWS + fused_cg.PRODUCT_BWD_ROWS)):
        stride = eval(f'({then}) if ({cond}) else ({other})', {'R': rows})
        assert stride == fused_cg.slot_stride(rows), rows


def _walk_forward(a, b, tabs, plan):
    """The forward kernel's loops in numpy (complex64): a block per (tile,
    chunk of groups), a and b of the tile slot-major (rows past a short tile
    hold NaN), a warp per group of the chunk over the tile's rows, each lane
    reading its column's entries in step order. Every (row, column) is
    written exactly once."""
    n_rows, m1 = a.shape
    rows, per = plan['rows'], plan['per_block']
    grp_ptr, ent = tabs['fwd_ptr'], tabs['fwd_ent']
    k_all = tabs['k']
    coef = ent[:, 1].copy().view(np.float32)
    n_groups, n_warps = len(grp_ptr) - 1, plan['threads'] // 32
    out = np.full((n_rows, tabs['k']), np.nan, np.complex64)
    writes = np.zeros(out.shape, np.int64)
    for tile in range(-(-n_rows // rows)):
        row0 = tile * rows
        nr = min(rows, n_rows - row0)
        sa = np.full((m1, rows), np.nan, np.complex64)
        sb = np.full((b.shape[1], rows), np.nan, np.complex64)
        sa[:, :nr], sb[:, :nr] = a[row0:row0 + nr].T, b[row0:row0 + nr].T
        for chunk in range(plan['chunks']):
            g0, g1 = chunk * per, min(n_groups, chunk * per + per)
            assert grp_ptr[g1] - grp_ptr[g0] <= plan['ent_cap']
            for warp in range(n_warps):
                for g in range(g0 + warp, g1, n_warps):
                    acc = np.zeros((32, rows), np.complex64)
                    for e in range((grp_ptr[g + 1] - grp_ptr[g]) // 32):
                        at = grp_ptr[g] + 32 * e + np.arange(32)
                        mn = ent[at, 0]
                        acc += coef[at, None] * (sa[mn >> 16] * sb[mn & 0xffff])
                    for lane in range(32):
                        k = 32 * g + lane
                        if k < k_all:
                            out[row0:row0 + nr, k] = acc[lane, :nr]
                            writes[row0:row0 + nr, k] += 1
    assert (writes == 1).all()
    return out


def _snake(i, c, ways):
    return i * ways + (ways - 1 - c if i & 1 else c)


def _walk_backward(a, b, g, tabs, plan):
    """The backward kernel's loops in numpy (complex64): a block per tile of
    the plan's rows; dz of the live pairs at their lane slots, warps taking
    the groups in a snake, the slot of zeros; then da and db by S lanes a
    line over the step-major lines, lane s taking steps s, s + S, ..., and
    the shuffle tree adding the lanes' sums. Every output is written
    exactly once, and no dz slot a line names is left unwritten."""
    n_rows, m1 = a.shape
    m2 = b.shape[1]
    rows, lanes = plan['rows'], plan['lanes']
    grp_ptr, ent = tabs['bwd_ptr'], tabs['bwd_ent']
    coef = ent[:, 1].copy().view(np.float32)
    n_groups, n_warps = len(grp_ptr) - 1, plan['threads'] // 32
    zero = 32 * n_groups
    a_lines, b_lines = _lines(tabs, m1, m2)
    da = np.full((n_rows, m1), np.nan, np.complex64)
    db = np.full((n_rows, m2), np.nan, np.complex64)
    writes = np.zeros(n_rows, np.int64)
    for tile in range(-(-n_rows // rows)):
        row0 = tile * rows
        nr = min(rows, n_rows - row0)
        sa = np.full((m1, rows), np.nan, np.complex64)
        sb = np.full((m2, rows), np.nan, np.complex64)
        sg = np.full((g.shape[1], rows), np.nan, np.complex64)
        sa[:, :nr], sb[:, :nr] = a[row0:row0 + nr].T, b[row0:row0 + nr].T
        sg[:, :nr] = g[row0:row0 + nr].T
        dz = np.full((zero + 1, rows), np.nan, np.complex64)
        dz[zero] = 0
        for warp in range(n_warps):
            for j in range(n_groups):
                grp = _snake(j, warp, n_warps)
                if grp >= n_groups:
                    break
                acc = np.zeros((32, rows), np.complex64)
                for e in range((grp_ptr[grp + 1] - grp_ptr[grp]) // 32):
                    at = grp_ptr[grp] + 32 * e + np.arange(32)
                    acc += coef[at, None] * sg[ent[at, 0]]
                dz[32 * grp:32 * grp + 32] = acc
        sums = []
        for lines, other in ((a_lines, sb), (b_lines, sa)):
            slots, others = lines >> 16, lines & 0xffff
            assert not np.isnan(dz[slots, :nr]).any()
            part = np.zeros((lanes, ) + lines.shape[1:] + (rows, ), np.complex64)
            for s in range(lanes):
                for e in range(s, lines.shape[0], lanes):
                    part[s] += dz[slots[e]] * np.conj(other[others[e]])
            off = lanes // 2
            while off:                              # the shuffle tree
                part[:off] += part[off:2 * off]
                off //= 2
            sums.append(part[0])
        da[row0:row0 + nr] = sums[0][:, :nr].T
        db[row0:row0 + nr] = sums[1][:, :nr].T
        writes[row0:row0 + nr] += 1
    assert (writes == 1).all()
    return da, db


def _path_case(n1, n2, maxl, n_rows):
    table3, _sl = tcg._fused_cg_table(n1, n2, maxl)
    rng = np.random.RandomState(n_rows + n1 + n2)
    m1, m2, k = table3.shape
    parts = [rng.randn(n_rows, m).astype(np.float32) for m in (m1, m1, m2, m2)]
    grads = rng.randn(2, n_rows, k).astype(np.float32)
    return parts, grads, table3


def _assert_close(mine, plain):
    """1e-5 relative to the largest |value| (float32, another order)."""
    scale = float(plain.abs().max())
    np.testing.assert_allclose(mine, plain.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize('n_rows', PATH_ROWS)
@pytest.mark.parametrize('n1,n2,maxl', CONFIGS)
def test_forward_kernel_walk_matches_plain(n1, n2, maxl, n_rows):
    parts, _grads, table3 = _path_case(n1, n2, maxl, n_rows)
    tabs = fused_cg.product_tables(table3)
    plan, _bwd = _plans(table3, tabs, n_rows)
    got = _walk_forward(parts[0] + 1j * parts[1], parts[2] + 1j * parts[3],
                        tabs, plan)
    ref = fused_cg.cg_contract_ri_plain(*map(torch.from_numpy, parts), table3)
    _assert_close(got.real, ref[0])
    _assert_close(got.imag, ref[1])


@pytest.mark.parametrize('n_rows', PATH_ROWS)
@pytest.mark.parametrize('n1,n2,maxl', CONFIGS)
def test_backward_kernel_walk_matches_plain(n1, n2, maxl, n_rows):
    parts, grads, table3 = _path_case(n1, n2, maxl, n_rows)
    tabs = fused_cg.product_tables(table3)
    _fwd, plan = _plans(table3, tabs, n_rows)
    da, db = _walk_backward(parts[0] + 1j * parts[1], parts[2] + 1j * parts[3],
                            grads[0] + 1j * grads[1], tabs, plan)
    ref = fused_cg.cg_contract_ri_bwd_plain(*map(torch.from_numpy, parts),
                                            *map(torch.from_numpy, grads),
                                            table3)
    for mine, plain in zip((da.real, da.imag, db.real, db.imag), ref):
        _assert_close(mine, plain)


def test_wrapper_dispatches_on_the_device():
    """CPU tensors take the plain version and launch nothing; a tensor on
    neither the CPU nor a CUDA card is refused."""
    parts, _grads, table3 = _case(2, 2, 1, seed=1)
    fused_agg.reset_launch_counts()
    fused_cg.cg_contract_ri(*map(torch.from_numpy, parts), table3)
    assert set(fused_agg.launch_counts) >= {'cg_contract_ri',
                                            'cg_contract_ri_bwd'}
    assert all(v == 0 for v in fused_agg.launch_counts.values())
    meta = [torch.from_numpy(x).to('meta') for x in parts]
    with pytest.raises(ValueError, match='no kernel'):
        fused_cg.cg_contract_ri(*meta, table3)


def test_packed_product_routes_through_the_wrapper(monkeypatch):
    """cg_product_packed_ri and the stacked cg_product_packed call
    cg_contract_ri with contiguous parts."""
    seen = []

    def spy(a_r, a_i, b_r, b_i, table3):
        seen.append(all(x.is_contiguous() for x in (a_r, a_i, b_r, b_i)))
        return fused_cg.cg_contract_ri(a_r, a_i, b_r, b_i, table3)
    monkeypatch.setattr(tcg, 'cg_contract_ri', spy)
    parts, _grads, _table3 = _case(3, 2, 3, seed=2)
    a_r, a_i, b_r, b_i = map(torch.from_numpy, parts)
    (out_r, out_i), slices = tcg.cg_product_packed_ri(a_r, a_i, b_r, b_i,
                                                      3, 2, 3)
    stacked, slices2 = tcg.cg_product_packed(
        torch.stack([a_r, a_i], -1), torch.stack([b_r, b_i], -1), 3, 2, 3)
    assert seen == [True, True] and slices == slices2
    torch.testing.assert_close(stacked[..., 0], out_r, rtol=0, atol=0)
    torch.testing.assert_close(stacked[..., 1], out_i, rtol=0, atol=0)
