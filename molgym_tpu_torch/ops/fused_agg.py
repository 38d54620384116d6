"""The covariant encoder's two hot contractions: the fused edge CG aggregate
and the CG square (counterpart of molgym_tpu/ops/pallas_agg.py).

    aggregate  out[b,i,t,k] = sum_{m,n} C[m,n,k] sum_j rad[b,i,j,t,l(m)]
                                              * Y[b,i,j,m] * q[b,j,t,n]
    square     out[..., t, k] = sum_{(m,n)} C[(m,n),k] a[..., t, m] a[..., t, n]

Complex values travel as separate real/imag tensors; the output K layout is
the JAX function's for the same `grouped` / `tri` argument (dense order, or
the l1-major / lmin-major permuted order the PackedCatMix idx-form slices
consume).

Each public wrapper dispatches on the device of its tensors: on the CPU it
calls the plain PyTorch version beside it (`*_plain`), which autograd
differentiates; on a CUDA tensor it runs a `torch.autograd.Function` whose
forward launches the hand-written kernel (csrc/cg_aggregate.cu,
csrc/cg_square.cu) and whose backward launches the backward kernel
(csrc/cg_aggregate_bwd.cu, csrc/cg_square_bwd.cu), or raises. The plain
backward versions (`*_bwd_plain`) compute the same vector-Jacobian products
from their formulas. `launch_counts` (the registry of ops/kernel_common.py,
shared by all kernels) counts kernel launches only, so a run can show that
its main path went through the kernels.

Operands are float32, or all bfloat16 (the encoder's bf16 path). A bf16
call computes "bf16 in, f32 math, bf16 out": the kernels convert each
operand to f32 as they stage it and round each output once, and the plain
versions compute in f32 on the upcast operands and round their outputs
once; the tables stay f32. Gradients come back in the operands' dtype.
"""
from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import List, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from molgym_tpu_torch import cuda_build
# launch_counts and reset_launch_counts are read and reset through this
# module too
from molgym_tpu_torch.ops.kernel_common import (MAX_SMEM,
                                                check_cuda_operands,
                                                incoming, launch_counts,
                                                operand_dtype, ptrs, raise_on,
                                                reset_launch_counts,
                                                table_cache)

# the operand dtypes of the four kernels and their plain versions
DTYPES = (torch.float32, torch.bfloat16)

# (row_a, row_b, table [row_b - row_a, K_g]) blocks of a contraction: output
# columns are the blocks' columns in order, each contracting z[..., a:b].
Blocks = List[Tuple[int, int, np.ndarray]]


# ---------------------------------------------------------------------------
# contraction tables: the same blocks feed the plain version (as dense
# sub-tables) and the kernels (as compressed sparse columns for the forward,
# compressed sparse rows for the backward; all four kernels take them
# re-packed warp by warp, `warp_padded`, the square's with their steps spread
# over the banks, `spread_steps`)
# ---------------------------------------------------------------------------

def _aggregate_blocks(table3: np.ndarray, grouped) -> Blocks:
    m1, m2, k = table3.shape
    if grouped is None:
        return [(0, m1 * m2, np.ascontiguousarray(table3, np.float32)
                 .reshape(m1 * m2, k))]
    gtabs, _perm = grouped
    return [(l1 * l1 * m2, (l1 + 1) * (l1 + 1) * m2, t)
            for l1, t in enumerate(gtabs) if t.shape[1]]


def _square_blocks(table3: np.ndarray, grouped, tri):
    """(pairs int [P, 2], blocks) of the square for its table mode."""
    m = table3.shape[0]
    if tri is not None:
        pairs, groups = tri
        return (np.asarray(pairs, np.int64),
                [(a, b, t) for a, b, t in groups if t.shape[1]])
    pairs = np.array([(i, j) for i in range(m) for j in range(m)], np.int64)
    if grouped is None:
        return pairs, [(0, m * m, np.ascontiguousarray(table3, np.float32)
                        .reshape(m * m, -1))]
    gtabs, _perm = grouped
    return pairs, [(l1 * l1 * m, (l1 + 1) * (l1 + 1) * m, t)
                   for l1, t in enumerate(gtabs) if t.shape[1]]


def sparse_columns(blocks: Blocks):
    """Blocks -> (colptr int32 [K+1], pair int32 [nnz], coef float32 [nnz])
    in output column order."""
    colptr, pair, coef = [np.zeros(1, np.int64)], [], []
    for a, _b, t in blocks:
        cols, rows = np.nonzero(np.asarray(t).T)    # column-major order
        counts = np.bincount(cols, minlength=t.shape[1])
        colptr.append(colptr[-1][-1] + np.cumsum(counts))
        pair.append(rows + a)
        coef.append(np.asarray(t)[rows, cols])
    return (np.concatenate(colptr).astype(np.int32),
            np.concatenate(pair).astype(np.int32),
            np.concatenate(coef).astype(np.float32))


def sparse_rows(blocks: Blocks, n_rows: int):
    """Blocks -> (rowptr int32 [P+1], col int32 [nnz], coef float32 [nnz]):
    the transpose of `sparse_columns`, one row per pair p < P = `n_rows`,
    each coefficient with its output column in output order."""
    rows, cols, coefs = [], [], []
    ka = 0
    for a, _b, t in blocks:
        t = np.asarray(t)
        r, c = np.nonzero(t)
        rows.append(r + a)
        cols.append(c + ka)
        coefs.append(t[r, c])
        ka += t.shape[1]
    row = np.concatenate(rows)
    order = np.argsort(row, kind='stable')
    rowptr = np.zeros(n_rows + 1, np.int64)
    rowptr[1:] = np.cumsum(np.bincount(row, minlength=n_rows))
    return (rowptr.astype(np.int32), np.concatenate(cols)[order].astype(np.int32),
            np.concatenate(coefs)[order].astype(np.float32))


def pair_incidence(pairs: np.ndarray, m: int):
    """For each slot m, the pairs that hold it and the pair's other slot:
    (mptr int32 [M+1], pair int32 [2P], other int32 [2P]). A diagonal pair
    (m, m) is listed twice, once for each operand."""
    n_p = pairs.shape[0]
    slot = np.concatenate([pairs[:, 0], pairs[:, 1]])
    other = np.concatenate([pairs[:, 1], pairs[:, 0]])
    pair = np.concatenate([np.arange(n_p), np.arange(n_p)])
    order = np.argsort(slot, kind='stable')
    mptr = np.zeros(m + 1, np.int64)
    mptr[1:] = np.cumsum(np.bincount(slot, minlength=m))
    return (mptr.astype(np.int32), pair[order].astype(np.int32),
            other[order].astype(np.int32))


def incidence_lines(pairs: np.ndarray, m: int):
    """`pair_incidence` as a dense table, one line of L entries per slot m
    (L = M + 1 for the tri pairs, 2 M for all M * M; a shorter line would be
    padded with pair -1). Each line lists one pair for every other slot, in
    the order of the other slot, before any second one (the diagonal pair's
    second listing, or (n, m) beside (m, n)), so that at one step of the
    backward's da the lines mostly name the same other slot. Returns (pair,
    other), int [M, L]."""
    mptr, inc_pair, inc_other = pair_incidence(pairs, m)
    counts = np.diff(mptr)
    pair = np.full((m, max(counts.max(initial=0), 1)), -1, np.int64)
    other = np.zeros_like(pair)
    for s in range(m):
        p = inc_pair[mptr[s]:mptr[s + 1]]
        o = inc_other[mptr[s]:mptr[s + 1]]
        # how many earlier entries of the line name the same other slot
        rank = np.array([np.count_nonzero(o[:e] == o[e]) for e in range(len(o))],
                        np.int64)
        order = np.lexsort((p, o, rank))
        pair[s, :len(p)] = p[order]
        other[s, :len(o)] = o[order]
    return pair, other


WARP = 32


def warp_padded(ptr: np.ndarray, idx: np.ndarray, coef: np.ndarray,
                by_length: bool = False):
    """A compressed sparse table (`ptr` [R+1], `idx`, `coef` [nnz]: columns
    of the forward, rows of the backward) re-packed for warps of 32 lanes.

    Line r of the table goes to slot s (s = r, or the rank of r by falling
    length when `by_length`); group g holds slots 32 g .. 32 g + 31, one per
    lane, and takes trips[g] = the longest of its lines steps. Entry e of
    slot s lies at `grp_ptr[g] + 32 e + lane`, so a warp reads one step of
    all its lanes as 256 consecutive bytes and needs no per-line pointer;
    shorter lines are padded with (index 0, coefficient 0.0). Returns

        grp_ptr int32 [G + 1]   entry offset of each group (multiples of 32)
        line_of int32 [32 G]    the line of each slot, -1 for a slot past R
        ent     int32 [E, 2]    (index, bits of the float32 coefficient)
    """
    n_lines = len(ptr) - 1
    counts = np.diff(ptr)
    order = (np.argsort(-counts, kind='stable') if by_length
             else np.arange(n_lines))
    n_groups = -(-n_lines // WARP)
    line_of = np.full(n_groups * WARP, -1, np.int32)
    line_of[:n_lines] = order
    slot_counts = np.zeros(n_groups * WARP, np.int64)
    slot_counts[:n_lines] = counts[order]
    trips = slot_counts.reshape(n_groups, WARP).max(axis=1)
    grp_ptr = np.zeros(n_groups + 1, np.int64)
    grp_ptr[1:] = np.cumsum(trips * WARP)
    ent_idx = np.zeros(grp_ptr[-1], np.int32)
    ent_coef = np.zeros(grp_ptr[-1], np.float32)
    for s in range(n_lines):
        g, lane = divmod(s, WARP)
        a, b = ptr[order[s]], ptr[order[s] + 1]
        at = grp_ptr[g] + WARP * np.arange(b - a) + lane
        ent_idx[at] = idx[a:b]
        ent_coef[at] = coef[a:b]
    ent = np.stack([ent_idx, ent_coef.view(np.int32)], axis=1)
    return grp_ptr.astype(np.int32), line_of, np.ascontiguousarray(ent)


def spread_steps(grp_ptr: np.ndarray, line_of: np.ndarray,
                 counts: np.ndarray, ent: np.ndarray, banks: np.ndarray,
                 phase: int) -> np.ndarray:
    """A warp-padded table (`warp_padded`'s output; `counts` the entries of
    each line) with each lane's entries re-ordered over its group's steps,
    so that the lanes one phase of a shared-memory load serves (`phase`
    neighbouring lanes) read distinct banks where they can (`banks`: the
    bank of each index). Step by step, the lanes with the fewest steps to
    spare first, a lane takes the entry whose index its phase already reads
    or whose bank it reads least; a lane with steps to spare waits rather
    than add a conflict. A step a lane waits, or has no entry left, reads an
    index its phase reads anyway, with coefficient 0. Each lane's sum keeps
    a fixed order, this one; returns the new entries."""
    slot_counts = np.where(line_of >= 0, counts[np.maximum(line_of, 0)], 0)
    out = np.zeros_like(ent)
    for g in range(len(grp_ptr) - 1):
        first = grp_ptr[g]
        trips = (grp_ptr[g + 1] - first) // WARP
        left = [[tuple(ent[first + WARP * e + lane])
                 for e in range(slot_counts[WARP * g + lane])]
                for lane in range(WARP)]
        for e in range(trips):
            row = first + WARP * e
            for q in range(0, WARP, phase):
                load, read, waits = Counter(), set(), []
                for lane in sorted(range(q, q + phase),
                                   key=lambda l: trips - e - len(left[l])):
                    if not left[lane]:
                        waits.append(lane)
                        continue
                    cost = [0 if idx in read else load[banks[idx]]
                            for idx, _bits in left[lane]]
                    pick = int(np.argmin(cost))
                    if cost[pick] and len(left[lane]) < trips - e:
                        waits.append(lane)
                        continue
                    idx, bits = left[lane].pop(pick)
                    if idx not in read:
                        read.add(idx)
                        load[banks[idx]] += 1
                    out[row + lane] = (idx, bits)
                for lane in waits:
                    out[row + lane] = (min(read, default=0), 0)
        assert not any(left)
    return out


def pack_pairs(line_of: np.ndarray, m2: int) -> np.ndarray:
    """Pair indices p = m * m2 + n as (m << 16 | n); -1 stays -1."""
    packed = (line_of // m2 << 16) | (line_of % m2)
    return np.where(line_of < 0, -1, packed).astype(np.int32)


def _flat_arrays(table3, grouped=None, tri=None):
    out = [table3]
    if grouped is not None:
        out += list(grouped[0])
    if tri is not None:
        out += [tri[0]] + [t for _a, _b, t in tri[1]]
    return tuple(out)


def _to(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _plain_tables(kind, table3, grouped, tri, device):
    def build():
        if kind == 'aggregate':
            pairs, blocks = None, _aggregate_blocks(table3, grouped)
        else:
            pairs, blocks = _square_blocks(table3, grouped, tri)
        return (None if pairs is None else _to(pairs, device),
                [(a, b, _to(t, device)) for a, b, t in blocks])
    return table_cache.get(('plain', kind), _flat_arrays(table3, grouped, tri),
                      device, build)


def square_tables(pairs: np.ndarray, blocks: Blocks, m: int) -> dict:
    """The square's kernel tables (csrc/cg_square.cu, csrc/cg_square_bwd.cu)
    as numpy arrays.

    Forward: z gets a slot for each pair that some column reads, in pair
    order (`slot_mn`: m << 16 | n); the columns, in output order, are packed
    warp by warp with the slot of each entry (`fwd_ptr`, `fwd_ent`), and
    `fwd_seq` lists the groups longest first, the order warps take them in.
    Backward: the pairs with entries are packed warp by warp, sorted by
    length (`bwd_ptr`, `bwd_ent`: (column k, coefficient)); dz of a pair lies
    at its rank, and the empty pairs share the slot 32 G past the last
    group, which holds zeros. Both tables' steps are spread over the banks
    (`spread_steps`). `inc` [M, L] is `incidence_lines` with each
    pair replaced by its dz slot, as (dz slot << 8 | other slot)."""
    n_pairs = pairs.shape[0]
    colptr, pair, coef = sparse_columns(blocks)
    used = np.unique(pair)
    slot_of = np.zeros(n_pairs, np.int64)
    slot_of[used] = np.arange(len(used))
    fwd_ptr, cols, fwd_ent = warp_padded(colptr, slot_of[pair], coef)
    # z loads are 16 bytes a lane: a quarter warp a phase, a slot's bank
    # group its index mod 8 (see square_slot_stride)
    fwd_ent = spread_steps(fwd_ptr, cols, np.diff(colptr), fwd_ent,
                           np.arange(len(used)) % 8, 8)
    rowptr, col, coef_t = sparse_rows(blocks, n_pairs)
    counts = np.diff(rowptr)
    live = np.flatnonzero(counts)
    bwd_ptr, line_of, bwd_ent = warp_padded(
        np.concatenate([[0], np.cumsum(counts[live])]), col, coef_t,
        by_length=True)
    # g loads are 4 bytes a lane from one row: a warp a phase, bank k mod 32
    k = colptr.shape[0] - 1
    bwd_ent = spread_steps(bwd_ptr, line_of, counts[live], bwd_ent,
                           np.arange(k) % WARP, WARP)
    dz_slot = np.full(n_pairs + 1, len(line_of), np.int64)   # [-1]: padding
    on = line_of >= 0
    dz_slot[live[line_of[on]]] = np.flatnonzero(on)
    inc_pair, inc_other = incidence_lines(pairs, m)
    return dict(k=int(k), nnz=int(coef.shape[0]), n_live=len(live),
                slot_mn=(pairs[used, 0] << 16 | pairs[used, 1]).astype(np.int32),
                fwd_ptr=fwd_ptr,
                fwd_seq=np.argsort(-np.diff(fwd_ptr), kind='stable').astype(
                    np.int32),
                fwd_ent=fwd_ent, bwd_ptr=bwd_ptr, bwd_ent=bwd_ent,
                inc=(dz_slot[inc_pair] << 8 | inc_other).astype(np.int32))


def _kernel_tables(kind, table3, grouped, tri, device):
    def build():
        if kind == 'square':
            pairs, blocks = _square_blocks(table3, grouped, tri)
            tabs = square_tables(pairs, blocks, table3.shape[0])
            return {k: _to(v, device) if isinstance(v, np.ndarray) else v
                    for k, v in tabs.items()}
        blocks = _aggregate_blocks(table3, grouped)
        colptr, pair, coef = sparse_columns(blocks)
        rowptr, col, coef_t = sparse_rows(blocks,
                                          table3.shape[0] * table3.shape[1])
        fwd_ptr, _cols, fwd_ent = warp_padded(colptr, pair, coef)
        bwd_ptr, bwd_row, bwd_ent = warp_padded(rowptr, col, coef_t,
                                                by_length=True)
        return {'k': int(colptr.shape[0] - 1), 'nnz': int(coef.shape[0]),
                'fwd_ptr': _to(fwd_ptr, device),
                'fwd_ent': _to(fwd_ent, device),
                'bwd_ptr': _to(bwd_ptr, device),
                # the pair p = m * M2 + n of each slot as (m << 16 | n): the
                # kernel pads the rows of dz
                'bwd_row': _to(pack_pairs(bwd_row, table3.shape[1]), device),
                'bwd_ent': _to(bwd_ent, device)}
    return table_cache.get(('kernel', kind), _flat_arrays(table3, grouped, tri),
                      device, build)


@functools.lru_cache(maxsize=None)
def _l_of_m(n_ells: int, device: torch.device) -> torch.Tensor:
    """l of each packed m slot: [0, 1, 1, 1, 2, ...], on `device`."""
    return torch.tensor([l for l in range(n_ells) for _ in range(2 * l + 1)],
                        device=device)


def _f32(*tensors):
    """The operands upcast for the plain versions' f32 arithmetic (f32
    tensors are returned as they are)."""
    return [t.float() for t in tensors]


def _contract(z_r, z_i, blocks):
    outs_r = [z_r[..., a:b] @ t for a, b, t in blocks]
    outs_i = [z_i[..., a:b] @ t for a, b, t in blocks]
    return torch.cat(outs_r, dim=-1), torch.cat(outs_i, dim=-1)


def _contract_t(g_r, g_i, blocks, n_pairs):
    """The transpose of `_contract`: dz[..., p] = sum_k C[p, k] g[..., k]."""
    shape = g_r.shape[:-1] + (n_pairs, )
    dz_r, dz_i = g_r.new_zeros(shape), g_i.new_zeros(shape)
    ka = 0
    for a, b, t in blocks:
        kb = ka + t.shape[1]
        dz_r[..., a:b] += g_r[..., ka:kb] @ t.T
        dz_i[..., a:b] += g_i[..., ka:kb] @ t.T
        ka = kb
    return dz_r, dz_i


# ---------------------------------------------------------------------------
# kernel plumbing
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib, entry, argtypes):
    """Both dtype entries `entry`_f32 and `entry`_bf16 of `lib`."""
    for suffix in ('f32', 'bf16'):
        fn = getattr(lib, f'{entry}_{suffix}')
        fn.argtypes = argtypes
        fn.restype = _I


def _entry(lib, entry, dtype):
    return getattr(lib, f'{entry}_{"bf16" if dtype == torch.bfloat16 else "f32"}')


def _counter(name, dtype):
    """The launch counter of kernel `name` for operands of `dtype`."""
    return name + '_bf16' if dtype == torch.bfloat16 else name


@functools.lru_cache(maxsize=None)
def _aggregate_lib() -> ctypes.CDLL:
    lib = cuda_build.load('cg_aggregate')
    _bind(lib, 'cg_aggregate_edge_fused', [_P] * 8 + [_I] * 13 + [_P])
    lib.cg_aggregate_blocks_per_sm.argtypes = [_I] * 3
    lib.cg_aggregate_blocks_per_sm.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _aggregate_bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load('cg_aggregate_bwd')
    _bind(lib, 'cg_aggregate_bwd', [_P] * 12 + [_I] * 17 + [_P])
    lib.cg_aggregate_bwd_blocks_per_sm.argtypes = [_I] * 4
    lib.cg_aggregate_bwd_blocks_per_sm.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _square_lib() -> ctypes.CDLL:
    lib = cuda_build.load('cg_square')
    _bind(lib, 'cg_square_fused', [_P] * 8 + [_I] * 9 + [_P])
    lib.cg_square_blocks_per_sm.argtypes = [_I] * 3
    lib.cg_square_blocks_per_sm.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _square_bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load('cg_square_bwd')
    _bind(lib, 'cg_square_bwd', [_P] * 9 + [_I] * 7 + [_P])
    lib.cg_square_bwd_blocks_per_sm.argtypes = [_I]
    lib.cg_square_bwd_blocks_per_sm.restype = _I
    return lib


# ---------------------------------------------------------------------------
# fused edge aggregate
# ---------------------------------------------------------------------------

def cg_aggregate_edge_fused_ri_plain(sph_packed: torch.Tensor,
                                     rad_feats: torch.Tensor,
                                     atom_r: torch.Tensor,
                                     atom_i: torch.Tensor,
                                     table3: np.ndarray, grouped=None):
    """Plain PyTorch version of cg_aggregate_edge_fused_ri: builds the edge
    rep and the [.., tau, M1*M2] pair tensor z in memory, then contracts,
    in f32; outputs in the operands' dtype."""
    dtype = atom_r.dtype
    sph_packed, rad_feats, atom_r, atom_i = _f32(sph_packed, rad_feats, atom_r,
                                                 atom_i)
    B, N, _, tau, n_l = rad_feats.shape
    m1 = sph_packed.shape[-2]
    m2 = atom_r.shape[-1]
    rad_m = rad_feats[..., _l_of_m(n_l, rad_feats.device)]   # [B,N,N,t,M1]
    e_r = rad_m * sph_packed[..., 0][:, :, :, None, :]
    e_i = rad_m * sph_packed[..., 1][:, :, :, None, :]
    pattern = 'bijtm,bjtn->bitmn'
    z_r = (torch.einsum(pattern, e_r, atom_r) -
           torch.einsum(pattern, e_i, atom_i)).reshape(B, N, tau, m1 * m2)
    z_i = (torch.einsum(pattern, e_r, atom_i) +
           torch.einsum(pattern, e_i, atom_r)).reshape(B, N, tau, m1 * m2)
    _pairs, blocks = _plain_tables('aggregate', table3, grouped, None,
                                   rad_feats.device)
    out_r, out_i = _contract(z_r, z_i, blocks)
    return out_r.to(dtype), out_i.to(dtype)


def cg_aggregate_edge_fused_ri_bwd_plain(sph_packed: torch.Tensor,
                                         rad_feats: torch.Tensor,
                                         atom_r: torch.Tensor,
                                         atom_i: torch.Tensor,
                                         g_r: torch.Tensor, g_i: torch.Tensor,
                                         table3: np.ndarray, grouped=None):
    """The aggregate's vector-Jacobian product from its formula, given the
    output gradients g_r/g_i [B, N, tau, K]: (d rad [B, N, N, tau, L],
    d atom_r, d atom_i [B, N, tau, M2]). The spherical harmonics get none.

        dz[b,i,t,(m,n)] = sum_k C[(m,n),k] g[b,i,t,k]
        d e[b,i,j,t,m]  = sum_n dz[b,i,t,m,n] conj(q[b,j,t,n])
        d rad[..., l]   = sum_{m in l} Re(d e[..., m] conj(Y[..., m]))
        d q[b,j,t,n]    = sum_{i,m} dz[b,i,t,m,n] conj(e[b,i,j,t,m])

    in f32; the gradients in the operands' dtype.
    """
    dtype = atom_r.dtype
    sph_packed, rad_feats, atom_r, atom_i, g_r, g_i = _f32(
        sph_packed, rad_feats, atom_r, atom_i, g_r, g_i)
    B, N, _, tau, n_l = rad_feats.shape
    m1 = sph_packed.shape[-2]
    m2 = atom_r.shape[-1]
    _pairs, blocks = _plain_tables('aggregate', table3, grouped, None,
                                   rad_feats.device)
    dz_r, dz_i = _contract_t(g_r, g_i, blocks, m1 * m2)
    dz_r = dz_r.reshape(B, N, tau, m1, m2)
    dz_i = dz_i.reshape(B, N, tau, m1, m2)
    l_of_m = _l_of_m(n_l, rad_feats.device)
    y_r = sph_packed[..., 0][:, :, :, None, :]
    y_i = sph_packed[..., 1][:, :, :, None, :]
    rad_m = rad_feats[..., l_of_m]
    e_r, e_i = rad_m * y_r, rad_m * y_i                      # [B,N,N,t,M1]
    to_e = 'bitmn,bjtn->bijtm'
    de_r = torch.einsum(to_e, dz_r, atom_r) + torch.einsum(to_e, dz_i, atom_i)
    de_i = torch.einsum(to_e, dz_i, atom_r) - torch.einsum(to_e, dz_r, atom_i)
    drad = rad_feats.new_zeros(rad_feats.shape).index_add_(
        -1, l_of_m, de_r * y_r + de_i * y_i)
    to_q = 'bitmn,bijtm->bjtn'
    dq_r = torch.einsum(to_q, dz_r, e_r) + torch.einsum(to_q, dz_i, e_i)
    dq_i = torch.einsum(to_q, dz_i, e_r) - torch.einsum(to_q, dz_r, e_i)
    return drad.to(dtype), dq_r.to(dtype), dq_i.to(dtype)


def _aggregate_shapes(name, sph_packed, rad_feats, atom_r, atom_i, table3):
    B, N, N2, tau, n_l = rad_feats.shape
    m1 = sph_packed.shape[-2]
    m2 = atom_r.shape[-1]
    if (tuple(sph_packed.shape) != (B, N, N, m1, 2) or N2 != N or
            tuple(atom_r.shape) != (B, N, tau, m2) or
            atom_i.shape != atom_r.shape or n_l * n_l != m1 or
            tuple(table3.shape[:2]) != (m1, m2)):
        raise ValueError(f'{name}: inconsistent shapes sph '
                         f'{tuple(sph_packed.shape)} rad '
                         f'{tuple(rad_feats.shape)} atom '
                         f'{tuple(atom_r.shape)} table {table3.shape}')
    return B, N, tau, n_l, m1, m2


# How the aggregate's kernels cut their work (csrc/cg_aggregate.cu,
# csrc/cg_aggregate_bwd.cu). The choices are made here, on the host, from
# the shapes alone, so that the CPU tests can walk the same tiles.

FWD_THREADS = 256
BWD_THREADS = 192
# what a forward block may take of an SM's shared memory before the tile of
# channels is cut: five blocks of this size fit an SM
FWD_SMEM_TARGET = 40 * 1024
BWD_SMEM_TARGET = 40 * 1024
_STRIPS = (1, 3, 4, 5)       # register strips the kernels are compiled for


def _align16(n_bytes: int) -> int:
    return -(-n_bytes // 16) * 16


def strip_of(m: int) -> int:
    """The register strip for a rep of m slots: a rep of n l's has n * n
    slots and is cut into strips of n; any other width into strips of 1."""
    n = math.isqrt(m)
    return n if n * n == m and n in _STRIPS else 1


def aggregate_fwd_smem(N, tile_t, m1, m2, n_groups, n_ent) -> int:
    """Shared bytes of one forward block, the sum of what the kernel lays
    out: the packed table, z of the tile, the edge rep e and q of the
    neighbourhood, the group offsets."""
    return (_align16(8 * n_ent) + _align16(8 * tile_t * m1 * m2) +
            _align16(8 * N * tile_t * m1) + _align16(8 * N * tile_t * m2) +
            _align16(4 * (n_groups + 1)))


@functools.lru_cache(maxsize=None)
def aggregate_fwd_tile(B, N, tau, m1, m2, n_groups, n_ent, num_sms) -> int:
    """Channels per forward block. The channel is a batch axis of the whole
    function, so a block takes one (b, i) and a tile of channels: the
    largest tile that keeps a block under FWD_SMEM_TARGET and still gives
    the card two blocks per SM, evened out over the tiles of tau."""
    tile = tau
    while tile > 1 and (
            aggregate_fwd_smem(N, tile, m1, m2, n_groups, n_ent)
            > FWD_SMEM_TARGET or B * N * -(-tau // tile) < 2 * num_sms):
        tile -= 1
    return -(-tau // -(-tau // tile))


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


def aggregate_bwd_smem(N, n_l, m1, m2, k, n_groups, n_ent, rows,
                       m2_stride) -> int:
    """Shared bytes of one backward block that works on `rows` rows i at a
    time, the sum of what the kernel lays out: the packed table; g, Y and rad of the rows (in two buffers that
    take turns, unless all N rows fit at once; rows of g and Y with the
    slack of their 16-byte copies); then e, dz, q, the radial terms, the
    group offsets, the row of each slot and l of m."""
    n_buf = 2 if rows < N else 1
    return (_align16(8 * n_ent) +
            n_buf * (8 * rows * ((k + 3) // 4 + 1) * 4 +
                     _align16(8 * (rows * N * m1 + 2)) +
                     _align16(4 * rows * N * n_l)) +
            _align16(8 * rows * N * m1) + _align16(8 * rows * m1 * m2_stride) +
            _align16(8 * N * m2) + _align16(4 * rows * N * m1) +
            _align16(4 * (n_groups + 1)) + _align16(4 * WARP * n_groups) +
            _align16(4 * m1))


def dz_conflicts(N, m1, m2, stride, threads, ns, ms, mc, m_chunk, nc,
                 n_chunk) -> int:
    """Shared-memory passes the backward's two register tilings need for
    one 8-byte load of dz by every thread, rows of dz `stride` slots long:
    for each half warp (an 8-byte load is served 16 lanes at a time) the
    most distinct addresses that fall on one bank, summed over the block
    and both tilings. The least is one pass for each half warp at work."""
    def passes(addresses):
        on_bank = Counter((2 * a) % 32 for a in set(addresses))
        return max(on_bank.values(), default=0)
    sq, se = m2 // ns, m1 // ms
    total = 0
    for half in range(0, threads, 16):
        dq, de = [], []
        for tid in range(half, half + 16):
            qc, row = tid % mc, tid // mc
            if row // sq < N:
                dq.append(qc * m_chunk * stride + row % sq)
            ec, row = tid % nc, tid // nc
            if row // se < N:
                de.append((row % se) * stride + ec * n_chunk)
        total += passes(dq) + passes(de)
    return total


def aggregate_bwd_plan(N, n_l, m1, m2, k, n_groups, n_ent) -> dict:
    """How a backward block (one (b, t)) cuts its work (computed once per
    set of arguments; the caller gets its own copy).

    rows: the rows i it holds at a time, all N if that keeps the block
    under BWD_SMEM_TARGET (level 0: one round trip to memory instead of
    N), else as many as fit, evened out over N.
    Two register tilings: d q[j, strip of ns] is summed over a chunk of m by
    each of `mc` lanes, d e[j, strip of ms] over a chunk of n by each of
    `nc` lanes; mc and nc are powers of two (at most a warp), so the lanes
    of one output are neighbours and a shuffle tree adds them in a fixed
    order."""
    return dict(_bwd_plan(N, n_l, m1, m2, k, n_groups, n_ent))


@functools.lru_cache(maxsize=None)
def _bwd_plan(N, n_l, m1, m2, k, n_groups, n_ent):
    threads = BWD_THREADS
    ns, ms = strip_of(m2), strip_of(m1)
    dq_rows, de_rows = N * (m2 // ns), N * (m1 // ms)
    if max(dq_rows, de_rows) > threads:
        raise ValueError(f'cg_aggregate_edge_fused_ri_bwd: N={N}, M1={m1}, '
                         f'M2={m2} give a block more than {threads} outputs')
    mc = min(_pow2_floor(min(threads // dq_rows, m1)), WARP)
    nc = min(_pow2_floor(min(threads // de_rows, m2)), WARP)
    plan = dict(ns=ns, ms=ms, mc=mc, m_chunk=-(-m1 // mc), nc=nc,
                n_chunk=-(-m2 // nc))
    plan['m2_stride'] = min(range(m2, m2 + 9), key=lambda stride: dz_conflicts(
        N, m1, m2, stride, threads, **plan))
    rows = N
    while rows > 1 and aggregate_bwd_smem(
            N, n_l, m1, m2, k, n_groups, n_ent, rows,
            plan['m2_stride']) > BWD_SMEM_TARGET:
        rows -= 1
    plan['rows'] = -(-N // -(-N // rows))
    return plan


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aggregate_fwd_kernel(sph_packed, rad_feats, atom_r, atom_i, table3,
                          grouped):
    name = 'cg_aggregate_edge_fused_ri'
    operands = (sph_packed, rad_feats, atom_r, atom_i)
    device = check_cuda_operands(name, operands, DTYPES)
    dtype = atom_r.dtype
    B, N, tau, n_l, m1, m2 = _aggregate_shapes(name, *operands, table3)
    tabs = _kernel_tables('aggregate', table3, grouped, None, device)
    k = tabs['k']
    n_groups, n_ent = tabs['fwd_ptr'].shape[0] - 1, tabs['fwd_ent'].shape[0]
    tile_t = aggregate_fwd_tile(B, N, tau, m1, m2, n_groups, n_ent,
                                _num_sms(device))
    smem = aggregate_fwd_smem(N, tile_t, m1, m2, n_groups, n_ent)
    if smem > MAX_SMEM:
        raise ValueError(f'{name}: N={N}, M1={m1}, M2={m2}, K={k} with '
                         f'{tile_t} channels a block need {smem} bytes of '
                         'shared memory, more than a block has')
    out_r = torch.empty((B, N, tau, k), dtype=dtype, device=device)
    out_i = torch.empty_like(out_r)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _entry(_aggregate_lib(), 'cg_aggregate_edge_fused', dtype)(
        *ptrs(*operands, tabs['fwd_ptr'], tabs['fwd_ent'], out_r, out_i),
        B, N, tau, n_l, m1, m2, k, n_groups, n_ent, tile_t, strip_of(m2),
        FWD_THREADS, smem, stream)
    raise_on(err, name)
    launch_counts[_counter(name, dtype)] += 1
    return out_r, out_i


def _aggregate_bwd_kernel(sph_packed, rad_feats, atom_r, atom_i, g_r, g_i,
                          table3, grouped):
    name = 'cg_aggregate_edge_fused_ri_bwd'
    operands = (sph_packed, rad_feats, atom_r, atom_i, g_r, g_i)
    device = check_cuda_operands(name, operands, DTYPES)
    dtype = atom_r.dtype
    B, N, tau, n_l, m1, m2 = _aggregate_shapes(name, *operands[:4], table3)
    tabs = _kernel_tables('aggregate', table3, grouped, None, device)
    k = tabs['k']
    if tuple(g_r.shape) != (B, N, tau, k) or g_i.shape != g_r.shape:
        raise ValueError(f'{name}: gradients {tuple(g_r.shape)} / '
                         f'{tuple(g_i.shape)}, expected {(B, N, tau, k)}')
    n_groups, n_ent = tabs['bwd_ptr'].shape[0] - 1, tabs['bwd_ent'].shape[0]
    plan = _bwd_plan(N, n_l, m1, m2, k, n_groups, n_ent)
    if dtype == torch.bfloat16 and plan['ns'] not in (1, plan['ms']):
        raise ValueError(f'{name}: the bf16 kernel is built for atom reps of '
                         f'one l or as wide as the harmonics, not M1={m1}, '
                         f'M2={m2}')
    smem = aggregate_bwd_smem(N, n_l, m1, m2, k, n_groups, n_ent,
                              plan['rows'], plan['m2_stride'])
    if smem > MAX_SMEM:
        raise ValueError(f'{name}: N={N}, M1={m1}, M2={m2}, K={k} need '
                         f'{smem} bytes of shared memory, more than a block '
                         'has')
    drad = torch.empty_like(rad_feats)
    dq_r = torch.empty_like(atom_r)
    dq_i = torch.empty_like(atom_i)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _entry(_aggregate_bwd_lib(), 'cg_aggregate_bwd', dtype)(
        *ptrs(*operands, tabs['bwd_ptr'], tabs['bwd_row'], tabs['bwd_ent'],
               drad, dq_r, dq_i), B, N, tau, n_l, m1, m2, k, n_groups, n_ent,
        plan['rows'], plan['m2_stride'], plan['ns'], plan['ms'], plan['mc'],
        plan['nc'], BWD_THREADS, smem, stream)
    raise_on(err, name)
    launch_counts[_counter(name, dtype)] += 1
    return drad, dq_r, dq_i


def aggregate_kernel_resources(B, N, tau, n_l, m2, table3, grouped, device):
    """What the two kernels take at these shapes: the host's choices, shared
    bytes and resident blocks per SM of each (asked of the built
    libraries), for a log line."""
    m1 = n_l * n_l
    tabs = _kernel_tables('aggregate', table3, grouped, None, device)
    fwd, bwd = _aggregate_lib(), _aggregate_bwd_lib()
    g_f, e_f = tabs['fwd_ptr'].shape[0] - 1, tabs['fwd_ent'].shape[0]
    g_b, e_b = tabs['bwd_ptr'].shape[0] - 1, tabs['bwd_ent'].shape[0]
    tile_t = aggregate_fwd_tile(B, N, tau, m1, m2, g_f, e_f, _num_sms(device))
    smem_f = aggregate_fwd_smem(N, tile_t, m1, m2, g_f, e_f)
    plan = aggregate_bwd_plan(N, n_l, m1, m2, tabs['k'], g_b, e_b)
    smem_b = aggregate_bwd_smem(N, n_l, m1, m2, tabs['k'], g_b, e_b,
                                plan['rows'], plan['m2_stride'])
    return dict(
        fwd=dict(tile_t=tile_t, threads=FWD_THREADS, smem=smem_f,
                 blocks_per_sm=fwd.cg_aggregate_blocks_per_sm(
                     strip_of(m2), FWD_THREADS, smem_f)),
        bwd=dict(plan, threads=BWD_THREADS, smem=smem_b,
                 blocks_per_sm=bwd.cg_aggregate_bwd_blocks_per_sm(
                     plan['ns'], plan['ms'], BWD_THREADS, smem_b)))


class _AggregateFn(torch.autograd.Function):
    """Forward and backward kernels of the aggregate. Saves the inputs, not
    the pair tensor z: the backward kernel rebuilds the edge rep."""

    @staticmethod
    def forward(ctx, sph_packed, rad_feats, atom_r, atom_i, table3, grouped):
        out_r, out_i = _aggregate_fwd_kernel(sph_packed, rad_feats, atom_r,
                                             atom_i, table3, grouped)
        ctx.save_for_backward(sph_packed, rad_feats, atom_r, atom_i)
        ctx.tables = (table3, grouped)
        ctx.out_shape = out_r.shape
        return out_r, out_i

    @staticmethod
    @once_differentiable
    def backward(ctx, g_r, g_i):
        sph_packed, rad_feats, atom_r, atom_i = ctx.saved_tensors
        shape = ctx.out_shape
        drad, dq_r, dq_i = _aggregate_bwd_kernel(
            sph_packed, rad_feats, atom_r, atom_i,
            incoming(g_r, shape, atom_r), incoming(g_i, shape, atom_r),
            *ctx.tables)
        return None, drad, dq_r, dq_i, None, None


def cg_aggregate_edge_fused_ri(sph_packed: torch.Tensor,
                               rad_feats: torch.Tensor,
                               atom_r: torch.Tensor, atom_i: torch.Tensor,
                               table3: np.ndarray, grouped=None):
    """Fused edge build + CG aggregate, complex parts as separate tensors.

    sph_packed    [B, N, N, M1, 2]  conj relative SH (no gradient)
    rad_feats     [B, N, N, tau, L] gated radial features
    atom_r/atom_i [B, N, tau, M2]   packed atom rep, real / imag
    table3        [M1, M2, K] combined CG block table (cg._fused_cg_table)
    grouped       optional (tables, perm) from cg.fused_cg_table_grouped:
                  the output K axis is then PERMUTED l1-major.
    returns (out_r, out_i), each [B, N, tau, K], in the operands' one dtype
    (float32 or bfloat16).
    """
    operand_dtype('cg_aggregate_edge_fused_ri',
                  (sph_packed, rad_feats, atom_r, atom_i), DTYPES)
    sph_packed = sph_packed.detach()
    if sph_packed.device.type == 'cpu':
        return cg_aggregate_edge_fused_ri_plain(sph_packed, rad_feats, atom_r,
                                                atom_i, table3, grouped)
    return _AggregateFn.apply(sph_packed, rad_feats, atom_r, atom_i, table3,
                              grouped)


# ---------------------------------------------------------------------------
# CG square
# ---------------------------------------------------------------------------

def cg_square_fused_ri_plain(a_r: torch.Tensor, a_i: torch.Tensor,
                             table3: np.ndarray, grouped=None, tri=None):
    """Plain PyTorch version of cg_square_fused_ri: the pair products in
    memory, then the block contraction, in f32; outputs in the operands'
    dtype."""
    dtype = a_r.dtype
    a_r, a_i = _f32(a_r, a_i)
    pairs, blocks = _plain_tables('square', table3, grouped, tri, a_r.device)
    pm, pn = pairs[:, 0], pairs[:, 1]
    xr, xi = a_r[..., pm], a_i[..., pm]
    yr, yi = a_r[..., pn], a_i[..., pn]
    out_r, out_i = _contract(xr * yr - xi * yi, xr * yi + xi * yr, blocks)
    return out_r.to(dtype), out_i.to(dtype)


def cg_square_fused_ri_bwd_plain(a_r: torch.Tensor, a_i: torch.Tensor,
                                 g_r: torch.Tensor, g_i: torch.Tensor,
                                 table3: np.ndarray, grouped=None, tri=None):
    """The square's vector-Jacobian product from its formula, given the
    output gradients g_r/g_i [..., K]: (d a_r, d a_i) [..., M]. The rep is
    both operands of every pair (m, n), so both product-rule terms land on
    it, and a diagonal pair (m, m) contributes twice:

        dz[..., p] = sum_k C[p, k] g[..., k]
        d a[m_p]  += dz[p] conj(a[n_p]),   d a[n_p] += dz[p] conj(a[m_p])

    in f32; the gradients in the operands' dtype.
    """
    dtype = a_r.dtype
    a_r, a_i, g_r, g_i = _f32(a_r, a_i, g_r, g_i)
    pairs, blocks = _plain_tables('square', table3, grouped, tri, a_r.device)
    dz_r, dz_i = _contract_t(g_r, g_i, blocks, pairs.shape[0])
    pm, pn = pairs[:, 0], pairs[:, 1]
    xr, xi = a_r[..., pm], a_i[..., pm]
    yr, yi = a_r[..., pn], a_i[..., pn]
    da_r = (a_r.new_zeros(a_r.shape)
            .index_add_(-1, pm, dz_r * yr + dz_i * yi)
            .index_add_(-1, pn, dz_r * xr + dz_i * xi))
    da_i = (a_i.new_zeros(a_i.shape)
            .index_add_(-1, pm, dz_i * yr - dz_r * yi)
            .index_add_(-1, pn, dz_i * xr - dz_r * xi))
    return da_r.to(dtype), da_i.to(dtype)


def _square_shapes(name, a_r, a_i, table3):
    m = a_r.shape[-1]
    if a_i.shape != a_r.shape or tuple(table3.shape[:2]) != (m, m):
        raise ValueError(f'{name}: inconsistent shapes a '
                         f'{tuple(a_r.shape)} / {tuple(a_i.shape)} table '
                         f'{table3.shape}')
    return m, tuple(a_r.shape[:-1])


# How the square's kernels cut their work (csrc/cg_square.cu,
# csrc/cg_square_bwd.cu): the forward's tiles of R rows (it is compiled for
# these), chosen on the host from the shapes alone; the backward's tile of
# 2 rows and block of 128 threads, fixed in its source.

SQUARE_FWD_ROWS = (4, 2, 1)
SQUARE_BWD_ROWS = 2
# what a forward block may take of an SM's shared memory before its tile of
# rows is cut: four blocks fit an SM
SQUARE_FWD_SMEM_TARGET = 48 * 1024


def square_slot_stride(rows: int) -> int:
    """float2 per slot of z, dz and a for a tile of `rows` rows: 16-byte
    multiples (8 bytes for one row), padded by two at 4 rows so that slot s
    starts on bank group 3 s mod 8, as it starts on s mod 8 at 2 rows."""
    return rows + 2 if rows >= 4 else rows


def _padded_row(k: int) -> int:
    """floats a shared row of k values takes with the slack of its 16-byte
    copy (at most 3 floats before it)"""
    return ((k + 3) // 4 + 1) * 4


def square_fwd_smem(rows, m, n_groups, n_ent, n_slots) -> int:
    """Shared bytes of one forward block, the sum of what the kernel lays
    out: the packed table, z of the tile, a of two tiles, the group offsets,
    the group order, the pair of each slot."""
    zs = square_slot_stride(rows)
    return (_align16(8 * n_ent) + _align16(8 * n_slots * zs) +
            2 * _align16(8 * m * zs) + _align16(4 * (n_groups + 1)) +
            _align16(4 * n_groups) + _align16(4 * n_slots))


def square_bwd_smem(m, k, n_groups, n_ent, line_len) -> int:
    """Shared bytes of one backward block, the sum of what the kernel lays
    out: the packed table, dz of the tile (32 slots a group and the slot of
    zeros), g and a of two tiles, the group offsets, the incidence table."""
    rows = SQUARE_BWD_ROWS
    zs = square_slot_stride(rows)
    return (_align16(8 * n_ent) + _align16(8 * (WARP * n_groups + 1) * zs) +
            2 * 4 * rows * 2 * _padded_row(k) + 2 * _align16(8 * m * zs) +
            _align16(4 * (n_groups + 1)) + _align16(4 * m * line_len))


@functools.lru_cache(maxsize=None)
def square_fwd_plan(n_rows, m, n_groups, n_ent, n_slots, num_sms) -> dict:
    """How the forward cuts `n_rows` rows (computed once per set of
    arguments; the caller gets the same dict): `rows` per tile, the most
    that still gives every SM two tiles and keeps a block under its target
    (4 at the update's batch, 2 at SF6's rollout batch, 1 at an
    evaluation's), a warp per group of 32 columns (at most 8), and the
    block's shared bytes."""
    rows = next((r for r in SQUARE_FWD_ROWS[:-1]
                 if -(-n_rows // r) >= 2 * num_sms
                 and square_fwd_smem(r, m, n_groups, n_ent, n_slots)
                 <= SQUARE_FWD_SMEM_TARGET), 1)
    return dict(rows=rows, threads=WARP * min(FWD_THREADS // WARP, n_groups),
                smem=square_fwd_smem(rows, m, n_groups, n_ent, n_slots))


def _square_fwd_plan(n_rows, m, tabs, device):
    return square_fwd_plan(n_rows, m, tabs['fwd_ptr'].shape[0] - 1,
                           tabs['fwd_ent'].shape[0], tabs['slot_mn'].shape[0],
                           _num_sms(device))


def _square_bwd_smem(m, tabs):
    return square_bwd_smem(m, tabs['k'], tabs['bwd_ptr'].shape[0] - 1,
                           tabs['bwd_ent'].shape[0], tabs['inc'].shape[1])


def _square_fwd_kernel(a_r, a_i, table3, grouped, tri):
    name = 'cg_square_fused_ri'
    device = check_cuda_operands(name, (a_r, a_i), DTYPES)
    dtype = a_r.dtype
    m, batch = _square_shapes(name, a_r, a_i, table3)
    tabs = _kernel_tables('square', table3, grouped, tri, device)
    n_rows, k = math.prod(batch), tabs['k']
    plan = _square_fwd_plan(n_rows, m, tabs, device)
    if plan['smem'] > MAX_SMEM:
        raise ValueError(f'{name}: M={m}, K={k} with {plan["rows"]} rows a '
                         f'tile need {plan["smem"]} bytes of shared memory, '
                         'more than a block has')
    out_r = torch.empty(batch + (k, ), dtype=dtype, device=device)
    out_i = torch.empty_like(out_r)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _entry(_square_lib(), 'cg_square_fused', dtype)(
        *ptrs(a_r, a_i, tabs['slot_mn'], tabs['fwd_ptr'], tabs['fwd_seq'],
              tabs['fwd_ent'], out_r, out_i),
        n_rows, m, k, tabs['fwd_ptr'].shape[0] - 1, tabs['fwd_ent'].shape[0],
        tabs['slot_mn'].shape[0], plan['rows'], plan['threads'], plan['smem'],
        stream)
    raise_on(err, name)
    launch_counts[_counter(name, dtype)] += 1
    return out_r, out_i


def _square_bwd_kernel(a_r, a_i, g_r, g_i, table3, grouped, tri):
    name = 'cg_square_fused_ri_bwd'
    device = check_cuda_operands(name, (a_r, a_i, g_r, g_i), DTYPES)
    dtype = a_r.dtype
    m, batch = _square_shapes(name, a_r, a_i, table3)
    tabs = _kernel_tables('square', table3, grouped, tri, device)
    k = tabs['k']
    if tuple(g_r.shape) != batch + (k, ) or g_i.shape != g_r.shape:
        raise ValueError(f'{name}: gradients {tuple(g_r.shape)} / '
                         f'{tuple(g_i.shape)}, expected {batch + (k, )}')
    if m > 256:
        raise ValueError(f'{name}: M={m}, more slots than the incidence '
                         'table can name')
    smem = _square_bwd_smem(m, tabs)
    if smem > MAX_SMEM:
        raise ValueError(f'{name}: M={m}, K={k} need {smem} bytes of shared '
                         'memory, more than a block has')
    da_r = torch.empty_like(a_r)
    da_i = torch.empty_like(a_i)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _entry(_square_bwd_lib(), 'cg_square_bwd', dtype)(
        *ptrs(a_r, a_i, g_r, g_i, tabs['bwd_ptr'], tabs['bwd_ent'],
              tabs['inc'], da_r, da_i),
        math.prod(batch), m, k, tabs['bwd_ptr'].shape[0] - 1,
        tabs['bwd_ent'].shape[0], tabs['inc'].shape[1], smem, stream)
    raise_on(err, name)
    launch_counts[_counter(name, dtype)] += 1
    return da_r, da_i


def square_kernel_resources(n_rows, table3, grouped, tri, device):
    """What the two kernels take for `n_rows` rows: the forward's plan, the
    backward's shared bytes, and the resident blocks per SM of each (asked
    of the built libraries), for a log line."""
    tabs = _kernel_tables('square', table3, grouped, tri, device)
    fwd = _square_fwd_plan(n_rows, table3.shape[0], tabs, device)
    smem = _square_bwd_smem(table3.shape[0], tabs)
    return dict(
        fwd=dict(fwd, blocks_per_sm=_square_lib().cg_square_blocks_per_sm(
            fwd['rows'], fwd['threads'], fwd['smem'])),
        bwd=dict(rows=SQUARE_BWD_ROWS, smem=smem,
                 blocks_per_sm=_square_bwd_lib().cg_square_bwd_blocks_per_sm(
                     smem)))


class _SquareFn(torch.autograd.Function):
    """Forward and backward kernels of the CG square; saves the rep."""

    @staticmethod
    def forward(ctx, a_r, a_i, table3, grouped, tri):
        out_r, out_i = _square_fwd_kernel(a_r, a_i, table3, grouped, tri)
        ctx.save_for_backward(a_r, a_i)
        ctx.tables = (table3, grouped, tri)
        ctx.out_shape = out_r.shape
        return out_r, out_i

    @staticmethod
    @once_differentiable
    def backward(ctx, g_r, g_i):
        a_r, a_i = ctx.saved_tensors
        shape = ctx.out_shape
        da_r, da_i = _square_bwd_kernel(a_r, a_i, incoming(g_r, shape, a_r),
                                        incoming(g_i, shape, a_r),
                                        *ctx.tables)
        return da_r, da_i, None, None, None


def cg_square_fused_ri(a_r: torch.Tensor, a_i: torch.Tensor,
                       table3: np.ndarray, grouped=None, tri=None):
    """CG self-product of a packed rep (the level's "CG square").

    a_r/a_i  [..., tau, M] packed rep (complex parts separate)
    table3   [M, M, K] combined CG table (cg._fused_cg_table(n, n, maxl))
    grouped  optional (tables, perm) from cg.fused_cg_table_grouped(n, n,
             maxl): K axis PERMUTED l1-major.
    tri      optional (pairs, groups) from cg.fused_cg_table_tri(n, maxl):
             only the M(M+1)/2 tri pairs, K axis PERMUTED lmin-major. Takes
             precedence over `grouped`.
    returns (out_r, out_i), each [..., tau, K], in the operands' one dtype
    (float32 or bfloat16).
    """
    operand_dtype('cg_square_fused_ri', (a_r, a_i), DTYPES)
    if a_r.device.type == 'cpu':
        return cg_square_fused_ri_plain(a_r, a_i, table3, grouped, tri)
    return _SquareFn.apply(a_r, a_i, table3, grouped, tri)
