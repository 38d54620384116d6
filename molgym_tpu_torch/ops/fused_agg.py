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
"""
from __future__ import annotations

import ctypes
import functools
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
                                                ptrs, raise_on,
                                                reset_launch_counts,
                                                table_cache)

# (row_a, row_b, table [row_b - row_a, K_g]) blocks of a contraction: output
# columns are the blocks' columns in order, each contracting z[..., a:b].
Blocks = List[Tuple[int, int, np.ndarray]]


# ---------------------------------------------------------------------------
# contraction tables: the same blocks feed the plain version (as dense
# sub-tables) and the kernels (as compressed sparse columns for the forward,
# compressed sparse rows for the backward)
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


def _kernel_tables(kind, table3, grouped, tri, device):
    def build():
        if kind == 'aggregate':
            pairs, blocks = None, _aggregate_blocks(table3, grouped)
            n_pairs = table3.shape[0] * table3.shape[1]
        else:
            pairs, blocks = _square_blocks(table3, grouped, tri)
            n_pairs = pairs.shape[0]
        colptr, pair, coef = sparse_columns(blocks)
        rowptr, col, coef_t = sparse_rows(blocks, n_pairs)
        out = {'colptr': _to(colptr, device), 'pair': _to(pair, device),
               'coef': _to(coef, device), 'k': int(colptr.shape[0] - 1),
               'rowptr': _to(rowptr, device), 'col': _to(col, device),
               'coef_t': _to(coef_t, device)}
        if pairs is not None:
            out['pair_m'] = _to(pairs[:, 0].astype(np.int32), device)
            out['pair_n'] = _to(pairs[:, 1].astype(np.int32), device)
            mptr, inc_pair, inc_other = pair_incidence(pairs, table3.shape[0])
            out['mptr'] = _to(mptr, device)
            out['inc_pair'] = _to(inc_pair, device)
            out['inc_other'] = _to(inc_other, device)
        return out
    return table_cache.get(('kernel', kind), _flat_arrays(table3, grouped, tri),
                      device, build)


@functools.lru_cache(maxsize=None)
def _l_of_m(n_ells: int, device: torch.device) -> torch.Tensor:
    """l of each packed m slot: [0, 1, 1, 1, 2, ...], on `device`."""
    return torch.tensor([l for l in range(n_ells) for _ in range(2 * l + 1)],
                        device=device)


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


@functools.lru_cache(maxsize=None)
def _aggregate_lib() -> ctypes.CDLL:
    lib = cuda_build.load('cg_aggregate')
    lib.cg_aggregate_edge_fused_f32.argtypes = [_P] * 9 + [_I] * 7 + [_P]
    lib.cg_aggregate_edge_fused_f32.restype = _I
    lib.cg_aggregate_smem_bytes.argtypes = [_I] * 4
    lib.cg_aggregate_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _aggregate_bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load('cg_aggregate_bwd')
    lib.cg_aggregate_bwd_f32.argtypes = [_P] * 12 + [_I] * 7 + [_P]
    lib.cg_aggregate_bwd_f32.restype = _I
    lib.cg_aggregate_bwd_smem_bytes.argtypes = [_I] * 4
    lib.cg_aggregate_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _square_lib() -> ctypes.CDLL:
    lib = cuda_build.load('cg_square')
    lib.cg_square_fused_f32.argtypes = [_P] * 9 + [_I] * 4 + [_P]
    lib.cg_square_fused_f32.restype = _I
    lib.cg_square_smem_bytes.argtypes = [_I] * 2
    lib.cg_square_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _square_bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load('cg_square_bwd')
    lib.cg_square_bwd_f32.argtypes = [_P] * 12 + [_I] * 4 + [_P]
    lib.cg_square_bwd_f32.restype = _I
    lib.cg_square_bwd_smem_bytes.argtypes = [_I] * 3
    lib.cg_square_bwd_smem_bytes.restype = ctypes.c_size_t
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
    rep and the [.., tau, M1*M2] pair tensor z in memory, then contracts."""
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
    return _contract(z_r, z_i, blocks)


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
    """
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
    return drad, dq_r, dq_i


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


def _aggregate_fwd_kernel(sph_packed, rad_feats, atom_r, atom_i, table3,
                          grouped):
    name = 'cg_aggregate_edge_fused_ri'
    operands = (sph_packed, rad_feats, atom_r, atom_i)
    device = check_cuda_operands(name, operands)
    B, N, tau, n_l, m1, m2 = _aggregate_shapes(name, *operands, table3)
    lib = _aggregate_lib()
    if lib.cg_aggregate_smem_bytes(N, tau, m1, m2) > MAX_SMEM:
        raise ValueError(f'{name}: N={N}, tau={tau}, M1={m1}, M2={m2} need '
                         'more shared memory than a block has')
    tabs = _kernel_tables('aggregate', table3, grouped, None, device)
    k = tabs['k']
    out_r = torch.empty((B, N, tau, k), dtype=torch.float32, device=device)
    out_i = torch.empty_like(out_r)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.cg_aggregate_edge_fused_f32(
        *ptrs(*operands, tabs['colptr'], tabs['pair'], tabs['coef'], out_r,
               out_i), B, N, tau, n_l, m1, m2, k, stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return out_r, out_i


def _aggregate_bwd_kernel(sph_packed, rad_feats, atom_r, atom_i, g_r, g_i,
                          table3, grouped):
    name = 'cg_aggregate_edge_fused_ri_bwd'
    operands = (sph_packed, rad_feats, atom_r, atom_i, g_r, g_i)
    device = check_cuda_operands(name, operands)
    B, N, tau, n_l, m1, m2 = _aggregate_shapes(name, *operands[:4], table3)
    tabs = _kernel_tables('aggregate', table3, grouped, None, device)
    k = tabs['k']
    if tuple(g_r.shape) != (B, N, tau, k) or g_i.shape != g_r.shape:
        raise ValueError(f'{name}: gradients {tuple(g_r.shape)} / '
                         f'{tuple(g_i.shape)}, expected {(B, N, tau, k)}')
    lib = _aggregate_bwd_lib()
    if lib.cg_aggregate_bwd_smem_bytes(N, m1, m2, k) > MAX_SMEM:
        raise ValueError(f'{name}: N={N}, M1={m1}, M2={m2}, K={k} need more '
                         'shared memory than a block has')
    drad = torch.empty_like(rad_feats)
    dq_r = torch.empty_like(atom_r)
    dq_i = torch.empty_like(atom_i)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.cg_aggregate_bwd_f32(
        *ptrs(*operands, tabs['rowptr'], tabs['col'], tabs['coef_t'], drad,
               dq_r, dq_i), B, N, tau, n_l, m1, m2, k, stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return drad, dq_r, dq_i


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
    returns (out_r, out_i), each [B, N, tau, K].
    """
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
    memory, then the block contraction."""
    pairs, blocks = _plain_tables('square', table3, grouped, tri, a_r.device)
    pm, pn = pairs[:, 0], pairs[:, 1]
    xr, xi = a_r[..., pm], a_i[..., pm]
    yr, yi = a_r[..., pn], a_i[..., pn]
    return _contract(xr * yr - xi * yi, xr * yi + xi * yr, blocks)


def cg_square_fused_ri_bwd_plain(a_r: torch.Tensor, a_i: torch.Tensor,
                                 g_r: torch.Tensor, g_i: torch.Tensor,
                                 table3: np.ndarray, grouped=None, tri=None):
    """The square's vector-Jacobian product from its formula, given the
    output gradients g_r/g_i [..., K]: (d a_r, d a_i) [..., M]. The rep is
    both operands of every pair (m, n), so both product-rule terms land on
    it, and a diagonal pair (m, m) contributes twice:

        dz[..., p] = sum_k C[p, k] g[..., k]
        d a[m_p]  += dz[p] conj(a[n_p]),   d a[n_p] += dz[p] conj(a[m_p])
    """
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
    return da_r, da_i


def _square_shapes(name, a_r, a_i, table3):
    m = a_r.shape[-1]
    if a_i.shape != a_r.shape or tuple(table3.shape[:2]) != (m, m):
        raise ValueError(f'{name}: inconsistent shapes a '
                         f'{tuple(a_r.shape)} / {tuple(a_i.shape)} table '
                         f'{table3.shape}')
    return m, tuple(a_r.shape[:-1])


def _square_fwd_kernel(a_r, a_i, table3, grouped, tri):
    name = 'cg_square_fused_ri'
    device = check_cuda_operands(name, (a_r, a_i))
    m, batch = _square_shapes(name, a_r, a_i, table3)
    tabs = _kernel_tables('square', table3, grouped, tri, device)
    n_pairs = tabs['pair_m'].shape[0]
    lib = _square_lib()
    if lib.cg_square_smem_bytes(m, n_pairs) > MAX_SMEM:
        raise ValueError(f'{name}: M={m} with {n_pairs} pairs needs more '
                         'shared memory than a block has')
    k = tabs['k']
    out_r = torch.empty(batch + (k, ), dtype=torch.float32, device=device)
    out_i = torch.empty_like(out_r)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.cg_square_fused_f32(
        *ptrs(a_r, a_i, tabs['pair_m'], tabs['pair_n'], tabs['colptr'],
               tabs['pair'], tabs['coef'], out_r, out_i),
        int(np.prod(batch)), m, n_pairs, k, stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return out_r, out_i


def _square_bwd_kernel(a_r, a_i, g_r, g_i, table3, grouped, tri):
    name = 'cg_square_fused_ri_bwd'
    device = check_cuda_operands(name, (a_r, a_i, g_r, g_i))
    m, batch = _square_shapes(name, a_r, a_i, table3)
    tabs = _kernel_tables('square', table3, grouped, tri, device)
    k = tabs['k']
    if tuple(g_r.shape) != batch + (k, ) or g_i.shape != g_r.shape:
        raise ValueError(f'{name}: gradients {tuple(g_r.shape)} / '
                         f'{tuple(g_i.shape)}, expected {batch + (k, )}')
    n_pairs = tabs['pair_m'].shape[0]
    lib = _square_bwd_lib()
    if lib.cg_square_bwd_smem_bytes(m, n_pairs, k) > MAX_SMEM:
        raise ValueError(f'{name}: M={m}, {n_pairs} pairs, K={k} need more '
                         'shared memory than a block has')
    da_r = torch.empty_like(a_r)
    da_i = torch.empty_like(a_i)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.cg_square_bwd_f32(
        *ptrs(a_r, a_i, g_r, g_i, tabs['rowptr'], tabs['col'],
               tabs['coef_t'], tabs['mptr'], tabs['inc_pair'],
               tabs['inc_other'], da_r, da_i),
        int(np.prod(batch)), m, n_pairs, k, stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return da_r, da_i


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
    returns (out_r, out_i), each [..., tau, K].
    """
    if a_r.device.type == 'cpu':
        return cg_square_fused_ri_plain(a_r, a_i, table3, grouped, tri)
    return _SquareFn.apply(a_r, a_i, table3, grouped, tri)
