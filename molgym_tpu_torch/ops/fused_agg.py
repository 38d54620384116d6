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
calls the plain PyTorch version beside it (`*_plain`), on a CUDA tensor it
launches the hand-written kernel (csrc/cg_aggregate.cu, csrc/cg_square.cu)
or raises. `launch_counts` counts kernel launches only, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from molgym_tpu_torch import cuda_build

launch_counts: Dict[str, int] = {'cg_aggregate_edge_fused_ri': 0,
                                 'cg_square_fused_ri': 0}

# what one thread block may hold (H100: 227 KB of the SM's shared memory)
_MAX_SMEM = 232448

# (row_a, row_b, table [row_b - row_a, K_g]) blocks of a contraction: output
# columns are the blocks' columns in order, each contracting z[..., a:b].
Blocks = List[Tuple[int, int, np.ndarray]]


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# contraction tables: the same blocks feed the plain version (as dense
# sub-tables) and the kernels (as one compressed-sparse-column table)
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


class _TableCache:
    """Device tensors derived from host tables, built once per (tables,
    device). Keyed by the ids of the host arrays, which the entry keeps
    alive so that no other array can take their ids while it exists; the
    table builders are lru-cached, so callers pass the same arrays each
    call."""

    def __init__(self):
        self._entries = {}

    def get(self, tag, arrays, device, build):
        key = (tag, tuple(id(a) for a in arrays), str(device))
        entry = self._entries.get(key)
        if entry is None:
            entry = (arrays, build())
            self._entries[key] = entry
        return entry[1]


_cache = _TableCache()


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
    return _cache.get(('plain', kind), _flat_arrays(table3, grouped, tri),
                      device, build)


def _kernel_tables(kind, table3, grouped, tri, device):
    def build():
        if kind == 'aggregate':
            pairs, blocks = None, _aggregate_blocks(table3, grouped)
        else:
            pairs, blocks = _square_blocks(table3, grouped, tri)
        colptr, pair, coef = sparse_columns(blocks)
        out = {'colptr': _to(colptr, device), 'pair': _to(pair, device),
               'coef': _to(coef, device), 'k': int(colptr.shape[0] - 1)}
        if pairs is not None:
            out['pair_m'] = _to(pairs[:, 0].astype(np.int32), device)
            out['pair_n'] = _to(pairs[:, 1].astype(np.int32), device)
        return out
    return _cache.get(('kernel', kind), _flat_arrays(table3, grouped, tri),
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
def _square_lib() -> ctypes.CDLL:
    lib = cuda_build.load('cg_square')
    lib.cg_square_fused_f32.argtypes = [_P] * 9 + [_I] * 4 + [_P]
    lib.cg_square_fused_f32.restype = _I
    lib.cg_square_smem_bytes.argtypes = [_I] * 2
    lib.cg_square_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check_cuda_operands(name, tensors):
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f'{name}: operands on {t.device} and {device}')
        if t.dtype != torch.float32:
            raise TypeError(f'{name}: the kernel takes float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: the kernel takes contiguous tensors')
    return device


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{err}')


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


def cg_aggregate_edge_fused_ri(sph_packed: torch.Tensor,
                               rad_feats: torch.Tensor,
                               atom_r: torch.Tensor, atom_i: torch.Tensor,
                               table3: np.ndarray, grouped=None):
    """Fused edge build + CG aggregate, complex parts as separate tensors.

    sph_packed    [B, N, N, M1, 2]  conj relative SH
    rad_feats     [B, N, N, tau, L] gated radial features
    atom_r/atom_i [B, N, tau, M2]   packed atom rep, real / imag
    table3        [M1, M2, K] combined CG block table (cg._fused_cg_table)
    grouped       optional (tables, perm) from cg.fused_cg_table_grouped:
                  the output K axis is then PERMUTED l1-major.
    returns (out_r, out_i), each [B, N, tau, K].
    """
    if sph_packed.device.type == 'cpu':
        return cg_aggregate_edge_fused_ri_plain(sph_packed, rad_feats, atom_r,
                                                atom_i, table3, grouped)
    name = 'cg_aggregate_edge_fused_ri'
    device = _check_cuda_operands(name, (sph_packed, rad_feats, atom_r,
                                         atom_i))
    if device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {device}')
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
    lib = _aggregate_lib()
    if lib.cg_aggregate_smem_bytes(N, tau, m1, m2) > _MAX_SMEM:
        raise ValueError(f'{name}: N={N}, tau={tau}, M1={m1}, M2={m2} need '
                         'more shared memory than a block has')
    tabs = _kernel_tables('aggregate', table3, grouped, None, device)
    k = tabs['k']
    out_r = torch.empty((B, N, tau, k), dtype=torch.float32, device=device)
    out_i = torch.empty_like(out_r)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.cg_aggregate_edge_fused_f32(
        sph_packed.data_ptr(), rad_feats.data_ptr(), atom_r.data_ptr(),
        atom_i.data_ptr(), tabs['colptr'].data_ptr(), tabs['pair'].data_ptr(),
        tabs['coef'].data_ptr(), out_r.data_ptr(), out_i.data_ptr(),
        B, N, tau, n_l, m1, m2, k, stream)
    _raise_on(err, name)
    launch_counts[name] += 1
    return out_r, out_i


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
    name = 'cg_square_fused_ri'
    device = _check_cuda_operands(name, (a_r, a_i))
    if device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {device}')
    m = a_r.shape[-1]
    if a_i.shape != a_r.shape or tuple(table3.shape[:2]) != (m, m):
        raise ValueError(f'{name}: inconsistent shapes a '
                         f'{tuple(a_r.shape)} / {tuple(a_i.shape)} table '
                         f'{table3.shape}')
    tabs = _kernel_tables('square', table3, grouped, tri, device)
    n_pairs = tabs['pair_m'].shape[0]
    lib = _square_lib()
    if lib.cg_square_smem_bytes(m, n_pairs) > _MAX_SMEM:
        raise ValueError(f'{name}: M={m} with {n_pairs} pairs needs more '
                         'shared memory than a block has')
    k = tabs['k']
    batch = tuple(a_r.shape[:-1])
    rows = int(np.prod(batch))
    out_r = torch.empty(batch + (k, ), dtype=torch.float32, device=device)
    out_i = torch.empty_like(out_r)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.cg_square_fused_f32(
        a_r.data_ptr(), a_i.data_ptr(), tabs['pair_m'].data_ptr(),
        tabs['pair_n'].data_ptr(), tabs['colptr'].data_ptr(),
        tabs['pair'].data_ptr(), tabs['coef'].data_ptr(), out_r.data_ptr(),
        out_i.data_ptr(), rows, m, n_pairs, k, stream)
    _raise_on(err, name)
    launch_counts[name] += 1
    return out_r, out_i
