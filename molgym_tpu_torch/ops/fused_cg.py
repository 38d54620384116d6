"""The channel-wise packed CG product and its backward (counterpart of
molgym_tpu/ops/pallas_cg.py):

    out[..., t, k] = sum_{m,n} C[m, n, k] a[..., t, m] b[..., t, n]

with complex a and b as separate real/imag tensors and a real table. The
output K order is the table's (cg._fused_cg_table's dense order).

`cg_contract_ri` dispatches on the device of its tensors: on the CPU it
calls the plain PyTorch version `cg_contract_ri_plain`, which autograd
differentiates; on a CUDA tensor it runs a `torch.autograd.Function` whose
forward launches csrc/cg_product.cu and whose backward launches
csrc/cg_product_bwd.cu, or raises. `cg_contract_ri_bwd_plain` computes the
same vector-Jacobian product from its formula. The kernels read the table
as compressed sparse columns (forward) and rows (backward), made by
sparse_columns and sparse_rows of ops/fused_agg.py.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from molgym_tpu_torch import cuda_build
from molgym_tpu_torch.ops import fused_agg
from molgym_tpu_torch.ops.kernel_common import (MAX_SMEM,
                                                check_cuda_operands,
                                                incoming, launch_counts,
                                                ptrs, raise_on, table_cache)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _table_blocks(table3: np.ndarray) -> fused_agg.Blocks:
    m1, m2, k = table3.shape
    return [(0, m1 * m2,
             np.ascontiguousarray(table3, np.float32).reshape(m1 * m2, k))]


def kernel_tables(table3: np.ndarray, device):
    """The table as the kernels read it, on `device`, built once: sparse
    columns with each entry's (m, n) for the forward, sparse rows for the
    backward."""
    def build():
        m2 = table3.shape[1]
        blocks = _table_blocks(table3)
        colptr, pair, coef = fused_agg.sparse_columns(blocks)
        rowptr, col, coef_t = fused_agg.sparse_rows(
            blocks, table3.shape[0] * m2)
        arrays = dict(colptr=colptr, ent_m=pair // m2, ent_n=pair % m2,
                      coef=coef, rowptr=rowptr, col=col, coef_t=coef_t)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in arrays.items()}
    return table_cache.get(('kernel', 'product'), (table3, ), device, build)


def _dense_table(table3: np.ndarray, device) -> torch.Tensor:
    """[M1*M2, K] on `device`, built once."""
    return table_cache.get(
        ('plain', 'product'), (table3, ), device,
        lambda: torch.from_numpy(_table_blocks(table3)[0][2]).to(device))


def cg_contract_ri_plain(a_r: torch.Tensor, a_i: torch.Tensor,
                         b_r: torch.Tensor, b_i: torch.Tensor,
                         table3: np.ndarray):
    """Plain PyTorch version of cg_contract_ri: the pair products in
    memory, combined before the one contraction of each part."""
    tab2 = _dense_table(table3, a_r.device)
    m1, m2 = a_r.shape[-1], b_r.shape[-1]
    u = (a_r[..., :, None] * b_r[..., None, :]
         - a_i[..., :, None] * b_i[..., None, :])
    v = (a_r[..., :, None] * b_i[..., None, :]
         + a_i[..., :, None] * b_r[..., None, :])
    out_r = u.reshape(u.shape[:-2] + (m1 * m2, )) @ tab2
    out_i = v.reshape(v.shape[:-2] + (m1 * m2, )) @ tab2
    return out_r, out_i


def cg_contract_ri_bwd_plain(a_r: torch.Tensor, a_i: torch.Tensor,
                             b_r: torch.Tensor, b_i: torch.Tensor,
                             g_r: torch.Tensor, g_i: torch.Tensor,
                             table3: np.ndarray):
    """The product's vector-Jacobian product from its formula, given the
    output gradients g_r/g_i [..., K]: (da_r, da_i [..., M1], db_r, db_i
    [..., M2]).

        dz[..., m, n] = sum_k C[m, n, k] g[..., k]
        da[..., m]    = sum_n dz[..., m, n] conj(b[..., n])
        db[..., n]    = sum_m dz[..., m, n] conj(a[..., m])
    """
    tab2 = _dense_table(table3, a_r.device)
    m1, m2 = a_r.shape[-1], b_r.shape[-1]
    dz_r = (g_r @ tab2.T).reshape(g_r.shape[:-1] + (m1, m2))
    dz_i = (g_i @ tab2.T).reshape(g_i.shape[:-1] + (m1, m2))
    br, bi = b_r[..., None, :], b_i[..., None, :]
    ar, ai = a_r[..., :, None], a_i[..., :, None]
    da_r = (dz_r * br + dz_i * bi).sum(-1)
    da_i = (dz_i * br - dz_r * bi).sum(-1)
    db_r = (dz_r * ar + dz_i * ai).sum(-2)
    db_i = (dz_i * ar - dz_r * ai).sum(-2)
    return da_r, da_i, db_r, db_i


@functools.lru_cache(maxsize=None)
def _fwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load('cg_product')
    lib.cg_product_f32.argtypes = [_P] * 10 + [_I] * 4 + [_P]
    lib.cg_product_f32.restype = _I
    lib.cg_product_smem_bytes.argtypes = [_I] * 2
    lib.cg_product_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load('cg_product_bwd')
    lib.cg_product_bwd_f32.argtypes = [_P] * 13 + [_I] * 4 + [_P]
    lib.cg_product_bwd_f32.restype = _I
    lib.cg_product_bwd_smem_bytes.argtypes = [_I] * 3
    lib.cg_product_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _shapes(name, a_r, a_i, b_r, b_i, table3):
    m1, m2 = a_r.shape[-1], b_r.shape[-1]
    if (a_i.shape != a_r.shape or b_i.shape != b_r.shape or
            a_r.shape[:-1] != b_r.shape[:-1] or
            tuple(table3.shape[:2]) != (m1, m2)):
        raise ValueError(f'{name}: inconsistent shapes a {tuple(a_r.shape)} '
                         f'/ {tuple(a_i.shape)} b {tuple(b_r.shape)} / '
                         f'{tuple(b_i.shape)} table {table3.shape}')
    return m1, m2, table3.shape[2], tuple(a_r.shape[:-1])


def _fwd_kernel(a_r, a_i, b_r, b_i, table3):
    name = 'cg_contract_ri'
    operands = (a_r, a_i, b_r, b_i)
    device = check_cuda_operands(name, operands)
    m1, m2, k, batch = _shapes(name, *operands, table3)
    lib = _fwd_lib()
    if lib.cg_product_smem_bytes(m1, m2) > MAX_SMEM:
        raise ValueError(f'{name}: M1={m1}, M2={m2} need more shared memory '
                         'than a block has')
    tabs = kernel_tables(table3, device)
    out_r = torch.empty(batch + (k, ), dtype=torch.float32, device=device)
    out_i = torch.empty_like(out_r)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.cg_product_f32(
        *ptrs(*operands, tabs['colptr'], tabs['ent_m'], tabs['ent_n'],
              tabs['coef'], out_r, out_i),
        int(np.prod(batch)), m1, m2, k, stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return out_r, out_i


def _bwd_kernel(a_r, a_i, b_r, b_i, g_r, g_i, table3):
    name = 'cg_contract_ri_bwd'
    operands = (a_r, a_i, b_r, b_i, g_r, g_i)
    device = check_cuda_operands(name, operands)
    m1, m2, k, batch = _shapes(name, *operands[:4], table3)
    if tuple(g_r.shape) != batch + (k, ) or g_i.shape != g_r.shape:
        raise ValueError(f'{name}: gradients {tuple(g_r.shape)} / '
                         f'{tuple(g_i.shape)}, expected {batch + (k, )}')
    lib = _bwd_lib()
    if lib.cg_product_bwd_smem_bytes(m1, m2, k) > MAX_SMEM:
        raise ValueError(f'{name}: M1={m1}, M2={m2}, K={k} need more shared '
                         'memory than a block has')
    tabs = kernel_tables(table3, device)
    grads = tuple(torch.empty_like(x) for x in operands[:4])
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.cg_product_bwd_f32(
        *ptrs(*operands, tabs['rowptr'], tabs['col'], tabs['coef_t'], *grads),
        int(np.prod(batch)), m1, m2, k, stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return grads


class _ContractFn(torch.autograd.Function):
    """Forward and backward kernels of the product; saves the operands."""

    @staticmethod
    def forward(ctx, a_r, a_i, b_r, b_i, table3):
        out_r, out_i = _fwd_kernel(a_r, a_i, b_r, b_i, table3)
        ctx.save_for_backward(a_r, a_i, b_r, b_i)
        ctx.table3 = table3
        ctx.out_shape = out_r.shape
        return out_r, out_i

    @staticmethod
    @once_differentiable
    def backward(ctx, g_r, g_i):
        a_r, a_i, b_r, b_i = ctx.saved_tensors
        shape = ctx.out_shape
        grads = _bwd_kernel(a_r, a_i, b_r, b_i, incoming(g_r, shape, a_r),
                            incoming(g_i, shape, a_r), ctx.table3)
        return (*grads, None)


def cg_contract_ri(a_r: torch.Tensor, a_i: torch.Tensor, b_r: torch.Tensor,
                   b_i: torch.Tensor, table3: np.ndarray):
    """Channel-wise CG product of two packed reps, complex parts separate.

    a_r/a_i  [..., tau, M1]   b_r/b_i  [..., tau, M2], the same leading
             dims and tau (broadcast a tau of 1 before the call)
    table3   [M1, M2, K] combined CG table (cg._fused_cg_table)
    returns (out_r, out_i), each [..., tau, K], K in the table's order.

    On a CUDA tensor every operand must be contiguous float32: the wrapper
    makes no copy of an operand and raises on a view that is not.
    """
    if a_r.device.type == 'cpu':
        return cg_contract_ri_plain(a_r, a_i, b_r, b_i, table3)
    return _ContractFn.apply(a_r, a_i, b_r, b_i, table3)
