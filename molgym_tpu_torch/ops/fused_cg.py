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
packed warp by warp (`product_tables`), and the forward cuts its work by a
plan chosen here from the shapes alone (`product_fwd_plan`), so that the CPU
tests can walk the same loops.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from molgym_tpu_torch import cuda_build
from molgym_tpu_torch.ops import fused_agg
from molgym_tpu_torch.ops.fused_agg import WARP, _align16
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


def product_tables(table3: np.ndarray) -> dict:
    """The product's kernel tables (csrc/cg_product.cu,
    csrc/cg_product_bwd.cu) as numpy arrays.

    Forward: the columns in output order packed warp by warp
    (`fused_agg.warp_padded`), each entry an 8-byte (m << 16 | n,
    coefficient bits) word (`fwd_ptr`, `fwd_ent`); lane l of group g holds
    column 32 g + l, so a warp's stores are coalesced. Backward: the live
    pairs (those with entries) sorted by length and packed the same way,
    each entry
    (k, coefficient bits) (`bwd_ptr`, `bwd_ent`), the steps of each lane
    ordered against bank conflicts on g (`fused_agg.spread_steps`); dz of
    a live pair lies at its lane slot, and slot 32 G past the last group
    holds zeros. `lines` holds two step-major tables, each padded to a
    multiple of 4 words for 16-byte copies: [a_steps, M1] lists for each m
    the live pairs (m, n) by n as (dz slot << 16 | n), then [b_steps, M2]
    for each n the live pairs (m, n) by m as (dz slot << 16 | m); a line
    shorter than its table is padded with the slot of zeros."""
    m1, m2, k = table3.shape
    if max(m1, m2) >= 1 << 16:
        raise ValueError(f'product_tables: M1={m1}, M2={m2} do not fit '
                         'the packed entries')
    blocks = _table_blocks(table3)
    colptr, pair, coef = fused_agg.sparse_columns(blocks)
    fwd_ptr, _cols, fwd_ent = fused_agg.warp_padded(colptr, pair, coef)
    fwd_ent[:, 0] = fwd_ent[:, 0] // m2 << 16 | fwd_ent[:, 0] % m2
    rowptr, col, coef_t = fused_agg.sparse_rows(blocks, m1 * m2)
    counts = np.diff(rowptr)
    live = np.flatnonzero(counts)
    bwd_ptr, line_of, bwd_ent = fused_agg.warp_padded(
        np.concatenate([[0], np.cumsum(counts[live])]), col, coef_t,
        by_length=True)
    # g loads are 16 bytes a lane at tiles of 2 and 4 rows: a quarter warp a
    # phase, the slot of k on bank group k or 3 k mod 8, which spread alike
    bwd_ent = fused_agg.spread_steps(bwd_ptr, line_of, counts[live], bwd_ent,
                                     np.arange(k) % 8, 8)
    zero_slot = len(line_of)
    dz_slot = np.full(m1 * m2, zero_slot, np.int64)
    on = line_of >= 0
    dz_slot[live[line_of[on]]] = np.flatnonzero(on)
    is_live = (counts > 0).reshape(m1, m2)
    slots = dz_slot.reshape(m1, m2)

    def step_major(per_line):
        n_steps = max(max(len(x) for x in per_line), 1)
        lines = np.full((n_steps, len(per_line)), zero_slot << 16, np.int64)
        for t, x in enumerate(per_line):
            lines[:len(x), t] = x
        words = np.full(-(-lines.size // 4) * 4, zero_slot << 16, np.int64)
        words[:lines.size] = lines.ravel()
        return n_steps, words
    a_steps, a_words = step_major(
        [slots[m, is_live[m]] << 16 | np.flatnonzero(is_live[m])
         for m in range(m1)])
    b_steps, b_words = step_major(
        [slots[is_live[:, n], n] << 16 | np.flatnonzero(is_live[:, n])
         for n in range(m2)])
    return dict(k=int(k), nnz=int(coef.shape[0]), n_live=len(live),
                a_steps=a_steps, b_steps=b_steps, fwd_ptr=fwd_ptr,
                fwd_ent=fwd_ent, bwd_ptr=bwd_ptr,
                bwd_ent=bwd_ent,
                lines=np.concatenate([a_words, b_words]).astype(np.int32))


def kernel_tables(table3: np.ndarray, device):
    """`product_tables` on `device`, built once, with the forward's group
    offsets also in host memory: as a tuple for the plan (`fwd_groups`) and
    as a C array for the launch (`fwd_groups_c`), which passes them to the
    kernel by value."""
    def build():
        tabs = product_tables(table3)
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               if isinstance(v, np.ndarray) else v for k, v in tabs.items()}
        groups = tuple(int(x) for x in tabs['fwd_ptr'])
        out['fwd_groups'] = groups
        out['fwd_groups_c'] = (ctypes.c_int * len(groups))(*groups)
        return out
    return table_cache.get(('kernel', 'product'), (table3, ), device, build)


# How the kernels cut their work. The forward is compiled for tiles of 4
# and 1 rows and takes a tile with a chunk of the column groups a block; the
# backward is compiled for tiles of 4, 2 and 1 rows and takes a tile with
# all of the table, giving each line of da and db a power of two of lanes.

PRODUCT_FWD_ROWS = (4, 1)
PRODUCT_BWD_ROWS = (4, 2, 1)
# column groups a forward block takes: of 1 to 12, 3 read fastest or within
# noise of it at both configurations' tables and 560, 40 and 4 rows
PRODUCT_FWD_GROUPS = 3
PRODUCT_FWD_MAX_WARPS = 16
PRODUCT_FWD_MAX_GROUPS = 64        # K <= 2,048
PRODUCT_BWD_MAX_WARPS = 8
# what a backward block may take before its tile is cut: the default limit
# of shared memory, so the host never raises it on the path
PRODUCT_BWD_SMEM_TARGET = 48 * 1024


def slot_stride(rows: int) -> int:
    """float2 per slot of a, b (and of the backward's g and dz) for a tile of
    `rows` rows: 16-byte multiples (8 bytes for one row), padded by two at
    4 rows so that slot s starts on bank group 3 s mod 8. The kernels lay
    out their shared memory by the same rule (`slot_stride` in
    csrc/cg_product_common.cuh), and the plans size it by this one."""
    return rows + 2 if rows >= 4 else rows


@functools.lru_cache(maxsize=None)
def product_fwd_plan(n_rows, m1, m2, fwd_groups, num_sms) -> dict:
    """How the forward cuts `n_rows` rows (computed once per set of
    arguments; the caller gets the same dict). `rows` per tile, 4 where
    that still gives every SM a tile (the update's batch), else 1 (the
    rollout's and an evaluation's); the column groups (`fwd_groups`: their
    entry offsets) are cut into chunks of `per_block` =
    PRODUCT_FWD_GROUPS groups, a block per (tile, chunk), so that at the
    update's batch the SMs share 560 blocks at SF6 instead of 140 (where
    8 SMs took two heavy blocks each); a warp per group of the chunk, and
    at least enough that a thread copies one value of a and of b (at most
    PRODUCT_FWD_MAX_WARPS); the block's shared bytes: the chunk's entries
    (at most `ent_cap`), a and b of the tile."""
    n_groups = len(fwd_groups) - 1
    rows = next(r for r in PRODUCT_FWD_ROWS
                if r == 1 or -(-n_rows // r) >= num_sms)
    per_block = min(n_groups, PRODUCT_FWD_GROUPS)
    chunks = -(-n_groups // per_block)
    ent_cap = max(fwd_groups[min(n_groups, (c + 1) * per_block)] -
                  fwd_groups[c * per_block] for c in range(chunks))
    warps = max(per_block, -(-rows * max(m1, m2) // WARP))
    zs = slot_stride(rows)
    return dict(rows=rows, chunks=chunks, per_block=per_block,
                threads=WARP * min(warps, PRODUCT_FWD_MAX_WARPS),
                ent_cap=ent_cap,
                smem=(_align16(8 * ent_cap) + _align16(8 * m1 * zs) +
                      _align16(8 * m2 * zs)))


def product_bwd_smem(rows, m1, m2, k, n_groups, n_ent, n_line_words) -> int:
    """Shared bytes of one backward block for tiles of `rows` rows, the sum
    of what the kernel lays out: the packed table, dz of the tile (32 slots
    a group and the slot of zeros), g, a and b of the tile, the lines, the
    group offsets."""
    zs = slot_stride(rows)
    return (_align16(8 * n_ent) + _align16(8 * (WARP * n_groups + 1) * zs) +
            _align16(8 * k * zs) + _align16(8 * m1 * zs) +
            _align16(8 * m2 * zs) + _align16(4 * n_line_words) +
            _align16(4 * (n_groups + 1)))


@functools.lru_cache(maxsize=None)
def product_bwd_plan(n_rows, m1, m2, k, n_groups, n_ent, n_line_words,
                     num_sms) -> dict:
    """How the backward cuts `n_rows` rows (computed once per set of
    arguments; the caller gets the same dict). A block copies the whole
    table (entries and lines) for its tile, so `rows` per tile is the
    fewest whose own g, a and b bring at least half the table's bytes,
    among the tiles that give every SM a tile and keep a block under
    PRODUCT_BWD_SMEM_TARGET (the widest of those if none does): 1 row for
    the mixer's first product, 2 for SF6's second (4 would not fit), 4 for
    the stochastic configuration's second. A warp per group of live pairs,
    4 to 8 warps; `lanes` for each line of da and db, the largest
    power of two (at most a warp) that gives the M1 + M2 lines no more
    lanes than the block has; the block's shared bytes."""
    def smem_of(rows):
        return product_bwd_smem(rows, m1, m2, k, n_groups, n_ent,
                                n_line_words)
    fits = [r for r in PRODUCT_BWD_ROWS
            if r == 1 or (-(-n_rows // r) >= num_sms
                          and smem_of(r) <= PRODUCT_BWD_SMEM_TARGET)]
    table_bytes = 8 * n_ent + 4 * n_line_words
    rows = min((r for r in fits if 2 * r * 8 * (k + m1 + m2) >= table_bytes),
               default=max(fits))
    threads = WARP * min(PRODUCT_BWD_MAX_WARPS, max(4, n_groups))
    lanes = min(WARP, fused_agg._pow2_floor(threads // (m1 + m2)))
    return dict(rows=rows, threads=threads, lanes=lanes, smem=smem_of(rows))


def _bwd_plan(n_rows, m1, m2, tabs, device):
    return product_bwd_plan(n_rows, m1, m2, tabs['k'],
                            tabs['bwd_ptr'].shape[0] - 1,
                            tabs['bwd_ent'].shape[0], tabs['lines'].shape[0],
                            fused_agg._num_sms(device))


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
    lib.cg_product_f32.argtypes = [_P] * 8 + [_I] * 10 + [_P]
    lib.cg_product_f32.restype = _I
    lib.cg_product_blocks_per_sm.argtypes = [_I] * 3
    lib.cg_product_blocks_per_sm.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = cuda_build.load('cg_product_bwd')
    lib.cg_product_bwd_f32.argtypes = [_P] * 13 + [_I] * 12 + [_P]
    lib.cg_product_bwd_f32.restype = _I
    lib.cg_product_bwd_blocks_per_sm.argtypes = [_I] * 3
    lib.cg_product_bwd_blocks_per_sm.restype = _I
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


def _fwd_plan(n_rows, m1, m2, tabs, device):
    return product_fwd_plan(n_rows, m1, m2, tabs['fwd_groups'],
                            fused_agg._num_sms(device))


def _fwd_kernel(a_r, a_i, b_r, b_i, table3):
    name = 'cg_contract_ri'
    operands = (a_r, a_i, b_r, b_i)
    device = check_cuda_operands(name, operands)
    m1, m2, k, batch = _shapes(name, *operands, table3)
    tabs = kernel_tables(table3, device)
    n_rows = math.prod(batch)
    n_groups = len(tabs['fwd_groups']) - 1
    plan = _fwd_plan(n_rows, m1, m2, tabs, device)
    if plan['smem'] > MAX_SMEM or n_groups > PRODUCT_FWD_MAX_GROUPS:
        raise ValueError(f'{name}: M1={m1}, M2={m2}, K={k} need '
                         f'{plan["smem"]} bytes of shared memory or '
                         f'{n_groups} groups of columns, more than a block '
                         'has or the kernel takes')
    out_r = torch.empty(batch + (k, ), dtype=torch.float32, device=device)
    out_i = torch.empty_like(out_r)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _fwd_lib().cg_product_f32(
        *ptrs(*operands), ctypes.addressof(tabs['fwd_groups_c']),
        *ptrs(tabs['fwd_ent'], out_r, out_i),
        n_rows, m1, m2, k, n_groups, plan['rows'], plan['per_block'],
        plan['threads'], plan['ent_cap'], plan['smem'], stream)
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
    tabs = kernel_tables(table3, device)
    n_rows = math.prod(batch)
    plan = _bwd_plan(n_rows, m1, m2, tabs, device)
    if plan['smem'] > MAX_SMEM:
        raise ValueError(f'{name}: M1={m1}, M2={m2}, K={k} need '
                         f'{plan["smem"]} bytes of shared memory, more than '
                         'a block has')
    grads = tuple(torch.empty_like(x) for x in operands[:4])
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _bwd_lib().cg_product_bwd_f32(
        *ptrs(*operands, tabs['bwd_ptr'], tabs['bwd_ent'], tabs['lines'],
              *grads),
        n_rows, m1, m2, k, tabs['bwd_ptr'].shape[0] - 1,
        tabs['bwd_ent'].shape[0], tabs['a_steps'], tabs['b_steps'],
        plan['lanes'].bit_length() - 1, plan['rows'], plan['threads'],
        plan['smem'], stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return grads


def product_kernel_resources(n_rows, table3, device):
    """What the two kernels take for `n_rows` rows: the plans, the blocks
    of each launch, and the resident blocks per SM of each (asked of the
    built libraries), for a log line."""
    m1, m2, _k = table3.shape
    tabs = kernel_tables(table3, device)
    fwd = _fwd_plan(n_rows, m1, m2, tabs, device)
    bwd = _bwd_plan(n_rows, m1, m2, tabs, device)
    return dict(
        fwd=dict(fwd, blocks=-(-n_rows // fwd['rows']) * fwd['chunks'],
                 blocks_per_sm=_fwd_lib().cg_product_blocks_per_sm(
                     fwd['rows'], fwd['threads'], fwd['smem'])),
        bwd=dict(bwd, blocks=-(-n_rows // bwd['rows']),
                 blocks_per_sm=_bwd_lib().cg_product_bwd_blocks_per_sm(
                     bwd['rows'], bwd['threads'], bwd['smem'])))


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
