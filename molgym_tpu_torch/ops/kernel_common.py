"""What every kernel wrapper of the port shares: the one registry of launch
counts, the cache of device-side tables, the operand checks, and the small
helpers around a ctypes launch.

`launch_counts` has one entry per kernel, and a wrapper adds one to its
entry where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels; `reset_launch_counts` zeroes them
all. The encoder's four kernels have a bf16 version each (operands and
outputs bf16, f32 arithmetic), counted under the f32 name + `_bf16`.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

BF16_KERNELS = ('cg_aggregate_edge_fused_ri', 'cg_aggregate_edge_fused_ri_bwd',
                'cg_square_fused_ri', 'cg_square_fused_ri_bwd')
launch_counts: Dict[str, int] = {
    name: 0 for name in BF16_KERNELS + tuple(n + '_bf16' for n in BF16_KERNELS)
    + ('cg_contract_ri', 'cg_contract_ri_bwd', 'masked_softmax',
       'masked_softmax_bwd')}

# what one thread block may hold (H100: 227 KB of the SM's shared memory)
MAX_SMEM = 232448


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


class TableCache:
    """Device tensors derived from host tables, built once per (tables,
    device). Keyed by the ids of the host arrays, which the entry keeps
    alive so that no other array can take their ids while it exists; the
    functions that make the tables are lru-cached, so callers pass the same
    arrays each call."""

    def __init__(self):
        self._entries = {}

    def get(self, tag, arrays, device, build):
        key = (tag, tuple(id(a) for a in arrays), str(device))
        entry = self._entries.get(key)
        if entry is None:
            entry = (arrays, build())
            self._entries[key] = entry
        return entry[1]


table_cache = TableCache()


def operand_dtype(name, tensors, dtypes=(torch.float32, )):
    """The one dtype of `tensors`, after checking that it is one of
    `dtypes`; raises on another or on a mix (nothing is cast quietly)."""
    dtype = tensors[0].dtype
    if dtype not in dtypes:
        raise TypeError(f'{name}: the kernel takes '
                        f'{" or ".join(str(d) for d in dtypes)}, got {dtype}')
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f'{name}: operands of {dtype} and {t.dtype}; '
                            'the kernel takes one dtype')
    return dtype


def check_cuda_operands(name, tensors, dtypes=(torch.float32, )):
    """The device of `tensors`, after checking that all lie on one CUDA
    device, are contiguous and share one of `dtypes`; raises otherwise."""
    device = tensors[0].device
    operand_dtype(name, tensors, dtypes)
    for t in tensors:
        if t.device != device:
            raise ValueError(f'{name}: operands on {t.device} and {device}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: the kernel takes contiguous tensors')
    if device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {device}')
    return device


def raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{err}')


def incoming(grad: Optional[torch.Tensor], shape,
             like: torch.Tensor) -> torch.Tensor:
    """An output's gradient as the backward kernels take it: zeros of
    `shape` where autograd passes None, contiguous otherwise."""
    if grad is None:
        return like.new_zeros(shape)
    return grad.contiguous()


def ptrs(*tensors):
    return [t.data_ptr() for t in tensors]
