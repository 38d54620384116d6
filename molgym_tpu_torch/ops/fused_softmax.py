"""The masked row softmax of the focus and element heads and its backward
(counterpart of molgym_tpu/ops/pallas_softmax.py):

    probs = softmax over the entries where mask is true; exact zeros
            elsewhere, and all zeros (not NaN) for a fully masked row.

`masked_softmax` dispatches on the device of its tensors: on the CPU it
calls the plain PyTorch version `masked_softmax_plain`, which autograd
differentiates; on a CUDA tensor it runs a `torch.autograd.Function` whose
forward and backward launch the two kernels of csrc/masked_softmax.cu, or
raises. `masked_softmax_bwd_plain` computes the same vector-Jacobian product
from its formula.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from molgym_tpu_torch import cuda_build
from molgym_tpu_torch.ops.kernel_common import (check_cuda_operands, incoming,
                                                launch_counts, ptrs, raise_on)

_NEG_INF = -1e9
_P = ctypes.c_void_p
_I = ctypes.c_int


def masked_softmax_plain(logits: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of masked_softmax. The row maximum carries no
    gradient."""
    mask = mask.bool()
    masked_logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    z = masked_logits - masked_logits.amax(dim=-1, keepdim=True).detach()
    exp = torch.exp(z) * mask
    denom = exp.sum(dim=-1, keepdim=True)
    return exp / denom.clamp_min(1e-20)


def masked_softmax_bwd_plain(probs: torch.Tensor,
                             grad: torch.Tensor) -> torch.Tensor:
    """The softmax's vector-Jacobian product from its output `probs` and the
    output gradient: dlogits = p (g - sum_n g p), zero where masked."""
    return probs * (grad - (grad * probs).sum(dim=-1, keepdim=True))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load('masked_softmax')
    lib.masked_softmax_f32.argtypes = [_P] * 3 + [_I] * 2 + [_P]
    lib.masked_softmax_f32.restype = _I
    lib.masked_softmax_bwd_f32.argtypes = [_P] * 3 + [_I] * 2 + [_P]
    lib.masked_softmax_bwd_f32.restype = _I
    return lib


def _rows(x: torch.Tensor):
    n = x.shape[-1]
    return x.numel() // max(n, 1), n


def _fwd_kernel(logits, mask):
    name = 'masked_softmax'
    device = check_cuda_operands(name, (logits, ))
    check_cuda_operands(name, (mask, ), dtypes=(torch.bool, torch.uint8))
    if mask.shape != logits.shape or mask.device != device:
        raise ValueError(f'{name}: logits {tuple(logits.shape)} on {device}, '
                         f'mask {tuple(mask.shape)} on {mask.device}')
    rows, n = _rows(logits)
    out = torch.empty_like(logits)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib().masked_softmax_f32(*ptrs(logits, mask, out), rows, n, stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return out


def _bwd_kernel(probs, grad):
    name = 'masked_softmax_bwd'
    device = check_cuda_operands(name, (probs, grad))
    if grad.shape != probs.shape:
        raise ValueError(f'{name}: gradient {tuple(grad.shape)}, expected '
                         f'{tuple(probs.shape)}')
    rows, n = _rows(probs)
    dlogits = torch.empty_like(probs)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib().masked_softmax_bwd_f32(*ptrs(probs, grad, dlogits), rows, n,
                                        stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return dlogits


class _SoftmaxFn(torch.autograd.Function):
    """Forward and backward kernels of the masked softmax; saves the
    output, which is all the backward needs."""

    @staticmethod
    def forward(ctx, logits, mask):
        probs = _fwd_kernel(logits, mask)
        ctx.save_for_backward(probs)
        return probs

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (probs, ) = ctx.saved_tensors
        return _bwd_kernel(probs, incoming(grad, probs.shape, probs)), None


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis where mask is true.

    logits [..., N] float32; mask [..., N], true (non-zero) = kept
    returns probs [..., N]: exact zeros where masked, a row of zeros where
    every entry is masked.

    On a CUDA tensor the kernel takes contiguous float32 logits and a
    contiguous mask of one byte an entry (torch.bool or torch.uint8) of the
    same shape: the wrapper makes no copy and raises on anything else. Any
    N and any number of rows.
    """
    if logits.device.type == 'cpu':
        return masked_softmax_plain(logits, mask)
    return _SoftmaxFn.apply(logits, mask)
