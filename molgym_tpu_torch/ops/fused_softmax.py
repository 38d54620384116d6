"""The masked categorical head of the focus and element heads: the masked
row softmax (counterpart of molgym_tpu/ops/pallas_softmax.py) fused with the
head's sampling, log-probability and entropy (the functions of
molgym_tpu/distributions/discrete.py), and its backward:

    probs = softmax over the entries where mask is true; exact zeros
            elsewhere, and all zeros (not NaN) for a fully masked row;
    index = given, the greedy argmax, or a Gumbel-max sample over uniforms u;
    logp  = log(max(probs[index], 1e-10));
    ent   = -sum over probs > 0 of probs log(max(probs, 1e-10)).

`masked_categorical` and `masked_softmax` (the softmax alone) dispatch on
the device of their tensors: on the CPU they call the plain PyTorch versions
`masked_categorical_plain` and `masked_softmax_plain`, which autograd
differentiates; on a CUDA tensor they run a `torch.autograd.Function` whose
forward and backward launch the two kernels of csrc/masked_softmax.cu, or
raise. `masked_categorical_bwd_plain` and `masked_softmax_bwd_plain` compute
the same vector-Jacobian products from their formulas.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from molgym_tpu_torch import cuda_build
from molgym_tpu_torch.ops.kernel_common import (check_cuda_operands,
                                                launch_counts, operand_dtype,
                                                raise_on)

_NEG_INF = -1e9
_EPS = 1e-10
_P = ctypes.c_void_p
_I = ctypes.c_int
# the forward kernel's modes (csrc/masked_softmax.cu)
PROBS, GIVEN, GREEDY, SAMPLE = range(4)

Head = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor],
             Optional[torch.Tensor]]


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


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise -log(-log u) from uniforms in [0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 1e-7)))


def gumbel_max(probs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The Gumbel-max choice over the last axis for the Gumbel `noise`;
    zero-prob entries never win."""
    logits = (torch.log(probs.clamp(min=_EPS)) +
              torch.where(probs > 0, 0.0, _NEG_INF))
    return torch.argmax(logits + noise, dim=-1)


def categorical_log_prob(probs: torch.Tensor,
                         index: torch.Tensor) -> torch.Tensor:
    p = torch.gather(probs, -1, index[..., None].long())[..., 0]
    return torch.log(p.clamp(min=_EPS))


def categorical_entropy(probs: torch.Tensor) -> torch.Tensor:
    plogp = torch.where(probs > 0, probs * torch.log(probs.clamp(min=_EPS)),
                        torch.zeros_like(probs))
    return -plogp.sum(dim=-1)


def _mode(u, index, greedy) -> int:
    chosen = [m for m, on in ((SAMPLE, u is not None),
                              (GIVEN, index is not None), (GREEDY, greedy))
              if on]
    if len(chosen) > 1:
        raise ValueError('masked_categorical: pass one of u, index and '
                         'greedy')
    return chosen[0] if chosen else PROBS


def masked_categorical_plain(logits: torch.Tensor, mask: torch.Tensor, *,
                             u: Optional[torch.Tensor] = None,
                             index: Optional[torch.Tensor] = None,
                             greedy: bool = False) -> Head:
    """Plain PyTorch version of masked_categorical: the masked softmax, the
    Gumbel-max choice on `u` (or the given or greedy index), the
    log-probability and the entropy, each by the function above."""
    mode = _mode(u, index, greedy)
    probs = masked_softmax_plain(logits, mask)
    if mode == PROBS:
        return probs, None, None, None
    if mode == SAMPLE:
        index = gumbel_max(probs, gumbel_from_uniform(u))
    elif mode == GREEDY:
        index = torch.argmax(probs, dim=-1)
    return (probs, index, categorical_log_prob(probs, index),
            categorical_entropy(probs))


def masked_categorical_bwd_plain(probs: torch.Tensor,
                                 index: Optional[torch.Tensor],
                                 g_probs: Optional[torch.Tensor],
                                 g_logp: Optional[torch.Tensor],
                                 g_ent: Optional[torch.Tensor]
                                 ) -> torch.Tensor:
    """The head's vector-Jacobian product from its saved `probs` and `index`
    and the gradients of probs, logp and ent (None where absent), as
    autograd takes it through masked_categorical_plain: clamp(min=eps)
    passes where p >= eps, the entropy's where(p > 0) nothing where p = 0."""
    g = torch.zeros_like(probs) if g_probs is None else g_probs
    if g_logp is not None:
        at = index[..., None].long()
        p = torch.gather(probs, -1, at)
        d = torch.where(p >= _EPS, g_logp[..., None] / p.clamp(min=_EPS), 0.0)
        g = g.scatter_add(-1, at, d)
    if g_ent is not None:
        clamped = probs.clamp(min=_EPS)
        ge = torch.where(probs > 0, -g_ent[..., None], 0.0)
        g = g + ge * torch.log(clamped) + torch.where(
            probs >= _EPS, ge * probs / clamped, 0.0)
    return masked_softmax_bwd_plain(probs, g)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load('masked_softmax')
    lib.masked_categorical_f32.argtypes = [_P] * 8 + [_I] * 3 + [_P]
    lib.masked_categorical_f32.restype = _I
    lib.masked_categorical_bwd_f32.argtypes = [_P] * 4 + [_I, _P, _I, _P] + [
        _I] * 2 + [_P]
    lib.masked_categorical_bwd_f32.restype = _I
    return lib


def _rows(x: torch.Tensor):
    n = x.shape[-1]
    return x.numel() // max(n, 1), n


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd_kernel(logits, mask, u=None, index=None, mode=PROBS):
    """One launch of the forward kernel: (probs, index, logp, ent), the last
    three None in PROBS mode."""
    name = 'masked_softmax'
    device = check_cuda_operands(name, (logits, ))
    check_cuda_operands(name, (mask, ), dtypes=(torch.bool, torch.uint8))
    if mask.shape != logits.shape or mask.device != device:
        raise ValueError(f'{name}: logits {tuple(logits.shape)} on {device}, '
                         f'mask {tuple(mask.shape)} on {mask.device}')
    lead = logits.shape[:-1]
    if mode == SAMPLE:
        check_cuda_operands(name, (u, ))
        if u.shape != logits.shape or u.device != device:
            raise ValueError(f'{name}: uniforms {tuple(u.shape)} on '
                             f'{u.device}, logits {tuple(logits.shape)}')
    if mode == GIVEN:
        check_cuda_operands(name, (index, ), dtypes=(torch.int64, ))
        if index.shape != lead or index.device != device:
            raise ValueError(f'{name}: index {tuple(index.shape)} on '
                             f'{index.device}, logits {tuple(logits.shape)}')
    rows, n = _rows(logits)
    probs = torch.empty_like(logits)
    out = (None, None, None)
    if mode != PROBS:
        out = (torch.empty(lead, dtype=torch.int64, device=device),
               logits.new_empty(lead), logits.new_empty(lead))
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib().masked_categorical_f32(
        logits.data_ptr(), mask.data_ptr(), _ptr(u), _ptr(index),
        probs.data_ptr(), *map(_ptr, out), mode, rows, n, stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return (probs, ) + out


def _per_row(name, g, lead):
    """A per-row gradient as the backward kernel reads it, with its row
    stride: 1 if contiguous, 0 if one value broadcast over the rows (as a
    mean's gradient comes), else a contiguous copy."""
    if g is None:
        return None, 0
    if g.shape != lead:
        raise ValueError(f'{name}: gradient {tuple(g.shape)}, expected '
                         f'{tuple(lead)}')
    if g.is_contiguous():
        return g, 1
    if all(s == 0 for s in g.stride()):
        return g, 0
    return g.contiguous(), 1


def _bwd_kernel(probs, index, g_probs, g_logp, g_ent):
    """One launch of the backward kernel: dlogits from the saved probs and
    index and the incoming gradients (None where absent)."""
    name = 'masked_softmax_bwd'
    lead = probs.shape[:-1]
    if g_probs is not None:
        if g_probs.shape != probs.shape:
            raise ValueError(f'{name}: gradient {tuple(g_probs.shape)}, '
                             f'expected {tuple(probs.shape)}')
        g_probs = g_probs.contiguous()
    device = check_cuda_operands(
        name, [t for t in (probs, g_probs) if t is not None])
    g_logp, s_logp = _per_row(name, g_logp, lead)
    g_ent, s_ent = _per_row(name, g_ent, lead)
    for g in (g_logp, g_ent):
        if g is not None:
            operand_dtype(name, (probs, g))
            if g.device != device:
                raise ValueError(f'{name}: operands on {g.device} and '
                                 f'{device}')
    if g_logp is not None:
        check_cuda_operands(name, (index, ), dtypes=(torch.int64, ))
        if index.shape != lead or index.device != device:
            raise ValueError(f'{name}: index {tuple(index.shape)} on '
                             f'{index.device}, probs {tuple(probs.shape)}')
    rows, n = _rows(probs)
    dlogits = torch.empty_like(probs)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib().masked_categorical_bwd_f32(
        probs.data_ptr(), _ptr(index), _ptr(g_probs), _ptr(g_logp), s_logp,
        _ptr(g_ent), s_ent, dlogits.data_ptr(), rows, n, stream)
    raise_on(err, name)
    launch_counts[name] += 1
    return dlogits


class _HeadFn(torch.autograd.Function):
    """The forward and backward kernels of the head. Returns probs alone in
    PROBS mode, else (probs, index, logp, ent); saves probs and the index,
    which is all the backward needs. Gradients autograd does not pass stay
    None (the kernel reads nothing for them, and gives zeros if it is
    passed none)."""

    @staticmethod
    def forward(ctx, logits, mask, u, index, mode):
        probs, index, logp, ent = _fwd_kernel(logits, mask, u, index, mode)
        ctx.set_materialize_grads(False)
        if mode == PROBS:
            ctx.save_for_backward(probs, None)
            return probs
        ctx.mark_non_differentiable(index)
        ctx.save_for_backward(probs, index)
        return probs, index, logp, ent

    @staticmethod
    @once_differentiable
    def backward(ctx, g_probs, *rest):
        probs, index = ctx.saved_tensors
        g_logp, g_ent = rest[1:] if rest else (None, None)
        return (_bwd_kernel(probs, index, g_probs, g_logp, g_ent), None, None,
                None, None)


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
    return _HeadFn.apply(logits, mask, None, None, PROBS)


def masked_categorical(logits: torch.Tensor, mask: torch.Tensor, *,
                       u: Optional[torch.Tensor] = None,
                       index: Optional[torch.Tensor] = None,
                       greedy: bool = False) -> Head:
    """A masked categorical head over the last axis:
    (probs, index, logp, ent).

    logits [..., N] float32; mask [..., N], true (non-zero) = kept; at most
    one of: u [..., N] uniforms in [0, 1) (index = the Gumbel-max sample),
    index [...] (given, e.g. the actions being evaluated), greedy (index =
    the first largest probability). With none, index, logp and ent are None
    and probs is masked_softmax's. probs [..., N]; index [...] int64; logp
    and ent [...]. Autograd reaches the logits through probs, logp and ent.

    On a CUDA tensor one kernel computes all four and one kernel their
    backward; it takes contiguous operands (float32 logits and u, a mask of
    torch.bool or torch.uint8, an int64 index) and raises on anything else.
    """
    mode = _mode(u, index, greedy)
    if logits.device.type == 'cpu':
        return masked_categorical_plain(logits, mask, u=u, index=index,
                                        greedy=greedy)
    if mode == PROBS:
        return masked_softmax(logits, mask), None, None, None
    return _HeadFn.apply(logits, mask, u, index, mode)
