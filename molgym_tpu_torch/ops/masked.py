"""Masked primitives for canvas-sized tensors (counterpart of
molgym_tpu/ops/masked.py): dense masked ops, no scatter kernels."""
from __future__ import annotations

import torch

_NEG_INF = -1e9


def to_one_hot(indices: torch.Tensor, num_classes: int,
               dtype=torch.float32) -> torch.Tensor:
    return torch.nn.functional.one_hot(indices.long(), num_classes).to(dtype)


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over entries where mask is true; exact zeros elsewhere, and
    all zeros (not NaN) for a fully masked row."""
    mask = mask.bool()
    masked_logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    z = masked_logits - masked_logits.amax(dim=-1, keepdim=True).detach()
    exp = torch.exp(z) * mask
    denom = exp.sum(dim=-1, keepdim=True)
    return exp / denom.clamp_min(1e-20)
