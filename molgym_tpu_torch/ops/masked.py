"""Masked primitives for canvas-sized tensors (counterpart of
molgym_tpu/ops/masked.py): dense masked ops, no scatter kernels. The masked
softmax lives in ops/fused_softmax.py (a kernel on the card, its plain
version on the CPU) and is re-exported here under the JAX module's name."""
from __future__ import annotations

import torch

from molgym_tpu_torch.ops.fused_softmax import masked_softmax

__all__ = ['to_one_hot', 'masked_softmax', 'masked_sum', 'masked_mean']


def to_one_hot(indices: torch.Tensor, num_classes: int,
               dtype=torch.float32) -> torch.Tensor:
    return torch.nn.functional.one_hot(indices.long(), num_classes).to(dtype)


def masked_sum(x: torch.Tensor, mask: torch.Tensor,
               axis: int = -2) -> torch.Tensor:
    """Sum feature vectors x [..., N, F] over a masked axis (mask [..., N])."""
    return (x * mask[..., None].to(x.dtype)).sum(dim=axis)


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                axis: int = -2) -> torch.Tensor:
    total = masked_sum(x, mask, axis=axis)
    count = mask.to(x.dtype).sum(dim=-1, keepdim=True)
    return total / count.clamp_min(1.0)
