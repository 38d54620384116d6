"""Masked categorical distribution as plain functions (counterpart of
molgym_tpu/distributions/discrete.py). Sampling draws from an explicit
torch.Generator."""
from __future__ import annotations

import torch

from molgym_tpu_torch.ops.fused_softmax import masked_softmax

_EPS = 1e-10


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log U) from `generator`."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 1e-7)))


def masked_categorical_probs(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Probabilities over the unmasked entries of the last axis: the masked
    softmax kernel on the card (contiguous float32 logits and a bool mask),
    its plain version on the CPU."""
    return masked_softmax(logits, mask)


def categorical_sample(generator: torch.Generator, probs: torch.Tensor) -> torch.Tensor:
    """Gumbel-max sampling over the last axis; zero-prob entries never win."""
    logits = (torch.log(probs.clamp(min=_EPS)) +
              torch.where(probs > 0, 0.0, -1e9))
    g = gumbel(probs.shape, generator, probs.device)
    return torch.argmax(logits + g, dim=-1)


def categorical_log_prob(probs: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    p = torch.gather(probs, -1, index[..., None].long())[..., 0]
    return torch.log(p.clamp(min=_EPS))


def categorical_entropy(probs: torch.Tensor) -> torch.Tensor:
    plogp = torch.where(probs > 0, probs * torch.log(probs.clamp(min=_EPS)),
                        torch.zeros_like(probs))
    return -plogp.sum(dim=-1)


def categorical_argmax(probs: torch.Tensor) -> torch.Tensor:
    return torch.argmax(probs, dim=-1)
