"""Masked categorical distribution as plain functions (counterpart of
molgym_tpu/distributions/discrete.py). Sampling draws from an explicit
torch.Generator, or the Draws of a data-parallel rank's rows (draws.py),
the batch on axis 0 (gumbel: on `batch_dim`). `categorical_head` is one
whole head of the policy (probabilities, the chosen index, its
log-probability and the entropy) in one fused kernel on the card; the
other functions are its parts. The normal helpers serve the internal
agent's continuous heads."""
from __future__ import annotations

import math
from typing import Optional

import torch

from molgym_tpu_torch.draws import Rng, as_draws
from molgym_tpu_torch.ops.fused_softmax import (Head, categorical_entropy,
                                                categorical_log_prob,
                                                gumbel_from_uniform,
                                                gumbel_max, masked_categorical,
                                                masked_softmax)

__all__ = ['gumbel', 'masked_categorical_probs', 'categorical_sample',
           'categorical_log_prob', 'categorical_entropy', 'categorical_argmax',
           'categorical_head', 'normal_log_prob', 'normal_entropy',
           'normal_sample']


def gumbel(shape, generator: Rng, device, batch_dim: int = 0) -> torch.Tensor:
    """Standard Gumbel noise -log(-log U) from `generator`, the batch on
    `batch_dim`."""
    return gumbel_from_uniform(
        as_draws(generator).rand(shape, device=device, batch_dim=batch_dim))


def masked_categorical_probs(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Probabilities over the unmasked entries of the last axis: the masked
    softmax kernel on the card (contiguous float32 logits and a bool mask),
    its plain version on the CPU."""
    return masked_softmax(logits, mask)


def categorical_sample(generator: Rng, probs: torch.Tensor) -> torch.Tensor:
    """Gumbel-max sampling over the last axis; zero-prob entries never win."""
    return gumbel_max(probs, gumbel(probs.shape, generator, probs.device))


def categorical_argmax(probs: torch.Tensor) -> torch.Tensor:
    return torch.argmax(probs, dim=-1)


def categorical_head(logits: torch.Tensor, mask: torch.Tensor,
                     generator: Optional[Rng],
                     index: Optional[torch.Tensor] = None,
                     deterministic: bool = False) -> Head:
    """One masked categorical head: (probs, index, logp, ent) over the last
    axis, the same values as masked_categorical_probs followed by
    categorical_sample (or categorical_argmax, or the given `index`),
    categorical_log_prob and categorical_entropy. The index is `index` where
    given, else the greedy choice where `deterministic`, else a sample from
    one torch.rand draw of `generator`, the draw categorical_sample makes."""
    if index is not None:
        return masked_categorical(logits, mask, index=index)
    if deterministic:
        return masked_categorical(logits, mask, greedy=True)
    u = as_draws(generator).rand(logits.shape, device=logits.device)
    return masked_categorical(logits, mask, u=u)


def normal_log_prob(x: torch.Tensor, mean: torch.Tensor,
                    std: torch.Tensor) -> torch.Tensor:
    var = std * std
    return -0.5 * (torch.square(x - mean) / var + torch.log(2.0 * math.pi * var))


def normal_entropy(std: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.log(2.0 * math.pi * math.e * std * std)


def normal_sample(generator: Rng, mean: torch.Tensor,
                  std: torch.Tensor) -> torch.Tensor:
    """mean + std * one torch.randn draw of `generator`, of mean's shape."""
    return mean + std * as_draws(generator).randn(
        mean.shape, device=mean.device, dtype=mean.dtype)
