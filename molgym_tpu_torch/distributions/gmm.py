"""1-D Gaussian mixture, the covariant agent's distance head (counterpart of
molgym_tpu/distributions/gmm.py)."""
from __future__ import annotations

import math

import torch

from molgym_tpu_torch.distributions.discrete import gumbel
from molgym_tpu_torch.draws import Rng, as_draws


def gmm_log_prob(log_weights: torch.Tensor, means: torch.Tensor,
                 stds: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """log_weights/means: [..., K]; stds: [K] or [..., K]; x: [...]."""
    log_w = torch.log_softmax(log_weights, dim=-1)
    var = stds * stds
    comp = -0.5 * (torch.square(x[..., None] - means) / var +
                   torch.log(2.0 * math.pi * var))
    return torch.logsumexp(log_w + comp, dim=-1)


def gmm_sample(generator: Rng, log_weights: torch.Tensor,
               means: torch.Tensor, stds: torch.Tensor,
               batch_dim: int = 0) -> torch.Tensor:
    """One sample per row; the batch on `batch_dim` of log_weights."""
    comp = torch.argmax(
        log_weights + gumbel(log_weights.shape, generator, log_weights.device,
                             batch_dim),
        dim=-1)
    mean = torch.gather(means, -1, comp[..., None])[..., 0]
    std = torch.gather(stds.expand_as(means), -1, comp[..., None])[..., 0]
    noise = as_draws(generator).randn(mean.shape, device=mean.device,
                                      batch_dim=batch_dim)
    return mean + std * noise


def gmm_argmax(generator: Rng, log_weights: torch.Tensor,
               means: torch.Tensor, stds: torch.Tensor,
               count: int = 128) -> torch.Tensor:
    """Sample-based mode estimate: the best of `count` samples (drawn
    [count, B, ...]: the batch on axis 1)."""
    shape = (count, ) + tuple(means.shape)
    samples = gmm_sample(generator, log_weights.expand(shape),
                         means.expand(shape), stds.expand(shape),
                         batch_dim=1)  # [count, ...]
    logp = gmm_log_prob(log_weights, means, stds, samples)
    best = torch.argmax(logp, dim=0)
    return torch.gather(samples, 0, best[None])[0]
