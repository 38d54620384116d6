"""The covariant agent's greedy distance from a fixed set of candidates, so
that a greedy evaluation is a deterministic function of the weights.

The agent's greedy act takes its distance as the best of 128 draws from the
GMM head (distributions/gmm.py::gmm_argmax, as the reference does), so two
evaluations of the same weights agree only as far as their draws do: the
JAX package and the port draw from different generators, and so do the
card and the CPU. `gmm_argmax_shared` takes the same place with no draw:
its 128 candidates are each component's mean plus its std times a fixed
vector of standard-normal quantiles (candidate j belongs to component
j mod K), and it returns the candidate of highest mixture log-prob.

The quantiles sit at the probabilities (j + 1/4) / 128, not (j + 1/2) /
128: no two candidates of one component then mirror each other about its
mean, so a component that dominates the mixture has one best candidate,
not two that tie up to rounding.

`shared_greedy_draws()` puts it in the covariant agent's module for the
length of a `with` block. Nothing else calls it: tests/test_torch_shared_draws.py
holds the port against the JAX package with it (a copy in JAX beside it),
and chip_smoke.py's phase 14d the card against the CPU.
"""
from __future__ import annotations

import contextlib
from statistics import NormalDist

import numpy as np
import torch

from molgym_tpu_torch.distributions.gmm import gmm_log_prob

COUNT = 128   # gmm_argmax's number of draws
QUANTILES = np.array([NormalDist().inv_cdf((j + 0.25) / COUNT)
                      for j in range(COUNT)], dtype=np.float32)


def candidates(means: torch.Tensor, stds: torch.Tensor) -> torch.Tensor:
    """[COUNT, ...] candidate distances of GMMs with means [..., K] and
    stds [K] or [..., K]."""
    comp = torch.arange(COUNT, device=means.device) % means.shape[-1]
    stds = stds.expand_as(means)
    q = torch.as_tensor(QUANTILES, device=means.device)
    return (means[..., comp] + stds[..., comp] * q).movedim(-1, 0)


def candidate_log_probs(log_weights: torch.Tensor, means: torch.Tensor,
                        stds: torch.Tensor):
    """(candidates [COUNT, ...], their mixture log-probs [COUNT, ...])."""
    cand = candidates(means, stds)
    return cand, gmm_log_prob(log_weights, means, stds, cand)


def gmm_argmax_shared(_generator, log_weights: torch.Tensor,
                      means: torch.Tensor, stds: torch.Tensor,
                      count: int = COUNT) -> torch.Tensor:
    """gmm_argmax's signature; the generator is not used."""
    if count != COUNT:
        raise ValueError(f'{count} candidates: the quantiles are {COUNT}')
    cand, logp = candidate_log_probs(log_weights, means, stds)
    best = torch.argmax(logp, dim=0)
    return torch.gather(cand, 0, best[None])[0]


@contextlib.contextmanager
def shared_greedy_draws():
    """The covariant agent's greedy distance from gmm_argmax_shared within
    the block, gmm_argmax again after it."""
    from molgym_tpu_torch.agents import covariant
    saved = covariant.gmm_argmax
    covariant.gmm_argmax = gmm_argmax_shared
    try:
        yield
    finally:
        covariant.gmm_argmax = saved
