"""Policy densities on the sphere S^2 (counterpart of
molgym_tpu/distributions/spherical.py).

  * SO3 (beta None): p(n) = |sum a_lm Y_lm(n)|^2 with normalized a_lm
  * ExpSO3 (beta set): p ∝ exp(-beta |...|^2), log-partition by a
    Gauss-Legendre product quadrature of order so3_quadrature_order(maxl)

Sampling is a Gumbel-categorical draw over a randomly rotated Fibonacci grid
(shape-static, no rejection loop); log_prob is the exact continuous density.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from molgym_tpu_torch.distributions.discrete import gumbel
from molgym_tpu_torch.draws import Rng, as_draws
from molgym_tpu_torch.ops.quadrature import gauss_legendre_sphere
from molgym_tpu_torch.ops.so3 import (generate_fibonacci_grid, normalize_alms,
                                      sum_product_alms_ylms)
from molgym_tpu_torch.ops.sph import spherical_harmonics

LOG_4PI = math.log(4.0 * math.pi)

_SAMPLE_GRID_N = 4096
_ARGMAX_GRID_N = 4096


@dataclasses.dataclass
class SO3Distribution:
    """coefficients: tuple of [B, tau, 2l+1, 2] (normalized); empty: bool[B]
    (uniform density for empty canvases); log_z: float32[B] (zero when
    beta is None)."""
    coefficients: Tuple[torch.Tensor, ...]
    empty: torch.Tensor
    log_z: torch.Tensor
    beta: Optional[float] = None

    @property
    def maxl(self) -> int:
        return len(self.coefficients) - 1


@functools.lru_cache(maxsize=None)
def _fibonacci_grid(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(generate_fibonacci_grid(n).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def _quadrature(n_theta: int, device: torch.device):
    points, weights = gauss_legendre_sphere(n_theta)
    return (torch.from_numpy(points.astype(np.float32)).to(device),
            torch.from_numpy(np.log(weights).astype(np.float32)).to(device))


def random_rotation_matrices(generator: Rng, n: int,
                             device) -> torch.Tensor:
    """Uniform random rotations via normalized quaternions -> [n, 3, 3]."""
    q = as_draws(generator).randn((n, 4), device=device)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _density_core(dist: SO3Distribution, points: torch.Tensor) -> torch.Tensor:
    """|sum a Y|^2 at points [..., B, 3] -> [..., B]."""
    y = spherical_harmonics(dist.maxl, points, normalize=True)
    s = sum_product_alms_ylms(dist.coefficients, y)
    return torch.square(s).sum(dim=-1)


def log_prob_unnormalized(dist: SO3Distribution, points: torch.Tensor) -> torch.Tensor:
    p = _density_core(dist, points)
    if dist.beta is None:
        return torch.log(p.clamp(min=1e-10))
    return -dist.beta * p


def log_prob(dist: SO3Distribution, points: torch.Tensor) -> torch.Tensor:
    """Exact continuous log-density at points [..., B, 3]."""
    lp = log_prob_unnormalized(dist, points) - dist.log_z
    return torch.where(dist.empty, torch.full_like(lp, -LOG_4PI), lp)


def so3_quadrature_order(maxl: int) -> int:
    """Gauss-Legendre theta order for the ExpSO3 log-partition: 6·maxl,
    floored at 24 (the validated maxl=4 configuration)."""
    return max(24, 6 * maxl)


def make_so3_distribution(a_lms: Sequence[torch.Tensor], empty: torch.Tensor,
                          beta: Optional[float] = None) -> SO3Distribution:
    coeffs = tuple(normalize_alms(a_lms))
    batch = coeffs[0].shape[0]
    device = coeffs[0].device
    zeros = torch.zeros((batch, ), dtype=torch.float32, device=device)
    if beta is None:
        return SO3Distribution(coefficients=coeffs, empty=empty, log_z=zeros)
    points, log_w = _quadrature(so3_quadrature_order(len(coeffs) - 1), device)
    dist0 = SO3Distribution(coefficients=coeffs, empty=empty, log_z=zeros,
                            beta=beta)
    lp_u = log_prob_unnormalized(dist0, points[:, None, :])  # [K, B]
    log_z = torch.logsumexp(lp_u + log_w[:, None], dim=0)
    return SO3Distribution(coefficients=coeffs, empty=empty, log_z=log_z,
                           beta=beta)


def sample(dist: SO3Distribution, generator: Rng) -> torch.Tensor:
    """One sample per batch element -> [B, 3]: Gumbel-categorical over a
    randomly rotated Fibonacci grid weighted by the density."""
    batch = dist.coefficients[0].shape[0]
    device = dist.coefficients[0].device
    grid = _fibonacci_grid(_SAMPLE_GRID_N, device)
    rots = random_rotation_matrices(generator, batch, device)  # [B, 3, 3]
    points = torch.einsum('bij,kj->kbi', rots, grid)  # [K, B, 3]
    logits = log_prob_unnormalized(dist, points)  # [K, B]
    logits = torch.where(dist.empty[None, :], torch.zeros_like(logits), logits)
    idx = torch.argmax(logits + gumbel(logits.shape, generator, device,
                                       batch_dim=1), dim=0)
    return points[idx, torch.arange(batch, device=device)]


def argmax(dist: SO3Distribution) -> torch.Tensor:
    """Mode estimate on a fixed fine grid (deterministic)."""
    grid = _fibonacci_grid(_ARGMAX_GRID_N, dist.coefficients[0].device)
    logits = log_prob_unnormalized(dist, grid[:, None, :])  # [K, B]
    return grid[torch.argmax(logits, dim=0)]
