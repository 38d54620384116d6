"""Spherical quadrature grids (the port's own copy of
molgym_tpu/ops/quadrature.py): a Gauss-Legendre x uniform-phi product grid,
exact for spherical-harmonic integrands up to degree 2*n_theta - 1.

Weights sum to 4*pi: integral(f dOmega) ~= sum_i w_i f(x_i).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
from scipy.special import roots_legendre


@lru_cache(maxsize=None)
def gauss_legendre_sphere(n_theta: int = 36,
                          n_phi: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Product quadrature on S^2: Gauss-Legendre in cos(theta), trapezoid
    (exact for trig polynomials) in phi. Returns (points [K, 3], weights [K])
    float64; exact for harmonics of degree <= min(2*n_theta-1, n_phi-1)."""
    if n_phi <= 0:
        n_phi = 2 * n_theta
    x, w = roots_legendre(n_theta)  # x = cos(theta) nodes on [-1, 1]
    phi = 2.0 * np.pi * np.arange(n_phi) / n_phi
    w_phi = 2.0 * np.pi / n_phi

    cos_t = np.repeat(x, n_phi)
    sin_t = np.sqrt(np.maximum(1.0 - cos_t ** 2, 0.0))
    phis = np.tile(phi, n_theta)
    points = np.stack([sin_t * np.cos(phis), sin_t * np.sin(phis), cos_t], axis=-1)
    weights = np.repeat(w, n_phi) * w_phi
    return points, weights
