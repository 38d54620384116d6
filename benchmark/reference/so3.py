"""Plain SO(3) algebra of the reference: Clebsch-Gordan tables (exact, by
the Racah formula), complex spherical harmonics, the sphere's quadrature
and the rotation-invariant scalars of a covariant rep.

Written from the equations of the Cormorant network and the MolGym
covariant agent; it imports nothing of the program. Complex values are
torch complex tensors here; the rotation-invariant scalars take the
(real, imag) stacked form, whose feature order the policy's weights
expect.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch
from scipy.special import roots_legendre


@lru_cache(maxsize=None)
def cg_coefficient(l1: int, m1: int, l2: int, m2: int, l: int, m: int) -> float:
    """<l1 m1 l2 m2 | l m> by the Racah formula, in float64."""
    if m1 + m2 != m or l < abs(l1 - l2) or l > l1 + l2:
        return 0.0
    if abs(m1) > l1 or abs(m2) > l2 or abs(m) > l:
        return 0.0
    f = math.factorial
    pre = math.sqrt((2 * l + 1) * f(l + l1 - l2) * f(l - l1 + l2)
                    * f(l1 + l2 - l) / f(l1 + l2 + l + 1))
    pre *= math.sqrt(f(l + m) * f(l - m) * f(l1 - m1) * f(l1 + m1)
                     * f(l2 - m2) * f(l2 + m2))
    total = 0.0
    for k in range(max(0, l2 - l - m1, l1 + m2 - l),
                   min(l1 + l2 - l, l1 - m1, l2 + m2) + 1):
        total += (-1.0) ** k / (f(k) * f(l1 + l2 - l - k) * f(l1 - m1 - k)
                                * f(l2 + m2 - k) * f(l - l2 + m1 + k)
                                * f(l - l1 - m2 + k))
    return pre * total


def blocks(n_ells1: int, n_ells2: int, maxl: int) -> List[Tuple[int, int, int]]:
    """The (l, l1, l2) blocks of a product's output, grouped by l, the
    (l1, l2) pairs in loop order within an l."""
    return [(l, l1, l2) for l in range(maxl + 1) for l1 in range(n_ells1)
            for l2 in range(n_ells2) if abs(l1 - l2) <= l <= l1 + l2]


@lru_cache(maxsize=None)
def product_table(n_ells1: int, n_ells2: int, maxl: int):
    """Dense CG table [M1, M2, K] of a product of a rep with l < n_ells1 and
    one with l < n_ells2, truncated at maxl, and its per-l (offset, pairs)
    slices of K: each (l, l1, l2) block takes 2l+1 consecutive columns."""
    off1 = np.cumsum([0] + [2 * l + 1 for l in range(n_ells1)])
    off2 = np.cumsum([0] + [2 * l + 1 for l in range(n_ells2)])
    bl = blocks(n_ells1, n_ells2, maxl)
    table = np.zeros((off1[-1], off2[-1], sum(2 * l + 1 for l, _a, _b in bl)))
    slices, k = [], 0
    for l in range(maxl + 1):
        start, pairs = k, 0
        for lo, l1, l2 in bl:
            if lo != l:
                continue
            for i1, m1 in enumerate(range(-l1, l1 + 1)):
                for i2, m2 in enumerate(range(-l2, l2 + 1)):
                    if abs(m1 + m2) <= l:
                        table[off1[l1] + i1, off2[l2] + i2, k + m1 + m2 + l] = \
                            cg_coefficient(l1, m1, l2, m2, l, m1 + m2)
            pairs += 1
            k += 2 * l + 1
        slices.append((start, pairs))
    return table.astype(np.float32), tuple(slices)


def m_slices(n_ells: int, maxl: int) -> Tuple[Tuple[int, int], ...]:
    """Slices of a rep in m form: one 'pair' for each l it carries."""
    return tuple((l * l, 1 if l < n_ells else 0) for l in range(maxl + 1))


def spherical_harmonics(maxl: int, pos: torch.Tensor,
                        conj: bool = False) -> torch.Tensor:
    """Y_lm at the directions of `pos` [..., 3], l = 0..maxl packed along
    the last axis (m ascending from -l), complex; Condon-Shortley phase,
    unit norm over the sphere."""
    r = torch.sqrt(torch.clamp((pos * pos).sum(-1), min=1e-24))
    x, y, z = pos[..., 0] / r, pos[..., 1] / r, pos[..., 2] / r
    u = torch.complex(x, y)
    u_pow = [torch.ones_like(u)]
    for _ in range(maxl):
        u_pow.append(u_pow[-1] * u)
    # P_l^m(z) / sin^m by the standard recursion
    p = {}
    for m in range(maxl + 1):
        p[(m, m)] = torch.full_like(z, (-1.0) ** m * float(
            np.prod(np.arange(1, 2 * m, 2), dtype=np.float64)))
        if m + 1 <= maxl:
            p[(m + 1, m)] = (2 * m + 1) * z * p[(m, m)]
        for l in range(m + 2, maxl + 1):
            p[(l, m)] = ((2 * l - 1) * z * p[(l - 1, m)]
                         - (l + m - 1) * p[(l - 2, m)]) / (l - m)
    out = []
    for l in range(maxl + 1):
        for m in range(-l, l + 1):
            a = abs(m)
            norm = math.sqrt((2 * l + 1) / (4 * math.pi) * math.factorial(l - a)
                             / math.factorial(l + a))
            y_lm = norm * p[(l, a)] * u_pow[a]
            if m < 0:
                y_lm = (-1.0) ** a * torch.conj(y_lm)
            out.append(torch.conj(y_lm) if conj else y_lm)
    return torch.stack(out, dim=-1)


@lru_cache(maxsize=None)
def sphere_quadrature(n_theta: int):
    """Gauss-Legendre in cos(theta) times the trapezoid in phi (2 n_theta
    points): (points [K, 3], log weights [K]), the weights summing to 4 pi."""
    x, w = roots_legendre(n_theta)
    n_phi = 2 * n_theta
    phi = np.tile(2 * np.pi * np.arange(n_phi) / n_phi, n_theta)
    cos_t = np.repeat(x, n_phi)
    sin_t = np.sqrt(np.maximum(1 - cos_t ** 2, 0))
    points = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], -1)
    return (points.astype(np.float32),
            np.log(np.repeat(w, n_phi) * 2 * np.pi / n_phi).astype(np.float32))


def split_l(rep: torch.Tensor, maxl: int) -> List[torch.Tensor]:
    """A complex rep [..., tau, (maxl+1)^2] as its per-l parts
    [..., tau, 2l+1]."""
    return [rep[..., l * l:(l + 1) * (l + 1)] for l in range(maxl + 1)]


def invariants(parts: List[torch.Tensor]) -> torch.Tensor:
    """Rotation-invariant features of per-l complex parts [..., tau, 2l+1]:
    the l = 0 part, then for each l the parity-signed self product
    sum_m (-1)^m a_m a_-m (real part) and the squared norm; features ordered
    (block, tau, real/imag) as the policy's layers take them."""
    feats = [torch.stack([parts[0].real, parts[0].imag], -1)[..., 0, :]]
    for l, a in enumerate(parts):
        sign = torch.tensor([(-1.0) ** m for m in range(-l, l + 1)],
                            dtype=a.real.dtype, device=a.device)
        prod = (sign * (a * torch.flip(a, dims=(-1, )))).sum(-1).real
        norm = (a.real ** 2 + a.imag ** 2).sum(-1)
        feats.append(torch.stack([prod, norm], -1))
    cat = torch.cat(feats, dim=-2)                  # [..., blocks * tau, 2]
    return cat.reshape(cat.shape[:-2] + (-1, ))
