"""SO(3) representation utilities (counterpart of molgym_tpu/ops/so3.py).

SO3Vec = list of tensors, entry l shaped [..., tau_l, 2l+1, 2] (complex as
trailing real/imag): grids, complex products, a_lm normalization, selection
helpers, the AtomicScalars invariants, and the Wigner-D rotations of the
covariance checks (numpy, float64, on the host; `apply_wigner` rotates the
port's tensors).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

SO3Vec = List[torch.Tensor]


def generate_fibonacci_grid(n: int) -> np.ndarray:
    """Quasi-uniform points on S^2 (offset Fibonacci lattice) [n, 3]."""
    golden_ratio = (1 + 5 ** 0.5) / 2
    index = np.arange(0, n)
    theta = np.arccos(1 - 2 * (index + 0.5) / n)
    phi = 2 * np.pi * index / golden_ratio
    return spherical_to_cartesian(np.stack([theta, phi], axis=-1))


def spherical_to_cartesian(theta_phi: np.ndarray) -> np.ndarray:
    theta, phi = theta_phi[..., 0], theta_phi[..., 1]
    return np.stack([np.sin(theta) * np.cos(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(theta)], axis=-1)


def cartesian_to_spherical(pos: np.ndarray) -> np.ndarray:
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    r = np.linalg.norm(pos, axis=-1)
    return np.stack([np.arccos(z / r), np.arctan2(y, x)], axis=-1)


def complex_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ai * br + ar * bi], dim=-1)


def sum_product_alms_ylms(a_lms: Sequence[torch.Tensor],
                          y_lms: Sequence[torch.Tensor]) -> torch.Tensor:
    """s = sum_l sum_tau sum_m a_ltm * Y_lm -> [..., 2]. a_lms entries are
    [B, tau, m, 2], y_lms entries [..., B, m, 2]; tau is summed first, which
    keeps the [..., B, tau, m] product out of memory."""
    total = None
    for a, y in zip(a_lms, y_lms):
        summand = complex_product(a.sum(dim=-3), y).sum(dim=-2)
        total = summand if total is None else total + summand
    return total


def get_normalization_constant(a_lms: Sequence[torch.Tensor]) -> torch.Tensor:
    """k = sum_l sum_m |sum_tau a_ltm|^2."""
    total = None
    for a in a_lms:
        item = torch.square(a.sum(dim=-3)).sum(dim=(-2, -1))
        total = item if total is None else total + item
    return total


def normalize_alms(a_lms: Sequence[torch.Tensor]) -> SO3Vec:
    k = get_normalization_constant(a_lms)
    inv = 1.0 / torch.sqrt(torch.clamp(k, min=1e-10))
    return [a * inv[..., None, None, None] for a in a_lms]


def select_atomic_covariats(vec: Sequence[torch.Tensor],
                            focus_oh: torch.Tensor) -> SO3Vec:
    """[B, N, tau, m, 2] x [B, N] -> [B, tau, m, 2]."""
    return [torch.einsum('bn,bntmx->btmx', focus_oh, part) for part in vec]


def select_atomic_invariats(invariats: torch.Tensor,
                            focus_oh: torch.Tensor) -> torch.Tensor:
    return torch.einsum('bn,bnf->bf', focus_oh, invariats)


def select_taus(vec: Sequence[torch.Tensor], indices: torch.Tensor) -> SO3Vec:
    """Gather tau channels [B, T, m, 2] at indices [B, K] -> [B, K, m, 2]."""
    out = []
    for part in vec:
        idx = indices[:, :, None, None].long().expand(
            -1, -1, part.shape[-2], part.shape[-1])
        out.append(torch.gather(part, 1, idx))
    return out


def atomic_scalars(vec: Sequence[torch.Tensor]) -> torch.Tensor:
    """Rotation-invariant features from an SO3Vec: the l=0 part, per-l
    self-products with parity signs, and per-l norms. Output dim
    (maxl+2) * tau * 2 (the JAX function's full_scalars form)."""
    scalars = [vec[0]]
    for l, part in enumerate(vec):
        sign_r = torch.tensor((-1.0) ** np.arange(-l, l + 1),
                              dtype=part.dtype, device=part.device)
        signs = torch.stack([sign_r, -sign_r], dim=-1)  # [2l+1, 2]
        s_prod = (signs * part * torch.flip(part, dims=(-2, ))).sum(
            dim=(-2, -1), keepdim=True)
        s_norm = (part * part).sum(dim=(-2, -1), keepdim=True)
        scalars.append(torch.cat([s_prod, s_norm], dim=-1))
    cat = torch.cat(scalars, dim=-3)
    return cat.reshape(cat.shape[:-3] + (-1, ))


def atomic_scalars_dim(maxl: int, channels: int) -> int:
    return (maxl + 2) * channels * 2


# -- Wigner rotations (host-side numpy, float64) --------------------------------

def wigner_d_small(l: int, beta: float) -> np.ndarray:
    """d^l_{m'm}(beta), indices ascending from -l."""
    d = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.float64)
    f = math.factorial
    cb, sb = math.cos(beta / 2.0), math.sin(beta / 2.0)
    for i_mp, mp in enumerate(range(-l, l + 1)):
        for i_m, m in enumerate(range(-l, l + 1)):
            pref = math.sqrt(f(l + mp) * f(l - mp) * f(l + m) * f(l - m))
            total = 0.0
            for k in range(max(0, m - mp), min(l + m, l - mp) + 1):
                denom = f(k) * f(l + m - k) * f(l - mp - k) * f(mp - m + k)
                total += ((-1.0) ** (mp - m + k) *
                          cb ** (2 * l + m - mp - 2 * k) *
                          sb ** (mp - m + 2 * k)) / denom
            d[i_mp, i_m] = pref * total
    return d


def wigner_D(l: int, alpha: float, beta: float, gamma: float) -> np.ndarray:
    """D^l_{m'm}(alpha, beta, gamma) = e^{-i m' alpha} d^l(beta) e^{-i m gamma}
    (zyz convention), complex128 [2l+1, 2l+1]."""
    d = wigner_d_small(l, beta)
    m = np.arange(-l, l + 1)
    return (np.exp(-1j * m[:, None] * alpha) * d *
            np.exp(-1j * m[None, :] * gamma))


def rotation_matrix(alpha: float, beta: float, gamma: float) -> np.ndarray:
    """R = Rz(alpha) @ Ry(beta) @ Rz(gamma)."""
    def rz(t):
        return np.array([[np.cos(t), -np.sin(t), 0],
                         [np.sin(t), np.cos(t), 0], [0, 0, 1]])

    def ry(t):
        return np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                         [-np.sin(t), 0, np.cos(t)]])

    return rz(alpha) @ ry(beta) @ rz(gamma)


def gen_rot(maxl: int, rng: np.random.RandomState
            ) -> Tuple[List[np.ndarray], np.ndarray, Tuple[float, float, float]]:
    """A random rotation: its Wigner-D matrices for l = 0..maxl, its 3x3
    matrix and its Euler angles, drawn from `rng`."""
    alpha = float(rng.uniform(0, 2 * np.pi))
    beta = float(np.arccos(rng.uniform(-1, 1)))
    gamma = float(rng.uniform(0, 2 * np.pi))
    ds = [wigner_D(l, alpha, beta, gamma) for l in range(maxl + 1)]
    return ds, rotation_matrix(alpha, beta, gamma), (alpha, beta, gamma)


def apply_wigner(a_lms: Sequence[torch.Tensor],
                 wigner: Sequence[np.ndarray]) -> SO3Vec:
    """Rotate coefficients [..., 2l+1, 2] by the Wigner-D matrices of
    gen_rot: if f(x) = sum a_lm Y_lm(x), the function rotated by R (g(x) =
    f(R^-1 x)) has b_{l m'} = sum_m D^l_{m' m} a_{l m}. The matrices are
    rounded to the coefficients' dtype on their device."""
    out = []
    for a, D in zip(a_lms, wigner):
        dr = torch.as_tensor(np.real(D), dtype=a.dtype, device=a.device)
        di = torch.as_tensor(np.imag(D), dtype=a.dtype, device=a.device)
        ar, ai = a[..., 0], a[..., 1]
        br = (torch.einsum('pm,...m->...p', dr, ar) -
              torch.einsum('pm,...m->...p', di, ai))
        bi = (torch.einsum('pm,...m->...p', dr, ai) +
              torch.einsum('pm,...m->...p', di, ar))
        out.append(torch.stack([br, bi], dim=-1))
    return out
