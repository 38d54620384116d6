"""SO(3) representation utilities (counterpart of molgym_tpu/ops/so3.py).

SO3Vec = list of tensors, entry l shaped [..., tau_l, 2l+1, 2] (complex as
trailing real/imag): grids, complex products, a_lm normalization, selection
helpers and the AtomicScalars invariants.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

SO3Vec = List[torch.Tensor]


def generate_fibonacci_grid(n: int) -> np.ndarray:
    """Quasi-uniform points on S^2 (offset Fibonacci lattice) [n, 3]."""
    golden_ratio = (1 + 5 ** 0.5) / 2
    index = np.arange(0, n)
    theta = np.arccos(1 - 2 * (index + 0.5) / n)
    phi = 2 * np.pi * index / golden_ratio
    return np.stack([np.sin(theta) * np.cos(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(theta)], axis=-1)


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
