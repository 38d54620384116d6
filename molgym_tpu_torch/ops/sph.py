"""Complex spherical harmonics with quantum-mechanical normalization
(counterpart of molgym_tpu/ops/sph.py).

Condon-Shortley phase, m ascending from -l to +l, ∫|Y_lm|^2 dΩ = 1, complex
numbers as a trailing (real, imag) axis of size 2. Trig-free: with
x = cosθ and u = (px + i·py)/r, sinθ^m · e^{imφ} = u^m, so the associated
Legendre factors reduce to polynomials P̃_l^m(x) = P_l^m(x)/sinθ^m from the
standard stable recursion.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch


def _norm_coeff(l: int, m: int) -> float:
    return math.sqrt((2 * l + 1) / (4.0 * math.pi) *
                     math.factorial(l - m) / math.factorial(l + m))


def spherical_harmonics(maxl: int, pos: torch.Tensor, normalize: bool = True,
                        conj: bool = False) -> List[torch.Tensor]:
    """Y_lm for l = 0..maxl at directions `pos` [..., 3]; entry l is
    [..., 2l+1, 2]."""
    px, py, pz = pos[..., 0], pos[..., 1], pos[..., 2]
    if normalize:
        r = torch.sqrt(torch.clamp(px * px + py * py + pz * pz, min=1e-24))
        px, py, pz = px / r, py / r, pz / r

    x = pz
    u_pows_r = [torch.ones_like(px)]
    u_pows_i = [torch.zeros_like(px)]
    for _m in range(1, maxl + 1):
        ur, ui = u_pows_r[-1], u_pows_i[-1]
        u_pows_r.append(ur * px - ui * py)
        u_pows_i.append(ur * py + ui * px)

    ptilde = {}
    for m in range(0, maxl + 1):
        pmm = ((-1.0) ** m) * float(np.prod(np.arange(1, 2 * m, 2), dtype=np.float64))
        ptilde[(m, m)] = torch.full_like(x, pmm)
        if m + 1 <= maxl:
            ptilde[(m + 1, m)] = (2 * m + 1) * x * ptilde[(m, m)]
        for l in range(m + 2, maxl + 1):
            ptilde[(l, m)] = ((2 * l - 1) * x * ptilde[(l - 1, m)] -
                              (l + m - 1) * ptilde[(l - 2, m)]) / (l - m)

    out: List[torch.Tensor] = []
    sign = -1.0 if conj else 1.0
    for l in range(0, maxl + 1):
        comps = []
        for m in range(-l, l + 1):
            am = abs(m)
            base = _norm_coeff(l, am) * ptilde[(l, am)]
            yr = base * u_pows_r[am]
            yi = base * u_pows_i[am]
            if m < 0:
                # Y_{l,-m} = (-1)^m conj(Y_{lm})
                phase = (-1.0) ** am
                yr, yi = phase * yr, -phase * yi
            comps.append(torch.stack([yr, sign * yi], dim=-1))
        out.append(torch.stack(comps, dim=-2))
    return out


def spherical_harmonics_rel(maxl: int, pos1: torch.Tensor, pos2: torch.Tensor,
                            conj: bool = True
                            ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Relative harmonics Y_lm(r_i - r_j) and norms |r_i - r_j|:
    pos1 [..., N, 3], pos2 [..., M, 3] -> per-l [..., N, M, 2l+1, 2] and
    norms [..., N, M]."""
    rel = pos1[..., :, None, :] - pos2[..., None, :, :]
    norms = torch.sqrt(torch.clamp((rel * rel).sum(dim=-1), min=1e-24))
    sph = spherical_harmonics(maxl, rel, normalize=True, conj=conj)
    return sph, norms
