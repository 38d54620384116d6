"""SchNet atom encoder (counterpart of molgym_tpu/agents/schnet.py):
element embeddings and continuous-filter convolutions (cfconv) over a
Gaussian RBF expansion of the distances with a cosine cutoff, dense over
the padded canvas [B, N, N] with masks.

The cfconv is the einsum 'bijf,bjf->bif', a torch op: the JAX package
computes it outside any Pallas kernel too. Initial weights follow Flax's
initializers (lecun_normal for the interactions' Linears, a normal of
variance 1 / features for the embedding), so that a run from scratch starts
from the JAX package's distribution."""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from molgym_tpu_torch.device import DeviceLike

_LOG2 = math.log(2.0)
# the standard deviation of a unit normal truncated to [-2, 2], which Flax's
# truncated_normal variance scaling divides by
_TRUNC_STD = 0.87962566103423978


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log 2. F.softplus returns x itself above 20, where
    Flax's logaddexp(x, 0) adds log1p(exp(-x)) < 2.1e-9: below one float32
    ulp of x."""
    return F.softplus(x) - _LOG2


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """Flax's lecun_normal: a normal truncated at two standard deviations,
    scaled to variance 1 / fan_in (weight [out, in])."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


def dense(d_in: int, d_out: int, bias: bool = True) -> nn.Linear:
    """A Linear initialised as Flax's Dense: lecun_normal, zero bias."""
    layer = nn.Linear(d_in, d_out, bias=bias)
    lecun_normal_(layer.weight)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class GaussianRBF(nn.Module):
    """exp(-gamma (d - c)^2) at n_rbf centers from 0 to cutoff."""

    def __init__(self, n_rbf: int = 25, cutoff: float = 5.0):
        super().__init__()
        centers = torch.linspace(0.0, cutoff, n_rbf)
        width = centers[1] - centers[0]
        self.register_buffer('centers', centers, persistent=False)
        self.gamma = float(0.5 / (width * width))

    def forward(self, distances: torch.Tensor) -> torch.Tensor:
        diff = distances[..., None] - self.centers
        return torch.exp(-self.gamma * diff * diff)


def cosine_cutoff(distances: torch.Tensor, cutoff: float) -> torch.Tensor:
    f = 0.5 * (torch.cos(math.pi * distances.clamp(max=cutoff) / cutoff) + 1.0)
    return torch.where(distances < cutoff, f, torch.zeros_like(f))


class SchNetInteraction(nn.Module):
    """One interaction block; its five Linears are the Flax block's
    Dense_0 .. Dense_4 in order (convert.py maps the names)."""

    def __init__(self, n_atom_basis: int, n_filters: int, n_rbf: int):
        super().__init__()
        self.filter_in = dense(n_rbf, n_filters)
        self.filter_out = dense(n_filters, n_filters)
        self.in2f = dense(n_atom_basis, n_filters, bias=False)
        self.f2out = dense(n_filters, n_atom_basis)
        self.out = dense(n_atom_basis, n_atom_basis)

    def forward(self, x: torch.Tensor, rbf: torch.Tensor,
                pair_mask: torch.Tensor) -> torch.Tensor:
        # x [B, N, F]; rbf [B, N, N, G]; pair_mask [B, N, N]
        w = self.filter_out(shifted_softplus(self.filter_in(rbf)))
        w = w * pair_mask[..., None]
        y = self.in2f(x)
        # continuous-filter convolution: sum_j W(r_ij) * y_j
        messages = torch.einsum('bijf,bjf->bif', w, y)
        return self.out(shifted_softplus(self.f2out(messages)))


class SchNetEncoder(nn.Module):
    """Maps (elements [B, N], positions [B, N, 3], bag [B, Z]) to per-atom
    features [B, N, n_atom_basis], zero on the empty slots."""

    def __init__(self, num_zs: int, n_atom_basis: int = 64,
                 n_filters: int = 64, n_interactions: int = 3,
                 n_rbf: int = 25, cutoff: float = 5.0):
        super().__init__()
        self.cutoff = cutoff
        self.embedding = nn.Embedding(num_zs, n_atom_basis)
        # Flax's nn.Embed: a normal of variance 1 / features
        nn.init.normal_(self.embedding.weight, std=math.sqrt(1.0 / n_atom_basis))
        self.rbf = GaussianRBF(n_rbf=n_rbf, cutoff=cutoff)
        self.interactions = nn.ModuleList(
            SchNetInteraction(n_atom_basis, n_filters, n_rbf)
            for _ in range(n_interactions))

    def forward(self, elements: torch.Tensor, positions: torch.Tensor,
                bag: torch.Tensor) -> torch.Tensor:
        n = elements.shape[1]
        occupied = elements != 0
        x = self.embedding(elements)

        diff = positions[:, :, None, :] - positions[:, None, :, :]
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1).clamp(min=1e-12))
        eye = torch.eye(n, dtype=torch.bool, device=elements.device)
        pair_mask = occupied[:, :, None] & occupied[:, None, :] & ~eye
        pair_mask = pair_mask.to(x.dtype) * cosine_cutoff(dist, self.cutoff)
        rbf = self.rbf(dist)

        for interaction in self.interactions:
            x = x + interaction(x, rbf, pair_mask)
        return x * occupied[..., None].to(x.dtype)


def make_schnet_agent(num_zs: int, canvas_size: int, network_width: int = 128,
                      min_max_distance: Tuple[float, float] = (0.8, 1.8),
                      n_interactions: int = 3, device: DeviceLike = None):
    """The SchNet actor-critic: n_atom_basis = n_filters = width // 2, on
    `device` (cuda unless named)."""
    from molgym_tpu_torch.agents.internal import InternalAC
    num_afeats = network_width // 2
    encoder = SchNetEncoder(num_zs=num_zs, n_atom_basis=num_afeats,
                            n_filters=num_afeats, n_interactions=n_interactions)
    return InternalAC(num_zs=num_zs, canvas_size=canvas_size,
                      network_width=network_width,
                      min_max_distance=min_max_distance,
                      num_afeats=num_afeats, encoder=encoder, device=device)
