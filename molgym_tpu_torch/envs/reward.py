"""Device rewards (counterpart of molgym_tpu/envs/reward.py): Lennard-Jones
and Morse pair potentials between the new atom and the canvas, and the
solvation distance penalty. The host rewards (PM6, EHT, the native pair
potentials) have the same contract: calculators/reward_host.py.

Batched reward contract:
    reward_fn(positions[B,N,3], zs[B,N], new_pos[B,3], new_z[B], valid[B])
        -> rewards[B] float32
where `zs` are atomic numbers (0 = padding) and `valid` marks envs whose
reward is needed.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from molgym_tpu_torch.periodic import covalent_radius

RewardFn = Callable[..., torch.Tensor]

_MAX_Z = 36  # table size covers H..Kr


def _sigma_table() -> np.ndarray:
    # LJ minimum at the sum of covalent radii: r_min = 2^(1/6) * sigma.
    r = np.array([2.0 * covalent_radius(z) for z in range(_MAX_Z)], dtype=np.float32)
    return (r / 2.0 ** (1.0 / 6.0)).astype(np.float32)


def make_lennard_jones_reward(epsilon: float = 0.15) -> RewardFn:
    """Batched LJ interaction reward, epsilon in 'Hartree-like' units."""
    sigma_np = torch.from_numpy(_sigma_table())

    def reward_fn(positions, zs, new_pos, new_z, valid):
        sigma = sigma_np.to(positions.device)
        diff = positions - new_pos[:, None, :]
        r2 = (diff * diff).sum(dim=-1).clamp(min=1e-4)
        mask = zs > 0
        sig_ij = 0.5 * (sigma[zs.clamp(0, _MAX_Z - 1)] +
                        sigma[new_z.clamp(0, _MAX_Z - 1)][:, None])
        s6 = (sig_ij * sig_ij / r2) ** 3
        pair_e = 4.0 * epsilon * (s6 * s6 - s6)
        interaction = torch.where(mask, pair_e, torch.zeros_like(pair_e)).sum(dim=-1)
        reward = -interaction
        return torch.where(valid, reward, torch.zeros_like(reward)).float()

    return reward_fn


def make_morse_reward(depth: float = 0.15, a: float = 1.7) -> RewardFn:
    """Batched Morse-potential interaction reward."""
    r_cov_np = torch.tensor([covalent_radius(z) for z in range(_MAX_Z)],
                            dtype=torch.float32)

    def reward_fn(positions, zs, new_pos, new_z, valid):
        r_cov = r_cov_np.to(positions.device)
        diff = positions - new_pos[:, None, :]
        r = torch.sqrt((diff * diff).sum(dim=-1).clamp(min=1e-8))
        mask = zs > 0
        r_eq = (r_cov[zs.clamp(0, _MAX_Z - 1)] +
                r_cov[new_z.clamp(0, _MAX_Z - 1)][:, None])
        x = torch.exp(-a * (r - r_eq))
        pair_e = depth * (x * x - 2.0 * x)
        interaction = torch.where(mask, pair_e, torch.zeros_like(pair_e)).sum(dim=-1)
        return torch.where(valid, -interaction, torch.zeros_like(interaction)).float()

    return reward_fn


def with_solvation_penalty(reward_fn: RewardFn,
                           distance_penalty: float = 0.01) -> RewardFn:
    """`reward_fn` less distance_penalty * |new_pos| where valid (the
    reference's SolvationReward, molgym/reward.py:75-100)."""

    def wrapped(positions, zs, new_pos, new_z, valid):
        base = reward_fn(positions, zs, new_pos, new_z, valid)
        dist = torch.linalg.norm(new_pos, dim=-1)
        return torch.where(valid, base - distance_penalty * dist, base).float()

    return wrapped


def get_minimum_spin_multiplicity(zs: Iterable[int]) -> int:
    """(sum of Z) mod 2 + 1 (reference molgym/reward.py:17-19)."""
    return int(sum(int(z) for z in zs)) % 2 + 1
