"""Trajectory storage (counterpart of the Trajectory container of
molgym_tpu/rl/buffer.py): a rollout is a fixed [T, B] set of tensors."""
from __future__ import annotations

import dataclasses

import torch

from molgym_tpu_torch.spaces import Observation


@dataclasses.dataclass
class Trajectory:
    obs: Observation  # [T, B, ...]
    next_obs: Observation  # [T, B, ...] post-step, pre-reset
    actions: torch.Tensor  # float32[T, B, A]
    rewards: torch.Tensor  # float32[T, B]
    terminals: torch.Tensor  # bool[T, B]
    values: torch.Tensor  # float32[T, B]
    logps: torch.Tensor  # float32[T, B]
    bootstrap_value: torch.Tensor  # float32[B]

    @property
    def num_steps(self) -> int:
        return self.rewards.shape[0] * self.rewards.shape[1]
