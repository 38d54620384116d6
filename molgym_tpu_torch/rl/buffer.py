"""Trajectory storage and PPO data preparation (counterpart of
molgym_tpu/rl/buffer.py): a rollout is a fixed [T, B] set of tensors; GAE
with per-step terminal resets, flattened to [T*B] with the advantages
standardized. The statistics helpers are numpy, on host copies."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from molgym_tpu_torch.ops.scan_math import gae_advantages
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

    def to_numpy(self) -> dict:
        """Host copy of every field, for savers and statistics."""
        out = {}
        for field in dataclasses.fields(self):
            value = getattr(self, field.name)
            if isinstance(value, Observation):
                value = {k: v.cpu().numpy()
                         for k, v in dataclasses.asdict(value).items()}
            else:
                value = value.cpu().numpy()
            out[field.name] = value
        return out


def compute_ppo_data(traj: Trajectory, gamma: float,
                     lam: float) -> Dict[str, object]:
    """GAE + returns + flatten + advantage standardization (population std,
    as jnp.std)."""
    adv, ret = gae_advantages(traj.rewards, traj.values, traj.terminals,
                              traj.bootstrap_value, gamma, lam)
    adv_flat = adv.reshape(-1)
    adv_std = ((adv_flat - adv_flat.mean()) /
               adv_flat.std(correction=0).clamp(min=1e-8))
    return dict(
        obs=traj.obs.map(lambda x: x.reshape((-1, ) + x.shape[2:])),
        act=traj.actions.reshape((-1, ) + traj.actions.shape[2:]),
        ret=ret.reshape(-1),
        adv=adv_std,
        logp=traj.logps.reshape(-1),
    )


def buffer_stats(traj: Trajectory) -> Dict[str, float]:
    """Value/logp statistics."""
    values = traj.values.cpu().numpy()
    logps = traj.logps.cpu().numpy()
    return {
        'value_mean': float(values.mean()),
        'value_std': float(values.std()),
        'logp_mean': float(logps.mean()),
        'logp_std': float(logps.std()),
    }


def episode_stats(rewards: np.ndarray, terminals: np.ndarray,
                  gamma: float) -> Tuple[List[float], List[int]]:
    """Episodic (discounted) returns and lengths for episodes that TERMINATE
    inside the rollout; truncated episodes are excluded.

    Vectorized with segment sums: episodes are the terminal-delimited
    segments of each env column; a segment's return is
    sum_t gamma^(t - segment_start) * r_t over the segment. Output order:
    env-major, then time.
    """
    rewards = np.asarray(rewards, dtype=np.float64)
    terminals = np.asarray(terminals, dtype=bool)
    T, B = rewards.shape
    if T == 0 or B == 0:
        return [], []
    t_idx = np.arange(T)[:, None]
    # segment id within each column: exclusive cumulative terminal count
    seg = np.zeros((T, B), dtype=np.int64)
    seg[1:] = np.cumsum(terminals[:-1], axis=0)
    # segment start row: last row at-or-before t that begins a segment
    is_start = np.zeros((T, B), dtype=bool)
    is_start[0] = True
    is_start[1:] = terminals[:-1]
    start_t = np.maximum.accumulate(np.where(is_start, t_idx, -1), axis=0)
    contrib = rewards * np.power(gamma, t_idx - start_t)
    # global segment id, env-major
    gseg = (seg + np.arange(B)[None, :] * (T + 1)).ravel()
    n_bins = B * (T + 1)
    seg_return = np.bincount(gseg, weights=contrib.ravel(), minlength=n_bins)
    seg_length = np.bincount(gseg, minlength=n_bins)
    seg_done = np.bincount(gseg, weights=terminals.ravel(),
                           minlength=n_bins) > 0
    return (seg_return[seg_done].tolist(),
            seg_length[seg_done].astype(int).tolist())
