"""Sequence math over the time axis (counterpart of
molgym_tpu/ops/scan_math.py): the discounted cumulative sum and a
terminal-aware GAE, each a reverse loop over T on the tensors' device (the
JAX package's reverse `lax.scan`)."""
from __future__ import annotations

from typing import Tuple

import torch


def discount_cumsum(x: torch.Tensor, discount: float) -> torch.Tensor:
    """y_t = sum_{k>=t} discount^(k-t) x_k along axis 0."""
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[0])
    for t in reversed(range(x.shape[0])):
        carry = x[t] + discount * carry
        out[t] = carry
    return out


def gae_advantages(
    rewards: torch.Tensor,  # [T, B]
    values: torch.Tensor,  # [T, B]
    terminals: torch.Tensor,  # [T, B] bool: episode ended at step t
    bootstrap_value: torch.Tensor,  # [B] V(s_T) at rollout cutoff
    gamma: float,
    lam: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE(lambda) advantages and discounted returns with per-step resets: a
    terminal at step t closes the trajectory with bootstrap 0, the rollout
    cutoff closes open trajectories with V(s_T)."""
    not_term = 1.0 - terminals.to(rewards.dtype)
    # v_{t+1}: next value inside the segment, bootstrap at the cutoff, zero
    # across terminals
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0) * not_term
    deltas = rewards + gamma * next_values - values

    adv = torch.empty_like(rewards)
    ret = torch.empty_like(rewards)
    carry_adv = torch.zeros_like(bootstrap_value)
    carry_ret = bootstrap_value
    for t in reversed(range(rewards.shape[0])):
        carry_adv = deltas[t] + gamma * lam * not_term[t] * carry_adv
        carry_ret = rewards[t] + gamma * not_term[t] * carry_ret
        adv[t] = carry_adv
        ret[t] = carry_ret
    return adv, ret
