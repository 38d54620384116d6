"""Plain reference of the PPO update the MolGym agents train with: GAE with
per-step terminal resets, advantages standardized over the batch, the
clipped surrogate with the value and entropy terms, and one clipped Adam
step an epoch (optax's clip_by_global_norm and adam, b1 0.9, b2 0.999,
eps 1e-8). The loss and its gradient are summed over blocks of rows, so
that a batch of thousands fits beside the plain encoder's intermediates.
Nothing of the program is imported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from reference import covariant

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def settings(config: dict) -> dict:
    return dict(gamma=float(config['discount']), lam=float(config['lam']),
                clip=float(config['clip_ratio']), vf=float(config['vf_coef']),
                ent=float(config['entropy_coef']),
                lr=float(config['learning_rate']),
                max_norm=float(config['gradient_clip']))


def gae(rewards, values, terminals, bootstrap, gamma: float, lam: float):
    """(advantages, returns) [T, B]: a terminal at t closes its episode with
    no bootstrap; the rollout's end bootstraps from V(s_T)."""
    T = rewards.shape[0]
    live = 1.0 - terminals.float()
    nxt = torch.cat([values[1:], bootstrap[None]]) * live
    delta = rewards + gamma * nxt - values
    adv, ret = torch.zeros_like(rewards), torch.zeros_like(rewards)
    a, r = torch.zeros_like(bootstrap), bootstrap
    for t in reversed(range(T)):
        a = delta[t] + gamma * lam * live[t] * a
        r = rewards[t] + gamma * live[t] * r
        adv[t], ret[t] = a, r
    adv = adv.reshape(-1)
    return (adv - adv.mean()) / adv.std(correction=0).clamp(min=1e-8), ret.reshape(-1)


def loss_and_grad(params: Dict[str, torch.Tensor], agent: dict, ppo: dict,
                  obs, actions, old_logp, adv, ret, rows: int
                  ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
    """The PPO loss of the whole batch (each row weighted 1/n) and its
    gradient, summed over blocks of `rows`."""
    n = actions.shape[0]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    total = dict(total_loss=0.0, approx_kl=0.0)
    for i in range(0, n, rows):
        sl = slice(i, i + rows)
        logp, ent, v = covariant.evaluate(
            leaves, agent, obs['elements'][sl], obs['positions'][sl],
            obs['bag'][sl], actions[sl])
        ratio = torch.exp(logp - old_logp[sl])
        surrogate = torch.minimum(ratio * adv[sl], ratio.clamp(
            1 - ppo['clip'], 1 + ppo['clip']) * adv[sl])
        loss = (-surrogate.sum() - ppo['ent'] * ent.sum()
                + ppo['vf'] * ((v - ret[sl]) ** 2).sum()) / n
        got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        for k, g in zip(leaves, got):
            if g is not None:
                grads[k] += g
        total['total_loss'] += float(loss.detach())
        total['approx_kl'] += float((old_logp[sl] - logp.detach()).sum()) / n
    return total, grads


class Adam:
    """clip_by_global_norm(max_norm) then adam(lr), as optax computes them,
    from a fresh state or from `state` (count, mu, nu) where given."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, max_norm: float,
                 state: dict = None):
        self.lr, self.max_norm, self.count = lr, max_norm, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        if state is not None:
            self.count = state['count']
            self.mu = {k: state['mu'][k].clone() for k in params}
            self.nu = {k: state['nu'][k].clone() for k in params}

    def clipped(self, grads):
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = 1.0 if float(norm) < self.max_norm else self.max_norm / float(norm)
        return {k: g * scale for k, g in grads.items()}

    def step(self, params, grads):
        self.count += 1
        c1 = float(1 - np.float32(B1) ** np.float32(self.count))
        c2 = float(1 - np.float32(B2) ** np.float32(self.count))
        out = {}
        for k, g in self.clipped(grads).items():
            self.mu[k] = (1 - B1) * g + B1 * self.mu[k]
            self.nu[k] = (1 - B2) * g * g + B2 * self.nu[k]
            out[k] = params[k] - self.lr * (self.mu[k] / c1) / (
                torch.sqrt(self.nu[k] / c2) + ADAM_EPS)
        return out
