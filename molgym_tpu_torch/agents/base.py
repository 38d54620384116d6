"""Actor-critic interface (counterpart of molgym_tpu/agents/base.py).

Agents are nn.Modules with two paths:

  * act(obs, generator, deterministic) -> AgentOutput  (rollout / greedy)
  * evaluate(obs, action_flat) -> (logp, ent, v)        (PPO re-evaluation)

`action_flat` is the agent's flat sub-action tensor; `element`/`position`
are the environment action derived on the device.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AgentOutput:
    action_flat: torch.Tensor  # float32[B, A] flat sub-actions
    element: torch.Tensor  # int64[B] element index (into zs)
    position: torch.Tensor  # float32[B, 3] Cartesian placement
    logp: torch.Tensor  # float32[B]
    ent: torch.Tensor  # float32[B]
    v: torch.Tensor  # float32[B]
