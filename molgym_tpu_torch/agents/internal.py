"""Internal-coordinates actor-critic family (counterpart of
molgym_tpu/agents/internal.py): an atom encoder (SchNet, agents/schnet.py,
or a per-atom MLP) and one stack of autoregressive heads:

  focus (masked categorical over the canvas) -> element (masked by the bag)
  -> distance, angle, dihedral (tanh-squashed Gaussian means, learned global
  log-stds) -> kappa, the dihedral's sign, scored by encoding the canvas
  with the atom placed at either sign.

The three categorical heads (focus, element, kappa) go through
`categorical_head`: one fused kernel each way on the card. Kappa's head has
an all-true mask (the JAX package takes an unmasked softmax: the same
values) and its entropy enters no loss, so its backward receives no entropy
gradient. The z-matrix placement runs on the device (ops/zmat.py).

Flat sub-action layout: [stop, focus, element, distance, angle, dihedral,
kappa]   (7,)
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from molgym_tpu_torch.agents.base import AgentOutput
from molgym_tpu_torch.agents.modules import MLP
from molgym_tpu_torch.device import DeviceLike, resolve_device
from molgym_tpu_torch.distributions.discrete import (categorical_head,
                                                     normal_log_prob,
                                                     normal_sample)
from molgym_tpu_torch.draws import Rng
from molgym_tpu_torch.ops import zmat
from molgym_tpu_torch.ops.masked import masked_sum, to_one_hot
from molgym_tpu_torch.spaces import Observation

NUM_SUBACTIONS = 7

# Applied to the focused atom's latent row when set, None otherwise.
# tools/tpu_precision.py sets it while it emulates the TPU's default matmul
# precision: the JAX package selects the row by a one-hot einsum, which
# there rounds the row, and the gradient flowing back into it, to bf16; the
# gather below is exact.
focus_select_hook: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


class HeadDistributions(NamedTuple):
    """The distributions an action's sub-actions are drawn from, each given
    the sub-actions before it: what `evaluate` scores them under."""
    focus: torch.Tensor    # [B, N] probabilities over the canvas's slots
    element: torch.Tensor  # [B, Z] probabilities, given the focus
    means: torch.Tensor    # [B, 3] distance, angle, dihedral, given both
    stds: torch.Tensor     # [3] their standard deviations
    kappa: torch.Tensor    # [B, 2] probabilities, given the three


class AtomMLPEncoder(nn.Module):
    """Per-atom MLP over (one-hot(z), position): the cheap encoder of the
    `mlp` model, not rotation-invariant."""

    def __init__(self, num_zs: int, width: int, num_afeats: int):
        super().__init__()
        self.num_zs = num_zs
        self.mlp = MLP(num_zs + 3, (width, num_afeats))

    def forward(self, elements: torch.Tensor, positions: torch.Tensor,
                bag: torch.Tensor) -> torch.Tensor:
        one_hot = to_one_hot(elements, self.num_zs)
        return self.mlp(torch.cat([one_hot, positions], dim=-1))


class InternalAC(nn.Module):
    """Parameters mirror the Flax InternalAC's (convert.py,
    internal_params_from_jax). Built on `device` (cuda unless the caller
    names another)."""

    def __init__(self, num_zs: int, canvas_size: int, network_width: int,
                 min_max_distance: Tuple[float, float], encoder: nn.Module,
                 num_afeats: int, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.num_zs = num_zs
        self.canvas_size = canvas_size
        self.encoder = encoder
        width = network_width
        num_latent_beta = width // 4
        latent = num_afeats + num_latent_beta
        self.phi_beta = MLP(num_zs, (width, num_latent_beta))
        self.phi_focus = MLP(latent, (width, 1))
        self.phi_element = MLP(latent, (width, num_zs))
        self.phi_continuous = MLP(latent + num_zs, (width, 3))
        self.phi_kappa = MLP(latent, (width, 1))
        self.critic = MLP(latent, (width, width, 1))
        # learned global stds of (distance, angle, dihedral)
        self.log_stds = nn.Parameter(torch.log(torch.tensor([0.15, 0.25, 0.25])))
        lo, hi = min_max_distance
        self.register_buffer('half_ranges', torch.tensor(
            [hi - lo, math.pi, math.pi]) / 2, persistent=False)
        self.register_buffer('centers', torch.tensor(
            [(hi + lo) / 2, math.pi / 2, math.pi / 2]), persistent=False)
        self.to(device)

    @property
    def num_subactions(self) -> int:
        return NUM_SUBACTIONS

    def _surrogate_kappa_logits(self, obs, n_atoms, focus, element, cont,
                                latent_bag_next):
        """[B, 2]: phi_kappa of the new atom's features on the canvas
        extended by its placement at the dihedral's sign + and -."""
        slot = n_atoms.clamp(0, self.canvas_size - 1)[:, None]
        elements_ext = obs.elements.scatter(1, slot, element[:, None])
        distance, angle, dihedral = cont.unbind(-1)

        def logit(sign):
            pos = zmat.position_atom(obs.positions, n_atoms, focus, distance,
                                     angle, sign * dihedral)
            positions_ext = obs.positions.scatter(
                1, slot[..., None].expand(-1, 1, 3), pos[:, None])
            feats = self.encoder(elements_ext, positions_ext, obs.bag)
            feats = torch.gather(
                feats, 1, slot[..., None].expand(-1, 1, feats.shape[-1]))[:, 0]
            return self.phi_kappa(torch.cat([feats, latent_bag_next], dim=-1))

        return torch.cat([logit(1.0), logit(-1.0)], dim=-1)

    def _step(self, obs: Observation, actions: Optional[torch.Tensor],
              generator: Optional[Rng], deterministic: bool):
        batch = obs.elements.shape[0]
        device = obs.elements.device
        n_atoms = (obs.elements != 0).sum(dim=-1)
        idx = torch.arange(self.canvas_size, device=device)[None, :]
        occupied = idx < n_atoms[:, None]
        # the empty canvas focuses its slot 0
        focus_mask = occupied | (idx == 0)
        n = n_atoms[:, None]
        action_mask = torch.cat([n >= 1, torch.ones_like(n, dtype=torch.bool),
                                 n >= 1, n >= 2, n >= 3, n >= 3],
                                dim=-1).float()   # [B, 6]

        def given(col):
            return (None if actions is None
                    else torch.round(actions[:, col]).long())

        # the encoder's features, zero beyond the prefix of as many slots as
        # the canvas holds atoms
        atom_feats = self.encoder(obs.elements, obs.positions, obs.bag)
        atom_feats = atom_feats * occupied[..., None]   # [B, N, F]
        bag_f = obs.bag.float()
        latent_bag = self.phi_beta(bag_f)   # [B, Lb]
        latent = torch.cat([atom_feats, latent_bag[:, None, :].expand(
            batch, self.canvas_size, latent_bag.shape[-1])], dim=-1)

        focus_p, focus, focus_logp, focus_ent = categorical_head(
            self.phi_focus(latent)[..., 0], focus_mask, generator,
            index=given(1), deterministic=deterministic)
        focused = torch.gather(
            latent, 1, focus[:, None, None].expand(-1, 1, latent.shape[-1]))[:, 0]
        if focus_select_hook is not None:
            focused = focus_select_hook(focused)

        element_p, element, element_logp, element_ent = categorical_head(
            self.phi_element(focused), obs.bag > 0, generator,
            index=given(2), deterministic=deterministic)
        element_oh = to_one_hot(element, self.num_zs)

        means = torch.tanh(self.phi_continuous(
            torch.cat([focused, element_oh], dim=-1)))
        means = means * self.half_ranges + self.centers   # [B, 3]
        stds = torch.exp(1e-6 + self.log_stds)
        if actions is not None:
            cont = actions[:, 3:6]
        elif deterministic:
            cont = means
        else:
            cont = normal_sample(generator, means, stds.expand_as(means))
            # a sampled distance stays positive
            cont = torch.cat([cont[:, :1].clamp(min=0.001), cont[:, 1:]],
                             dim=-1)

        latent_bag_next = self.phi_beta(bag_f - element_oh)
        kappa_logits = self._surrogate_kappa_logits(
            obs, n_atoms, focus, element, cont, latent_bag_next)
        kappa_p, kappa, kappa_logp, _kappa_ent = categorical_head(
            kappa_logits, torch.ones_like(kappa_logits, dtype=torch.bool),
            generator, index=given(6), deterministic=deterministic)

        # log-probs of the sub-actions the canvas's size makes meaningful
        logp_parts = torch.cat([
            focus_logp[:, None], element_logp[:, None],
            normal_log_prob(cont, means, stds), kappa_logp[:, None]], dim=-1)
        logp = torch.sum(logp_parts * action_mask, dim=-1)
        ent = focus_ent * action_mask[:, 0] + element_ent * action_mask[:, 1]

        # critic: masked sum pooling and the bag's latent
        pooled = masked_sum(atom_feats, occupied)
        v = self.critic(torch.cat([pooled, latent_bag], dim=-1))[..., 0]

        if actions is None:
            actions = torch.cat([
                torch.zeros_like(cont[:, :1]), focus[:, None].float(),
                element[:, None].float(), cont, kappa[:, None].float()],
                dim=-1)

        sign = torch.where(kappa == 1, -1.0, 1.0)
        position = zmat.position_atom(obs.positions, n_atoms, focus,
                                      cont[:, 0], cont[:, 1],
                                      sign * cont[:, 2])
        return (AgentOutput(action_flat=actions, element=element,
                            position=position, logp=logp, ent=ent, v=v),
                HeadDistributions(focus_p, element_p, means, stds, kappa_p))

    def act(self, obs: Observation, generator: Rng,
            deterministic: bool = False) -> AgentOutput:
        return self._step(obs, None, generator, deterministic)[0]

    def evaluate(self, obs: Observation, action_flat: torch.Tensor):
        out = self._step(obs, action_flat, None, False)[0]
        return out.logp, out.ent, out.v

    def head_distributions(self, obs: Observation,
                           action_flat: torch.Tensor) -> HeadDistributions:
        """The distributions of each sub-action of `action_flat`, given the
        ones before it (HeadDistributions)."""
        return self._step(obs, action_flat, None, False)[1]


def make_mlp_internal_agent(num_zs: int, canvas_size: int,
                            network_width: int = 64,
                            min_max_distance: Tuple[float, float] = (0.8, 1.8),
                            device: DeviceLike = None) -> InternalAC:
    """The `mlp` model: the internal heads over an AtomMLPEncoder."""
    num_afeats = network_width // 2
    return InternalAC(
        num_zs=num_zs, canvas_size=canvas_size, network_width=network_width,
        min_max_distance=min_max_distance, num_afeats=num_afeats,
        encoder=AtomMLPEncoder(num_zs=num_zs, width=network_width,
                               num_afeats=num_afeats), device=device)
