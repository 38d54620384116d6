"""SO(3)-covariant actor-critic (counterpart of
molgym_tpu/agents/covariant.py).

Cormorant covariants per atom -> rotation-invariant scalars -> masked focus
head -> the focused atom's covariants -> masked element head -> per-element
channel slice -> GMM distance head -> distance-conditioned covariants via a
CG mixer -> spherical density over the placement direction -> critic from
masked-summed transformed invariants.

Flat sub-action layout: [focus, element, distance, nx, ny, nz]   (6,)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from molgym_tpu_torch.agents.base import AgentOutput
from molgym_tpu_torch.agents.cormorant import CormorantEncoder, CormorantMixer
from molgym_tpu_torch.agents.modules import MLP
from molgym_tpu_torch.device import DeviceLike, resolve_device
from molgym_tpu_torch.distributions import spherical
from molgym_tpu_torch.distributions.discrete import categorical_head
from molgym_tpu_torch.distributions.gmm import (gmm_argmax, gmm_log_prob,
                                                gmm_sample)
from molgym_tpu_torch.draws import Rng
from molgym_tpu_torch.ops.masked import to_one_hot
from molgym_tpu_torch.ops.so3 import (atomic_scalars, atomic_scalars_dim,
                                      select_atomic_covariats,
                                      select_atomic_invariats, select_taus)
from molgym_tpu_torch.spaces import Observation

NUM_SUBACTIONS = 6


class CovariantAC(nn.Module):
    """Parameters mirror the Flax CovariantAC; its LayerNorms use Flax's
    eps = 1e-6. Built on `device` (cuda unless the caller names another).
    `encoder_dtype='bfloat16'` runs the encoder's CG stack in bf16 (the
    parameters and the heads stay float32), as the Flax agent's does."""

    def __init__(self, zs: Tuple[int, ...], canvas_size: int,
                 network_width: int = 128, maxl: int = 4,
                 num_cg_levels: int = 3, num_channels_hidden: int = 10,
                 num_channels_per_element: int = 4, num_gaussians: int = 3,
                 bag_scale: int = 5,
                 min_max_distance: Tuple[float, float] = (0.9, 1.8),
                 beta: Optional[float] = None,
                 encoder_dtype: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.zs = tuple(zs)
        self.canvas_size = canvas_size
        self.maxl = maxl
        self.num_gaussians = num_gaussians
        self.num_channels_per_element = num_channels_per_element
        self.beta = beta
        num_zs = len(zs)
        num_channels_out = num_zs * num_channels_per_element
        self.encoder = CormorantEncoder(
            num_zs=num_zs, maxl=maxl, num_cg_levels=num_cg_levels,
            num_channels_hidden=num_channels_hidden,
            num_channels_out=num_channels_out,
            charge_scale=float(max(zs)), bag_scale=float(bag_scale),
            hard_cut=min(min_max_distance[1], 2.1),
            soft_cut=min(min_max_distance[1], 2.1),
            compute_dtype=encoder_dtype)
        self.cg_mix = CormorantMixer(maxl=maxl, tau=num_channels_per_element,
                                     tau_out=num_channels_per_element,
                                     n_other=1, n_atom=maxl + 1)
        inv_dim = atomic_scalars_dim(maxl, num_channels_out)
        elem_dim = atomic_scalars_dim(maxl, num_channels_per_element)
        width = network_width
        self.phi_focus = MLP(inv_dim, (width, 1))
        self.phi_element = MLP(inv_dim, (width, num_zs))
        self.phi_d = MLP(elem_dim, (width, 2 * num_gaussians))
        self.phi_trans = MLP(inv_dim, (width, width))
        self.phi_v = MLP(width, (width, 1))
        self.inv_norm = nn.LayerNorm(inv_dim, eps=1e-6)
        self.element_inv_norm = nn.LayerNorm(elem_dim, eps=1e-6)
        self.distance_log_stds = nn.Parameter(
            torch.log(0.1 * torch.ones(num_gaussians)))
        lo, hi = min_max_distance
        self.distance_half_width = (hi - lo) / 2.0
        self.distance_center = (hi + lo) / 2.0
        self.register_buffer('zs_array', torch.tensor(self.zs), persistent=False)
        self.to(device)

    @property
    def num_subactions(self) -> int:
        return NUM_SUBACTIONS

    def _step(self, obs: Observation, actions: Optional[torch.Tensor],
              generator: Optional[Rng], deterministic: bool,
              return_dists: bool = False):
        batch = obs.elements.shape[0]
        device = obs.elements.device
        n_atoms = (obs.elements != 0).sum(dim=-1)
        empty = n_atoms == 0
        idx = torch.arange(self.canvas_size, device=device)[None, :]
        atom_mask = idx < n_atoms[:, None]
        focus_mask = atom_mask | (idx == 0)

        covariats = self.encoder(obs.elements, obs.positions, obs.bag,
                                 self.zs_array)
        invariats = self.inv_norm(atomic_scalars(covariats))

        focus_probs, focus, focus_logp, focus_ent = categorical_head(
            self.phi_focus(invariats)[..., 0], focus_mask, generator,
            index=(None if actions is None
                   else torch.round(actions[:, 0]).long()),
            deterministic=deterministic)
        focus_oh = to_one_hot(focus, self.canvas_size)
        focused_cov = select_atomic_covariats(covariats, focus_oh)
        focused_inv = select_atomic_invariats(invariats, focus_oh)

        element_probs, element, element_logp, element_ent = categorical_head(
            self.phi_element(focused_inv), obs.bag > 0, generator,
            index=(None if actions is None
                   else torch.round(actions[:, 1]).long()),
            deterministic=deterministic)

        cpe = self.num_channels_per_element
        offsets = torch.arange(cpe, device=device)[None, :]
        element_cov = select_taus(focused_cov, offsets + element[:, None] * cpe)
        element_inv = self.element_inv_norm(atomic_scalars(element_cov))

        gmm_out = self.phi_d(element_inv)
        gmm_log_w = gmm_out[:, :self.num_gaussians]
        d_means = (torch.tanh(gmm_out[:, self.num_gaussians:]) *
                   self.distance_half_width + self.distance_center)
        d_stds = torch.exp(self.distance_log_stds).clamp(min=1e-6)
        if actions is not None:
            distance = actions[:, 2]
        elif deterministic:
            distance = gmm_argmax(generator, gmm_log_w, d_means, d_stds)
        else:
            distance = gmm_sample(generator, gmm_log_w, d_means,
                                  d_stds).clamp(min=0.001)

        d_rep0 = distance[:, None].expand(batch, cpe)
        d_rep0 = torch.stack([d_rep0, torch.zeros_like(d_rep0)],
                             dim=-1)[..., None, :]       # [B, cpe, 1, 2]
        cond_cov = self.cg_mix(element_cov, [d_rep0])

        so3_dist = spherical.make_so3_distribution(cond_cov, empty=empty,
                                                   beta=self.beta)
        if actions is not None:
            orientation = actions[:, 3:6]
        elif deterministic:
            orientation = spherical.argmax(so3_dist)
        else:
            orientation = spherical.sample(so3_dist, generator)

        logp = (focus_logp + element_logp +
                gmm_log_prob(gmm_log_w, d_means, d_stds, distance) +
                spherical.log_prob(so3_dist, orientation))
        ent = focus_ent + element_ent

        trans = self.phi_trans(invariats)
        value_feats = torch.einsum('bn,bnf->bf', atom_mask.to(trans.dtype), trans)
        v = self.phi_v(value_feats)[..., 0]

        if actions is None:
            actions = torch.cat([focus[:, None].float(), element[:, None].float(),
                                 distance[:, None], orientation], dim=-1)

        focus_pos = torch.einsum('bn,bnc->bc', focus_oh, obs.positions)
        position = torch.where(empty[:, None], torch.zeros_like(focus_pos),
                               focus_pos + distance[:, None] * orientation)

        out = AgentOutput(action_flat=actions, element=element,
                          position=position, logp=logp, ent=ent, v=v)
        if return_dists:
            return out, dict(focus_probs=focus_probs,
                             element_probs=element_probs,
                             gmm=(gmm_log_w, d_means, d_stds),
                             so3_dist=so3_dist)
        return out

    def act(self, obs: Observation, generator: Rng,
            deterministic: bool = False) -> AgentOutput:
        return self._step(obs, None, generator, deterministic)

    def evaluate(self, obs: Observation, action_flat: torch.Tensor):
        out = self._step(obs, action_flat, None, False)
        return out.logp, out.ent, out.v

    def act_with_dists(self, obs: Observation, generator: Rng,
                       deterministic: bool = False):
        return self._step(obs, None, generator, deterministic,
                          return_dists=True)
