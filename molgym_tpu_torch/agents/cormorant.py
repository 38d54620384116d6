"""SO(3)-covariant message-passing network, packed path (counterpart of
molgym_tpu/agents/cormorant.py).

Per level: radial filters gate the relative spherical harmonics into edge
reps, which are CG-aggregated over neighbours (ops/fused_agg.py kernel),
mixed per l, CG-squared (ops/fused_agg.py kernel) and concat-mixed with the
identity path. Complex values travel as separate real/imag tensors inside
the levels; the encoder returns per-l [B, N, tau, 2l+1, 2] covariants.

Parameter names mirror the Flax modules (`encoder.cg_level_0.ag_mix.
w_r_l0_s0`, `encoder.radial_0.rad_l0.weight`, ...) so that convert.py maps a
Flax tree by renaming.

`compute_dtype='bfloat16'` runs the encoder's CG stack in bf16, as the JAX
package's `compute_dtype` does: the parameters stay float32 and are cast per
call, the radial basis, its gate and the spherical harmonics are computed in
float32 first, the aggregate and square kernels take and return bf16, the
mixes' matrix products take bf16 and sum in f32, and the encoder's output is
cast back to float32 for the heads.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from molgym_tpu_torch.ops.cg import (_fused_cg_table, cg_product_packed_ri,
                                     fused_cg_table_grouped,
                                     fused_cg_table_tri, m_slices, pack_so3,
                                     pack_so3_ri, unpack_so3)
from molgym_tpu_torch.ops.fused_agg import (cg_aggregate_edge_fused_ri,
                                            cg_square_fused_ri)
from molgym_tpu_torch.ops.sph import spherical_harmonics_rel

SO3Vec = List[torch.Tensor]

CHARGE_POWER = 2     # input features: one-hot(z) x (z / charge_scale)^p
N_BASIS = 16         # Gaussian radial basis functions
SOFT_WIDTH = 0.2     # width of the soft radial cutoff


def _as_dtype(name: Optional[str]) -> torch.dtype:
    """A compute dtype name ('bfloat16', 'float32', None) as a torch dtype;
    None means float32."""
    return torch.float32 if name is None else getattr(torch, name)


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    """`layer` applied in `dtype`: input, weight and bias cast per call (the
    parameters stay float32), as a Flax Dense with `dtype` computes."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _embed_index(slices, maxl: int):
    """For each packed-K slot k of a source: its m slot q (in the M-form
    output) and its (l, pair) weight row c, l-major. `off` in `slices` is a
    block offset (contiguous layout) or a tuple of K positions over the
    flattened (pair, m) axis (permuted idx-form layout)."""
    ks, qs, cs = [], [], []
    moff = 0
    c = 0
    for l in range(maxl + 1):
        off, pairs = slices[l]
        width = 2 * l + 1
        for p in range(pairs):
            for m in range(width):
                ks.append(off[p * width + m] if isinstance(off, tuple)
                          else off + p * width + m)
                qs.append(moff + m)
                cs.append(c)
            c += 1
        moff += width
    return np.array(ks), np.array(qs), np.array(cs), c


class PackedCatMix(nn.Module):
    """Equivariant per-l channel mixing over a list of packed reps (the
    packed form of concat-along-tau + per-l complex linear). Source s is
    declared as (tau_s, slices_s) and arrives as (x_r, x_i) [..., tau_s, K_s].
    The weights are [pairs, tau_s, tau_out] per (l, source), as in the Flax
    module; per source they are scattered into one block-structured
    [K_s, tau_s, tau_out, 2M] weight and the whole packed rep is contracted
    in one product over (tau, K) (the JAX 'dense' implementation), in the
    sources' dtype: the weights are cast to it, as the JAX module casts them
    to the operands'.
    Output: M-form (out_r, out_i) [..., tau_out, M]."""

    def __init__(self, maxl: int, tau_out: int,
                 sources: Sequence[Tuple[int, tuple]]):
        super().__init__()
        self.maxl = maxl
        self.tau_out = tau_out
        self.m_total = (maxl + 1) ** 2
        self._sources = []
        for l in range(maxl + 1):
            total_c = sum(sl[l][1] * tau for tau, sl in sources)
            scale = 1.0 / np.sqrt(2.0 * max(total_c, 1))
            for s, (tau, sl) in enumerate(sources):
                pairs = sl[l][1]
                if pairs == 0:
                    continue
                for part in ('r', 'i'):
                    w = nn.Parameter(torch.randn(pairs, tau, tau_out) * scale)
                    self.register_parameter(f'w_{part}_l{l}_s{s}', w)
        for s, (tau, sl) in enumerate(sources):
            ks, qs, cs, c_total = _embed_index(sl, maxl)
            self.register_buffer(f'_k_s{s}', torch.from_numpy(ks),
                                 persistent=False)
            self.register_buffer(f'_q_s{s}', torch.from_numpy(qs),
                                 persistent=False)
            self.register_buffer(f'_c_s{s}', torch.from_numpy(cs),
                                 persistent=False)
            self._sources.append((tau, c_total))

    def _weight_cat(self, s: int, part: str) -> torch.Tensor:
        ws = [getattr(self, f'w_{part}_l{l}_s{s}') for l in range(self.maxl + 1)
              if hasattr(self, f'w_{part}_l{l}_s{s}')]
        return torch.cat(ws, dim=0)                      # [C, tau, s]

    def forward(self, reps: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        if len(reps) != len(self._sources):
            raise ValueError(f'expected {len(self._sources)} sources, got '
                             f'{len(reps)}')
        m_total = self.m_total
        acc_r = acc_i = None
        for s, (xr, xi) in enumerate(reps):
            tau, _c_total = self._sources[s]
            k_total = xr.shape[-1]
            ks, qs, cs = (getattr(self, f'_k_s{s}'), getattr(self, f'_q_s{s}'),
                          getattr(self, f'_c_s{s}'))
            bw = xr.new_zeros((k_total, 2 * m_total, tau, self.tau_out))
            bw[ks, qs] = self._weight_cat(s, 'r')[cs].to(xr.dtype)
            bw[ks, m_total + qs] = self._weight_cat(s, 'i')[cs].to(xr.dtype)
            # [..., tau, K] x [K, 2M, tau, s] over (tau, K) -> [..., 2M, s]
            y_r = torch.einsum('...tk,kqts->...sq', xr, bw)
            y_i = torch.einsum('...tk,kqts->...sq', xi, bw)
            o_r = y_r[..., :m_total] - y_i[..., m_total:]
            o_i = y_r[..., m_total:] + y_i[..., :m_total]
            acc_r = o_r if acc_r is None else acc_r + o_r
            acc_i = o_i if acc_i is None else acc_i + o_i
        return acc_r, acc_i


class RadialFiltersStacked(nn.Module):
    """Gaussian RBF basis -> per-l Linear(tau), gated by a soft cutoff; the
    per-l outputs stacked on a trailing axis [B, N, N, tau, maxl+1]. Basis
    and gate in float32 (distances need the precision), the Linear layers
    and the output in `compute_dtype`."""

    def __init__(self, maxl: int, tau: int, hard_cut: float = 2.1,
                 soft_cut: float = 2.1, compute_dtype: Optional[str] = None):
        super().__init__()
        self.maxl = maxl
        self.hard_cut = hard_cut
        self.soft_cut = soft_cut
        self.dtype = _as_dtype(compute_dtype)
        for l in range(maxl + 1):
            self.add_module(f'rad_l{l}', nn.Linear(N_BASIS, tau))

    def forward(self, norms: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
        centers = torch.linspace(0.0, self.hard_cut, N_BASIS,
                                 device=norms.device, dtype=norms.dtype)
        width = centers[1] - centers[0]
        gamma = 0.5 / (width * width)
        rbf = torch.exp(-gamma * torch.square(norms[..., None] - centers))
        soft = torch.sigmoid((self.soft_cut - norms) / SOFT_WIDTH)
        gate = (edge_mask.to(norms.dtype) * soft *
                (norms < self.hard_cut).to(norms.dtype))
        feats = [_linear(getattr(self, f'rad_l{l}'), rbf, self.dtype)
                 for l in range(self.maxl + 1)]
        return torch.stack(feats, dim=-1) * gate[..., None, None].to(self.dtype)


class CGLevelPacked(nn.Module):
    """One covariant message-passing level on packed reps: edge reps
    CG-aggregated over neighbours (fused kernel), mixed, CG-squared (tri-fold
    kernel), then concat-mixed with the identity path. The kernels' permuted
    K layouts are absorbed by the mixers' idx-form slices."""

    def __init__(self, maxl: int, tau_in: int, tau_out: int, atom_n_ells: int):
        super().__init__()
        n_ells = maxl + 1
        self.table3, ag_slices = _fused_cg_table(n_ells, atom_n_ells, maxl)
        grouped = fused_cg_table_grouped(n_ells, atom_n_ells, maxl)
        self.grouped = None
        if grouped is not None:
            gtabs, perm, ag_slices = grouped
            self.grouped = (gtabs, perm)
        self.sq_table3, _sl = _fused_cg_table(n_ells, n_ells, maxl)
        pairs, groups, _perm, sq_slices = fused_cg_table_tri(n_ells, maxl)
        self.tri = (pairs, groups)
        self.ag_mix = PackedCatMix(maxl, tau_out, [(tau_in, ag_slices)])
        self.cat_mix = PackedCatMix(
            maxl, tau_out, [(tau_out, m_slices(n_ells, maxl)),
                            (tau_out, sq_slices),
                            (tau_in, m_slices(atom_n_ells, maxl))])

    def forward(self, atom_r, atom_i, sph_packed, rad_feats, atom_mask):
        # atom_r/atom_i [B, N, tau, M_atom]; sph_packed [B, N, N, M, 2];
        # rad_feats [B, N, N, tau, maxl+1]. Returns [B, N, tau_out, M] x 2.
        ag_kr, ag_ki = cg_aggregate_edge_fused_ri(
            sph_packed, rad_feats, atom_r, atom_i, self.table3,
            grouped=self.grouped)
        ag_r, ag_i = self.ag_mix([(ag_kr, ag_ki)])
        sq_r, sq_i = cg_square_fused_ri(ag_r, ag_i, self.sq_table3,
                                        tri=self.tri)
        out_r, out_i = self.cat_mix([(ag_r, ag_i), (sq_r, sq_i),
                                     (atom_r, atom_i)])
        mask = atom_mask[..., None, None].to(out_r.dtype)
        return out_r * mask, out_i * mask


class CormorantEncoder(nn.Module):
    """Canvas -> per-atom SO3Vec covariants, entry l [B, N, tau_out, 2l+1, 2]
    (float32), the CG stack computed in `compute_dtype`."""

    def __init__(self, num_zs: int, maxl: int = 4, num_cg_levels: int = 3,
                 num_channels_hidden: int = 10, num_channels_out: int = 8,
                 charge_scale: float = 9.0, bag_scale: float = 5.0,
                 hard_cut: float = 2.1, soft_cut: float = 2.1,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.dtype = _as_dtype(compute_dtype)
        if self.dtype == torch.bfloat16:
            # bf16 matrix products reduce in f32, as the JAX package's bf16
            # dots accumulate in f32. PyTorch's default lets cuBLAS add
            # split-K partial sums in bf16, which put a gradient of the SF6
            # agent on the card 0.035 of its leaf's max |g| from the CPU's,
            # against 0.0039 without (chip_smoke.py's comparison). The
            # setting is the process's; it only makes bf16 GEMMs more
            # precise.
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.num_zs = num_zs
        self.maxl = maxl
        self.charge_scale = charge_scale
        self.bag_scale = bag_scale
        self.num_cg_levels = num_cg_levels
        in_dim = num_zs * (CHARGE_POWER + 1) + num_zs
        self.input_linear = nn.Linear(in_dim, num_channels_hidden)
        channels = [num_channels_hidden] * (num_cg_levels - 1) + [num_channels_out]
        tau_in, atom_n_ells = num_channels_hidden, 1
        for level, tau_out in enumerate(channels):
            self.add_module(f'radial_{level}', RadialFiltersStacked(
                maxl=maxl, tau=tau_in, hard_cut=hard_cut, soft_cut=soft_cut,
                compute_dtype=compute_dtype))
            self.add_module(f'cg_level_{level}', CGLevelPacked(
                maxl=maxl, tau_in=tau_in, tau_out=tau_out,
                atom_n_ells=atom_n_ells))
            tau_in, atom_n_ells = tau_out, maxl + 1

    def forward(self, elements: torch.Tensor, positions: torch.Tensor,
                bag: torch.Tensor, zs_values: torch.Tensor) -> SO3Vec:
        B, N = elements.shape
        atom_mask = elements != 0
        eye = torch.eye(N, dtype=torch.bool, device=elements.device)
        edge_mask = atom_mask[:, :, None] & atom_mask[:, None, :] & ~eye[None]

        charges = zs_values[elements].to(torch.float32)
        one_hot = (elements[..., None] == torch.arange(
            self.num_zs, device=elements.device)).to(torch.float32)
        powers = torch.stack([(charges / self.charge_scale) ** p
                              for p in range(CHARGE_POWER + 1)], dim=-1)
        charge_feats = (one_hot[..., None] * powers[..., None, :]).reshape(B, N, -1)
        bag_tiled = (bag.to(torch.float32) / self.bag_scale)[:, None, :].expand(
            B, N, bag.shape[-1])
        scalars = torch.cat([charge_feats, bag_tiled], dim=-1)

        x0 = _linear(self.input_linear, scalars, self.dtype)
        atom_r = (x0 * atom_mask[..., None].to(x0.dtype))[..., None].contiguous()
        atom_i = torch.zeros_like(atom_r)

        # in float32, packed once for all levels, then cast
        sph, norms = spherical_harmonics_rel(self.maxl, positions, positions,
                                             conj=True)
        sph_packed = pack_so3(sph).to(self.dtype)
        for level in range(self.num_cg_levels):
            rad = getattr(self, f'radial_{level}')(norms, edge_mask)
            atom_r, atom_i = getattr(self, f'cg_level_{level}')(
                atom_r, atom_i, sph_packed, rad, atom_mask)
        return unpack_so3(torch.stack([atom_r, atom_i], dim=-1).float(),
                          self.maxl + 1)


class CormorantMixer(nn.Module):
    """Condition covariants on another rep: ag = other (x) in; sq = ag (x) ag;
    out = CatMix([ag, sq, in]) on small [B, tau] reps. Both products are the
    channel-wise CG product of ops/fused_cg.py (a kernel on the card), given
    real and imaginary parts packed separately, each contiguous."""

    def __init__(self, maxl: int, tau: int, tau_out: int, n_other: int,
                 n_atom: int):
        super().__init__()
        self.maxl = maxl
        self.n_other = n_other
        self.n_atom = n_atom
        n_ells = maxl + 1
        _t, ag_slices = _fused_cg_table(n_other, n_atom, maxl)
        _t, sq_slices = _fused_cg_table(n_ells, n_ells, maxl)
        self.ag_mix = PackedCatMix(maxl, tau_out, [(tau, ag_slices)])
        self.cat_mix = PackedCatMix(
            maxl, tau_out, [(tau_out, m_slices(n_ells, maxl)),
                            (tau_out, sq_slices),
                            (tau, m_slices(n_atom, maxl))])

    def forward(self, atom_rep: SO3Vec, other_rep: SO3Vec) -> SO3Vec:
        other_r, other_i = pack_so3_ri(other_rep)
        atom_r, atom_i = pack_so3_ri(atom_rep)
        n_ells = self.maxl + 1
        (ag_kr, ag_ki), _sl = cg_product_packed_ri(
            other_r, other_i, atom_r, atom_i, self.n_other, self.n_atom,
            self.maxl)
        ag_r, ag_i = self.ag_mix([(ag_kr, ag_ki)])
        (sq_r, sq_i), _sl = cg_product_packed_ri(ag_r, ag_i, ag_r, ag_i,
                                                 n_ells, n_ells, self.maxl)
        out_r, out_i = self.cat_mix([(ag_r, ag_i), (sq_r, sq_i),
                                     (atom_r, atom_i)])
        return unpack_so3(torch.stack([out_r, out_i], dim=-1), n_ells)
