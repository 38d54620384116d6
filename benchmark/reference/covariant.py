"""Plain reference of the SO(3)-covariant MolGym agent (Simm et al., ICLR
2021): the Cormorant encoder, the focus, element, distance and orientation
heads and the critic, as functions of a dict of parameters named as the
program names them.

Every contraction is a dense einsum over complex tensors against the CG
tables of so3.py; the channel mixes contract each l's pairs with their
complex weights directly. Nothing of the program is imported, and every
parameter comes from the caller (the benchmark makes the weights).

`evaluate(params, cfg, obs, actions)` gives (logp, entropy, value) of the
flat actions [focus, element, distance, nx, ny, nz] at the observations.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch.nn import functional as F

from reference import so3

N_BASIS = 16
SOFT_WIDTH = 0.2
CHARGE_POWER = 2
EPS = 1e-10
LN_EPS = 1e-6

Params = Dict[str, torch.Tensor]


def settings(config: dict) -> dict:
    """The agent's sizes from a run's recorded flags."""
    from reference.env import symbols_to_zs
    zs = symbols_to_zs(config['symbols'])
    lo, hi = float(config['min_mean_distance']), float(config['max_mean_distance'])
    return dict(zs=zs, canvas=int(config['canvas_size']), maxl=int(config['maxl']),
                levels=int(config['num_cg_levels']),
                hidden=int(config['num_channels_hidden']),
                cpe=int(config['num_channels_per_element']),
                gaussians=int(config['num_gaussians']),
                bag_scale=float(config['bag_scale']), dist_range=(lo, hi),
                cut=min(hi, 2.1), beta=float(config['beta']))


def _linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[name + '.weight'].T + p[name + '.bias']


def _mlp(p: Params, name: str, x: torch.Tensor, layers: int = 2) -> torch.Tensor:
    for i in range(layers):
        x = _linear(p, f'{name}.layers.{i}', x)
        if i < layers - 1:
            x = torch.relu(x)
    return x


def _layer_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1], ), p[name + '.weight'],
                        p[name + '.bias'], LN_EPS)


def _table(n1: int, n2: int, maxl: int, device) -> torch.Tensor:
    table, _sl = so3.product_table(n1, n2, maxl)
    return torch.from_numpy(table).to(device).to(torch.complex64)


def _mix(p: Params, name: str, maxl: int, sources) -> torch.Tensor:
    """Per-l complex channel mixing: out_l[s, m] = sum over the sources and
    their (pair, tau) of x[tau, pair, m] w[pair, tau, s]; `sources` are
    (x [..., tau, K] complex, slices). Output m form [..., tau_out, M]."""
    out = []
    for l in range(maxl + 1):
        acc = None
        for s, (x, slices) in enumerate(sources):
            off, pairs = slices[l]
            if pairs == 0:
                continue
            w = torch.complex(p[f'{name}.w_r_l{l}_s{s}'],
                              p[f'{name}.w_i_l{l}_s{s}'])
            part = x[..., off:off + pairs * (2 * l + 1)]
            part = part.reshape(part.shape[:-1] + (pairs, 2 * l + 1))
            y = torch.einsum('...tpm,pts->...sm', part, w)
            acc = y if acc is None else acc + y
        out.append(acc)
    return torch.cat(out, dim=-1)


def encoder(p: Params, s: dict, elements, positions, bag) -> torch.Tensor:
    """Per-atom covariants [B, N, tau_out, M], complex."""
    maxl, device = s['maxl'], positions.device
    n_ells, num_zs = maxl + 1, len(s['zs'])
    B, N = elements.shape
    mask = elements != 0
    edge = mask[:, :, None] & mask[:, None, :] & ~torch.eye(
        N, dtype=torch.bool, device=device)
    zs = torch.tensor(s['zs'], device=device)
    charge = zs[elements].float() / max(s['zs'])
    one_hot = F.one_hot(elements, num_zs).float()
    powers = torch.stack([charge ** k for k in range(CHARGE_POWER + 1)], -1)
    feats = torch.cat([(one_hot[..., None] * powers[..., None, :]).reshape(B, N, -1),
                       (bag.float() / s['bag_scale'])[:, None].expand(B, N, num_zs)],
                      -1)
    x0 = _linear(p, 'encoder.input_linear', feats) * mask[..., None]
    atom = torch.complex(x0, torch.zeros_like(x0))[..., None]     # [B,N,t,1]

    rel = positions[:, :, None] - positions[:, None]
    dist = torch.sqrt(torch.clamp((rel * rel).sum(-1), min=1e-24))
    sph = so3.spherical_harmonics(maxl, rel, conj=True)           # [B,N,N,M]
    centers = torch.linspace(0.0, s['cut'], N_BASIS, device=device)
    gamma = 0.5 / (centers[1] - centers[0]) ** 2
    rbf = torch.exp(-gamma * (dist[..., None] - centers) ** 2)
    gate = edge * torch.sigmoid((s['cut'] - dist) / SOFT_WIDTH) * (dist < s['cut'])
    l_of_m = torch.tensor([l for l in range(n_ells) for _ in range(2 * l + 1)],
                          device=device)
    atom_ells = 1
    for level in range(s['levels']):
        rad = torch.stack([_linear(p, f'encoder.radial_{level}.rad_l{l}', rbf)
                           for l in range(n_ells)], -1) * gate[..., None, None]
        edge_rep = rad[..., l_of_m] * sph[:, :, :, None, :]       # [B,N,N,t,M]
        z = torch.einsum('bijtm,bjtn->bitmn', edge_rep, atom)
        ag = torch.einsum('bitmn,mnk->bitk', z, _table(n_ells, atom_ells, maxl,
                                                       device))
        name = f'encoder.cg_level_{level}'
        ag = _mix(p, f'{name}.ag_mix', maxl,
                  [(ag, so3.product_table(n_ells, atom_ells, maxl)[1])])
        sq = torch.einsum('...m,...n,mnk->...k', ag, ag,
                          _table(n_ells, n_ells, maxl, device))
        atom = _mix(p, f'{name}.cat_mix', maxl,
                    [(ag, so3.m_slices(n_ells, maxl)),
                     (sq, so3.product_table(n_ells, n_ells, maxl)[1]),
                     (atom, so3.m_slices(atom_ells, maxl))])
        atom = atom * mask[..., None, None]
        atom_ells = n_ells
    return atom


def mixer(p: Params, s: dict, rep: torch.Tensor, distance: torch.Tensor):
    """The element's covariants [B, cpe, M] conditioned on the distance:
    ag = d (x) rep, sq = ag (x) ag, out = mix(ag, sq, rep)."""
    maxl, device = s['maxl'], rep.device
    n_ells = maxl + 1
    d = torch.complex(distance, torch.zeros_like(distance))[:, None, None]
    d = d.expand(-1, rep.shape[1], 1)
    ag = torch.einsum('...m,...n,mnk->...k', d, rep,
                      _table(1, n_ells, maxl, device))
    ag = _mix(p, 'cg_mix.ag_mix', maxl,
              [(ag, so3.product_table(1, n_ells, maxl)[1])])
    sq = torch.einsum('...m,...n,mnk->...k', ag, ag,
                      _table(n_ells, n_ells, maxl, device))
    return _mix(p, 'cg_mix.cat_mix', maxl,
                [(ag, so3.m_slices(n_ells, maxl)),
                 (sq, so3.product_table(n_ells, n_ells, maxl)[1]),
                 (rep, so3.m_slices(n_ells, maxl))])


def _categorical(logits, mask, index):
    """(log-prob of index, entropy) of the masked softmax over the last axis."""
    logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    probs = torch.softmax(logits, -1) * mask
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-20)
    logp = torch.log(torch.gather(probs, -1, index[:, None])[:, 0].clamp(min=EPS))
    ent = -torch.where(probs > 0, probs * torch.log(probs.clamp(min=EPS)),
                       torch.zeros_like(probs)).sum(-1)
    return logp, ent


def _so3_log_prob(coeffs: torch.Tensor, s: dict, points: torch.Tensor,
                  empty: torch.Tensor) -> torch.Tensor:
    """log p(points) of the density exp(-beta |sum a_lm Y_lm|^2) / Z with
    the coefficients normalized; uniform where the canvas is empty."""
    maxl, beta = s['maxl'], s['beta']
    a = coeffs.sum(-2)                                 # the taus summed: [B, M]
    a = a / torch.sqrt(torch.clamp((a.real ** 2 + a.imag ** 2).sum(-1),
                                   min=1e-10))[:, None]
    qp, qw = so3.sphere_quadrature(max(24, 6 * maxl))
    qp = torch.from_numpy(qp).to(a.device)
    qw = torch.from_numpy(qw).to(a.device)

    def density(y):                                    # y [..., B, M]
        v = (a * y).sum(-1)
        return v.real ** 2 + v.imag ** 2
    log_z = torch.logsumexp(-beta * density(
        so3.spherical_harmonics(maxl, qp)[:, None]) + qw[:, None], dim=0)
    lp = -beta * density(so3.spherical_harmonics(maxl, points)) - log_z
    return torch.where(empty, torch.full_like(lp, -math.log(4 * math.pi)), lp)


def evaluate(p: Params, s: dict, elements, positions, bag, actions):
    """(logp, entropy, value) [B] of the flat actions at the observations."""
    B, N = elements.shape
    device = positions.device
    cpe, maxl, G = s['cpe'], s['maxl'], s['gaussians']
    n_atoms = (elements != 0).sum(-1)
    idx = torch.arange(N, device=device)[None]
    atom_mask = idx < n_atoms[:, None]
    cov = encoder(p, s, elements, positions, bag)          # [B, N, T, M]
    inv = _layer_norm(p, 'inv_norm', so3.invariants(so3.split_l(cov, maxl)))

    focus = torch.round(actions[:, 0]).long()
    element = torch.round(actions[:, 1]).long()
    f_logp, f_ent = _categorical(_mlp(p, 'phi_focus', inv)[..., 0],
                                 atom_mask | (idx == 0), focus)
    rows = torch.arange(B, device=device)
    focused_cov, focused_inv = cov[rows, focus], inv[rows, focus]
    e_logp, e_ent = _categorical(_mlp(p, 'phi_element', focused_inv), bag > 0,
                                 element)
    taus = element[:, None] * cpe + torch.arange(cpe, device=device)[None]
    element_cov = torch.gather(focused_cov, 1, taus[..., None].expand(
        -1, -1, focused_cov.shape[-1]))                    # [B, cpe, M]
    element_inv = _layer_norm(p, 'element_inv_norm',
                              so3.invariants(so3.split_l(element_cov, maxl)))
    out = _mlp(p, 'phi_d', element_inv)
    lo, hi = s['dist_range']
    means = torch.tanh(out[:, G:]) * (hi - lo) / 2 + (hi + lo) / 2
    var = torch.exp(p['distance_log_stds']).clamp(min=1e-6) ** 2
    distance = actions[:, 2]
    comp = -0.5 * ((distance[:, None] - means) ** 2 / var
                   + torch.log(2 * math.pi * var))
    d_logp = torch.logsumexp(torch.log_softmax(out[:, :G], -1) + comp, -1)
    cond = mixer(p, s, element_cov, distance)
    o_logp = _so3_log_prob(cond, s, actions[:, 3:6], n_atoms == 0)

    trans = _mlp(p, 'phi_trans', inv)
    value = _mlp(p, 'phi_v', (trans * atom_mask[..., None]).sum(1))[:, 0]
    return f_logp + e_logp + d_logp + o_logp, f_ent + e_ent, value


def evaluate_blocks(p: Params, s: dict, obs, actions, rows: int):
    """evaluate without autograd over blocks of `rows` rows."""
    out = []
    with torch.no_grad():
        for i in range(0, actions.shape[0], rows):
            sl = slice(i, i + rows)
            out.append(evaluate(p, s, obs['elements'][sl], obs['positions'][sl],
                                obs['bag'][sl], actions[sl]))
    return [torch.cat(x) for x in zip(*out)]

