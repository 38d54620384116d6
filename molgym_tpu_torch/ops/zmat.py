"""Internal-coordinate (z-matrix) geometry on tensors (counterpart of
molgym_tpu/ops/zmat.py): the distance, angle and dihedral helpers, the
placement of a point from a distance, an angle and a dihedral, and the
placement of a new atom on a padded canvas, batched over B.

Conventions follow the JAX package's: its dihedral sign convention, the
auxiliary axes for canvases of fewer than three atoms, the 1e-10 clamps on
every norm, and the reference atoms taken in the order of a STABLE sort of
the distances to the focus (jnp.argsort is stable; equidistant atoms, as in
a symmetric canvas, and the padded slots tie).
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-10


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp(min=_EPS)


def get_distance(p_i: torch.Tensor, p_j: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(p_i - p_j), dim=-1))


def get_angle(p_i: torch.Tensor, p_j: torch.Tensor,
              p_k: torch.Tensor) -> torch.Tensor:
    """Angle at vertex j between points i, j, k, in radians."""
    rij = p_i - p_j
    rkj = p_k - p_j
    sin_theta = torch.linalg.norm(torch.linalg.cross(rij, rkj, dim=-1), dim=-1)
    cos_theta = torch.sum(rij * rkj, dim=-1)
    return torch.atan2(sin_theta, cos_theta)


def get_dihedral(p_i: torch.Tensor, p_j: torch.Tensor, p_k: torch.Tensor,
                 p_l: torch.Tensor) -> torch.Tensor:
    """Dihedral between the (i,j,k) and (j,k,l) planes, with the JAX
    package's sign convention."""
    r_ji = p_j - p_i
    r_kj = p_k - p_j
    r_lk = p_l - p_k
    v1 = _unit(torch.linalg.cross(r_ji, r_kj, dim=-1))
    v2 = _unit(torch.linalg.cross(r_lk, r_kj, dim=-1))
    m1 = torch.linalg.cross(v1, r_kj, dim=-1) / torch.linalg.norm(
        r_kj, dim=-1, keepdim=True).clamp(min=_EPS)
    x = torch.sum(v1 * v2, dim=-1)
    y = torch.sum(m1 * v2, dim=-1)
    psi = torch.atan2(y, x)
    return torch.where(psi < 0, -psi - math.pi, math.pi - psi)


def position_point(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                   distance: torch.Tensor, angle: torch.Tensor,
                   dihedral: torch.Tensor) -> torch.Tensor:
    """Place a point at `distance` from p2, `angle` w.r.t. p1, `dihedral`
    w.r.t. p0. Points [..., 3], the coordinates [...]."""
    distance = distance[..., None]
    angle = angle[..., None]
    dihedral = dihedral[..., None]

    x = distance * torch.cos(angle)
    y = distance * torch.cos(dihedral) * torch.sin(angle)
    z = distance * torch.sin(dihedral) * torch.sin(angle)

    v_a = p1 - p0
    v_b = _unit(p2 - p1)
    c_ab = _unit(torch.linalg.cross(v_a, v_b, dim=-1))
    c_ab_b = torch.linalg.cross(c_ab, v_b, dim=-1)
    return p2 - v_b * x + c_ab_b * y + c_ab * z


def position_atom(positions: torch.Tensor, n_atoms: torch.Tensor,
                  focus: torch.Tensor, distance: torch.Tensor,
                  angle: torch.Tensor, dihedral: torch.Tensor) -> torch.Tensor:
    """The new atom's position on each of B padded canvases.

    positions [B, N, 3]; n_atoms [B] (the valid prefix); focus [B] (an
    index, clipped into the canvas); distance, angle, dihedral [B]. Returns
    [B, 3]: the origin on an empty canvas; else placed from the focus's
    nearest atom (p2), the next nearest (p1) and the one after (p0), with
    auxiliary axes standing in for the atoms a canvas of one or two lacks.
    """
    n = positions.shape[1]
    valid = torch.arange(n, device=positions.device)[None, :] < n_atoms[:, None]
    focus = focus.long().clamp(0, n - 1)
    focus_pos = torch.gather(positions, 1,
                             focus[:, None, None].expand(-1, 1, 3))
    dists = get_distance(positions, focus_pos)
    dists = torch.where(valid, dists, torch.full_like(dists, math.inf))
    order = torch.argsort(dists, dim=-1, stable=True)
    sorted_pos = torch.gather(positions, 1, order[..., None].expand(-1, -1, 3))

    # the auxiliary axes x and y, made on the device (no host copy)
    axes = torch.eye(3, dtype=positions.dtype, device=positions.device)
    aux_1, aux_0 = axes[0], axes[1]
    s0, s1, s2 = sorted_pos[:, 0], sorted_pos[:, 1 % n], sorted_pos[:, 2 % n]

    two = (n_atoms == 2)[:, None]
    many = (n_atoms >= 3)[:, None]
    # n_atoms == 1: p1, p0 from the auxiliary axes; == 2: p0 from both atoms
    p2 = s0
    p1 = torch.where(many | two, s1, s0 + aux_1)
    p0 = torch.where(many, s2, torch.where(two, s0 + s1 + aux_0 + aux_1,
                                           s0 + aux_0))

    placed = position_point(p0, p1, p2, distance, angle, dihedral)
    return torch.where((n_atoms == 0)[:, None], torch.zeros_like(placed),
                       placed)
