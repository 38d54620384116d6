"""Rotation checks of the covariant agent (the port's counterpart of
tests/covariant/test_covariant_agent.py's): rotating a canvas must rotate
the coefficients of the agent's placement density on the sphere by the
rotation's Wigner-D matrices, and leave their invariants as they were.
The focus, element and distance heads see invariants only, so one
generator seed gives the same discrete choices and distance for a canvas
and its rotation.

`covariance_errors` runs on whatever device the agent is on; the tests
call it on the CPU and on the card, and chip_smoke.py on the card.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from molgym_tpu_torch.atoms import Atoms
from molgym_tpu_torch.formula import FormulaType
from molgym_tpu_torch.ops.so3 import apply_wigner, atomic_scalars, gen_rot
from molgym_tpu_torch.spaces import ObservationSpace

# the JAX test's molecules (Angstrom)
H2O = Atoms(['O', 'H', 'H'],
            [[0.0, 0.0, 0.1191], [0.0, 0.7557, -0.4764],
             [0.0, -0.7557, -0.4764]])
CH3 = Atoms(['C', 'H', 'H', 'H'],
            [[0.0, 0.0, 0.0], [0.0, 1.07, 0.0],
             [0.9266, -0.535, 0.0], [-0.9266, -0.535, 0.0]])
CH4 = Atoms(['C', 'H', 'H', 'H', 'H'],
            [[0.0, 0.0, 0.0], [0.6291, 0.6291, 0.6291],
             [-0.6291, -0.6291, 0.6291], [0.6291, -0.6291, -0.6291],
             [-0.6291, 0.6291, -0.6291]])
MOLECULES = (H2O, CH3, CH4)

# partial SF6 canvases (S-F 1.56 Angstrom, octahedral directions) for the
# SF6 agent, which knows only X, F and S
_OCTAHEDRON = 1.56 * np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                               [0, -1, 0], [0, 0, 1], [0, 0, -1]], float)
SF6_MOLECULES = tuple(
    Atoms(['S'] + ['F'] * len(rows), np.concatenate([np.zeros((1, 3)),
                                                     _OCTAHEDRON[rows]]))
    for rows in ([0, 2], [0, 1, 2, 4], [0, 1, 2, 3, 4]))

# the agents the checks run: the JAX test's (tests/covariant/
# test_covariant_agent.py:35-40) with an H and a C in its bag, and the SF6
# agent at the canonical run's full width with an F in its bag
COVARIANCE_AGENT = dict(zs=(0, 1, 6, 8), canvas_size=5, network_width=32,
                        maxl=3, num_cg_levels=2, num_channels_hidden=6,
                        num_channels_per_element=3, num_gaussians=3,
                        bag_scale=1, min_max_distance=(0.9, 1.8), beta=100.0)
COVARIANCE_FORMULA = ((1, 1), )
SF6_AGENT = dict(zs=(0, 9, 16), canvas_size=7, network_width=128, maxl=4,
                 num_cg_levels=3, num_channels_hidden=10,
                 num_channels_per_element=4, num_gaussians=3, bag_scale=5,
                 min_max_distance=(1.10, 2.10), beta=-10.0)
SF6_FORMULA = ((9, 1), )


def so3_coefficients(agent, space: ObservationSpace, atoms: Atoms,
                     formula: FormulaType, seed: int = 1
                     ) -> Tuple[torch.Tensor, ...]:
    """The coefficients [1, tau, 2l+1, 2] of the agent's placement density
    for `atoms` on the canvas and `formula` in the bag, its discrete
    choices and distance sampled from a generator seeded with `seed`."""
    device = next(agent.parameters()).device
    obs = space.build(atoms, formula).map(lambda x: x[None].to(device))
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        _out, dists = agent.act_with_dists(obs, gen, False)
    return dists['so3_dist'].coefficients


def rotated(atoms: Atoms, rotation: np.ndarray) -> Atoms:
    out = atoms.copy()
    out.positions = atoms.positions @ rotation.T
    return out


def covariance_errors(agent, space: ObservationSpace,
                      molecules: Sequence[Atoms], formula: FormulaType,
                      seed: int = 0) -> List[dict]:
    """For each molecule and a random rotation R drawn from
    np.random.RandomState(seed): max |coefficients(R x) - D(R)
    coefficients(x)| over every l, and max |scalars(R x) - scalars(x)| of
    their AtomicScalars invariants."""
    rng = np.random.RandomState(seed)
    out = []
    for atoms in molecules:
        coeffs = so3_coefficients(agent, space, atoms, formula)
        wigner, rotation, _angles = gen_rot(len(coeffs) - 1, rng)
        coeffs_rot = so3_coefficients(agent, space, rotated(atoms, rotation),
                                      formula)
        expected = apply_wigner(coeffs, wigner)
        out.append(dict(
            molecule=atoms.get_chemical_formula(),
            covariance=max(float((g - w).abs().max())
                           for g, w in zip(coeffs_rot, expected)),
            invariance=float((atomic_scalars(list(coeffs_rot)) -
                              atomic_scalars(list(coeffs))).abs().max())))
    return out
