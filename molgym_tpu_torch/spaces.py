"""Typed observation/action structures with static shapes (counterpart of
molgym_tpu/spaces.py).

  Observation:
    elements  int64[..., canvas_size]     index into `zs` (0 == null element X)
    positions float32[..., canvas_size, 3] Angstrom
    bag       int64[..., num_zs]          atom counts per element index
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from molgym_tpu_torch.atoms import Atom, Atoms
from molgym_tpu_torch.formula import FormulaType
from molgym_tpu_torch.periodic import ATOMIC_NUMBERS


@dataclasses.dataclass
class Observation:
    elements: torch.Tensor
    positions: torch.Tensor
    bag: torch.Tensor

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> 'Observation':
        """Apply `fn` to every field (the port's stand-in for jax.tree.map)."""
        return Observation(elements=fn(self.elements),
                           positions=fn(self.positions), bag=fn(self.bag))

    @staticmethod
    def stack(observations: Sequence['Observation']) -> 'Observation':
        return Observation(
            elements=torch.stack([o.elements for o in observations]),
            positions=torch.stack([o.positions for o in observations]),
            bag=torch.stack([o.bag for o in observations]))


class ActionSpace:
    """Maps between device actions (element index + xyz) and host Atoms."""

    def __init__(self, zs: List[int]) -> None:
        self.zs = list(zs)

    @property
    def size(self) -> int:
        return len(self.zs)

    def to_atom(self, action: Tuple[int, Sequence[float]]) -> Atom:
        element_index, position = action
        if element_index < 0:
            raise RuntimeError(f'Invalid element index: {element_index}')
        return Atom(self.zs[int(element_index)], position)


class ObservationSpace:
    """Static-shape observation builder/parser."""

    def __init__(self, canvas_size: int, zs: List[int]) -> None:
        if not zs or zs[0] != 0:
            raise ValueError('the null element 0 must come first in zs')
        self.canvas_size = canvas_size
        self.zs = list(zs)
        self.z_to_index = {z: i for i, z in enumerate(self.zs)}

    @property
    def num_zs(self) -> int:
        return len(self.zs)

    def build(self, atoms: Atoms, formula: FormulaType) -> Observation:
        """Host Atoms + bag -> one unbatched Observation on the CPU."""
        if len(atoms) > self.canvas_size:
            raise RuntimeError(f'Too many atoms: {len(atoms)} > {self.canvas_size}')
        elements = np.zeros(self.canvas_size, dtype=np.int64)
        positions = np.zeros((self.canvas_size, 3), dtype=np.float32)
        for i, atom in enumerate(atoms):
            if atom.z not in self.z_to_index:
                raise RuntimeError(f'Element z={atom.z} not in space {self.zs}')
            elements[i] = self.z_to_index[atom.z]
            positions[i] = atom.position
        return Observation(elements=torch.from_numpy(elements),
                           positions=torch.from_numpy(positions),
                           bag=torch.from_numpy(self.bag_from_formula(formula)))

    def bag_from_formula(self, formula: FormulaType) -> np.ndarray:
        bag = np.zeros(self.num_zs, dtype=np.int64)
        for z, count in formula:
            if z not in self.z_to_index:
                raise RuntimeError(f'Element z={z} not in space {self.zs}')
            bag[self.z_to_index[z]] += count
        return bag

    def to_atoms(self, observation: Observation) -> Atoms:
        elements = observation.elements.cpu().numpy()
        positions = observation.positions.cpu().numpy()
        atoms = Atoms()
        for element_index, position in zip(elements, positions):
            if element_index != 0:
                atoms.append(Atom(self.zs[int(element_index)], position))
        return atoms


def symbols_to_zs(symbols: str) -> List[int]:
    """'X,H,C,N,O,F' -> [0, 1, 6, 7, 8, 9]."""
    return [ATOMIC_NUMBERS[s.strip()] for s in symbols.split(',')]
