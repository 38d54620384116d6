"""Minimal host-side molecule container and XYZ IO (the port's own copy of
molgym_tpu/atoms.py)."""
from __future__ import annotations

import collections
import os
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from molgym_tpu_torch.periodic import ATOMIC_NUMBERS, CHEMICAL_SYMBOLS


class Atom:
    __slots__ = ('z', 'position')

    def __init__(self, symbol: Union[str, int], position=(0.0, 0.0, 0.0)):
        if isinstance(symbol, str):
            self.z = ATOMIC_NUMBERS[symbol]
        else:
            self.z = int(symbol)
        self.position = np.asarray(position, dtype=np.float64)

    @property
    def symbol(self) -> str:
        return CHEMICAL_SYMBOLS[self.z]

    def __repr__(self) -> str:
        return f'Atom({self.symbol!r}, {tuple(self.position)})'


class Atoms:
    """An ordered collection of atoms with positions in Angstrom."""

    def __init__(self,
                 symbols: Optional[Sequence[Union[str, int]]] = None,
                 positions: Optional[Sequence[Sequence[float]]] = None):
        symbols = list(symbols) if symbols is not None else []
        self._zs: List[int] = [
            ATOMIC_NUMBERS[s] if isinstance(s, str) else int(s) for s in symbols
        ]
        if positions is None:
            positions = np.zeros((len(self._zs), 3))
        self._positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
        if len(self._zs) != len(self._positions):
            raise ValueError(f'{len(self._zs)} symbols but '
                             f'{len(self._positions)} positions')

    def __len__(self) -> int:
        return len(self._zs)

    def __iter__(self) -> Iterable[Atom]:
        for z, pos in zip(self._zs, self._positions):
            yield Atom(z, pos)

    def __getitem__(self, index):
        if isinstance(index, (int, np.integer)):
            return Atom(self._zs[index], self._positions[index])
        indices = np.arange(len(self))[index]
        return Atoms([self._zs[i] for i in indices], self._positions[indices])

    def append(self, atom: Atom) -> None:
        self._zs.append(atom.z)
        self._positions = np.concatenate(
            [self._positions, atom.position.reshape(1, 3)], axis=0)

    def copy(self) -> 'Atoms':
        return Atoms(list(self._zs), self._positions.copy())

    @property
    def numbers(self) -> np.ndarray:
        return np.asarray(self._zs, dtype=np.int64)

    @property
    def symbols(self) -> List[str]:
        return [CHEMICAL_SYMBOLS[z] for z in self._zs]

    @property
    def positions(self) -> np.ndarray:
        return self._positions

    @positions.setter
    def positions(self, value) -> None:
        value = np.asarray(value, dtype=np.float64).reshape(-1, 3)
        if len(value) != len(self._zs):
            raise ValueError(f'{len(value)} positions for {len(self._zs)} atoms')
        self._positions = value

    def get_chemical_formula(self) -> str:
        """Symbols in alphabetical order, each with its count above 1."""
        counts = collections.Counter(self.symbols)
        return ''.join(f'{s}{c if c > 1 else ""}'
                       for s, c in sorted(counts.items()))

    def __repr__(self) -> str:
        return f'Atoms({self.get_chemical_formula()!r})'


def write_xyz(path_or_file, atoms_or_list, comment: str = '') -> None:
    """Write one molecule, or a list of them as a multi-frame XYZ file, to a
    path or an open text file."""
    frames = (atoms_or_list if isinstance(atoms_or_list, (list, tuple))
              else [atoms_or_list])
    close = isinstance(path_or_file, (str, bytes, os.PathLike))
    f = open(path_or_file, 'w') if close else path_or_file
    try:
        for atoms in frames:
            f.write(f'{len(atoms)}\n{comment}\n')
            for atom in atoms:
                x, y, z = atom.position
                f.write(f'{atom.symbol} {x:.8f} {y:.8f} {z:.8f}\n')
    finally:
        if close:
            f.close()


def read_xyz(path, index: Union[int, slice] = 0):
    """Read a (multi-frame) XYZ file: the frame at an int `index`, or the
    list of frames a slice selects."""
    frames: List[Atoms] = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        n = int(line)
        symbols, positions = [], []
        for row in lines[i + 2:i + 2 + n]:
            parts = row.split()
            symbols.append(parts[0])
            positions.append([float(v) for v in parts[1:4]])
        frames.append(Atoms(symbols, positions))
        i += 2 + n
    return frames[index]
