"""Minimal host-side molecule container (the port's own copy of the parts of
molgym_tpu/atoms.py that the observation space, the reward classes and the
minimizer use)."""
from __future__ import annotations

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
