"""SCINE Sparrow quantum-chemistry backend, import-gated (the port's copy of
molgym_tpu/calculators/sparrow.py).

An adapter over the Sparrow v2 (`scine_sparrow.Calculation`) or v3
(`scine_utilities` module manager) APIs with the reference's calculator
interface (molgym/calculator.py:9-100): set_elements, set_positions
(Angstrom -> Bohr), set_settings (unrestricted -> spin_mode),
calculate_energy, calculate_gradients.

Where scine is not installed, `SPARROW_AVAILABLE` is False, `Sparrow` is
None, and SparrowBatchCalculator raises. The batched pool makes a new
calculator per call: Sparrow calculations slow down over an object's
lifetime (the reference works around the same bug, molgym/reward.py:24-26).
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np

from molgym_tpu_torch.envs.reward import get_minimum_spin_multiplicity

SPARROW_AVAILABLE = False
Sparrow = None
_su = None

try:  # Sparrow v2
    from scine_sparrow import Calculation as _SparrowV2  # type: ignore

    Sparrow = _SparrowV2
    SPARROW_AVAILABLE = True
except ImportError:
    try:  # Sparrow v3
        import scine_sparrow  # type: ignore # noqa: F401
        import scine_utilities as _su  # type: ignore

        _manager = _su.core.ModuleManager()

        class _SparrowV3:
            """v3 adapter (manager-based calculator)."""

            def __init__(self, method: str) -> None:
                self.calc = _manager.get('calculator', method)
                self.calc.set_required_properties(
                    [_su.Property.Energy, _su.Property.Gradients])
                self.elements = None
                self.positions = None

            def set_elements(self, codes: Sequence) -> None:
                elems = []
                for code in codes:
                    if isinstance(code, str):
                        code = getattr(_su.ElementType, code)
                    elems.append(code)
                self.elements = elems

            def set_positions(self, crd) -> None:
                self.positions = np.array(crd) * _su.BOHR_PER_ANGSTROM

            def set_settings(self, attr: dict) -> None:
                for key, value in attr.items():
                    if key == 'unrestricted_calculation':
                        self.calc.settings['spin_mode'] = (
                            'unrestricted' if value else 'restricted')
                        continue
                    try:
                        self.calc.settings[key] = value
                    except RuntimeError as exc:  # pragma: no cover
                        print(f'Unable to set {key} = {value}: {exc}')

            def _structure(self):
                structure = _su.AtomCollection(len(self.elements))
                structure.elements = self.elements
                structure.positions = self.positions
                return structure

            def calculate_energy(self) -> float:
                self.calc.structure = self._structure()
                return self.calc.calculate().energy

            def calculate_gradients(self):
                self.calc.structure = self._structure()
                return self.calc.calculate().gradients

        Sparrow = _SparrowV3
        SPARROW_AVAILABLE = True
    except ImportError:
        pass


DEFAULT_SETTINGS = {
    'molecular_charge': 0,
    'max_scf_iterations': 128,
    'unrestricted_calculation': 1,
}


class SparrowBatchCalculator:
    """Thread-pooled batched PM6 interaction rewards with a per-element
    atomic-energy cache (reference molgym/reward.py:57-62 semantics)."""

    def __init__(self, method: str = 'PM6', num_threads: int = 8,
                 settings: Optional[dict] = None) -> None:
        if not SPARROW_AVAILABLE:
            raise RuntimeError(
                'scine_sparrow is not installed; use the native or device '
                'reward backends instead')
        self.method = method
        self.settings = dict(settings or DEFAULT_SETTINGS)
        self.pool = ThreadPoolExecutor(max_workers=num_threads)
        self.atom_energies: Dict[int, float] = {}
        self._cache_lock = threading.Lock()
        self.total_time = 0.0
        self.total_evals = 0

    def _energy(self, zs: Sequence[int], positions: np.ndarray) -> float:
        if len(zs) == 0:
            return 0.0
        calc = Sparrow(self.method)  # fresh per call (slowdown workaround)
        calc.set_elements(list(zs))
        calc.set_positions(np.asarray(positions, dtype=np.float64))
        settings = dict(self.settings)
        settings['spin_multiplicity'] = get_minimum_spin_multiplicity(zs)
        calc.set_settings(settings)
        return float(calc.calculate_energy())

    def _atomic_energy(self, z: int) -> float:
        with self._cache_lock:
            if z in self.atom_energies:
                return self.atom_energies[z]
        energy = self._energy([z], np.zeros((1, 3)))
        with self._cache_lock:
            self.atom_energies[z] = energy
        return energy

    def _one_reward(self, zs, positions, n, new_z, new_pos) -> float:
        zs_real = [int(z) for z in zs[:  len(zs)] if z > 0][:n]
        pos_real = positions[np.asarray(zs) > 0][:n]
        all_zs = zs_real + [int(new_z)]
        all_pos = np.concatenate([pos_real, np.asarray(new_pos).reshape(1, 3)])
        e_tot = self._energy(all_zs, all_pos)
        e_parts = self._energy(zs_real, pos_real) + self._atomic_energy(int(new_z))
        return -(e_tot - e_parts)

    def batch_reward(self, zs: np.ndarray, positions: np.ndarray,
                     n_atoms: np.ndarray, new_z: np.ndarray,
                     new_pos: np.ndarray, valid: np.ndarray) -> np.ndarray:
        start = time.time()
        n_mols = zs.shape[0]
        futures = {}
        for m in range(n_mols):
            if valid[m]:
                futures[m] = self.pool.submit(
                    self._one_reward, zs[m], positions[m], int(n_atoms[m]),
                    new_z[m], new_pos[m])
        rewards = np.zeros(n_mols, dtype=np.float64)
        for m, fut in futures.items():
            rewards[m] = fut.result()
        self.total_time += time.time() - start
        self.total_evals += 2 * len(futures)
        return rewards
