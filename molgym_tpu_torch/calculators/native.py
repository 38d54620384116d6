"""ctypes bindings to the native host library (counterpart of
molgym_tpu/calculators/native.py): the thread-pooled batched interaction
reward and single-molecule energies and gradients of the pair potentials
(LJ, Morse), extended Hückel and PM6.

The library is the one `host_build.build` makes from the port's sources,
`molgym_tpu_torch/csrc/host/*.cpp`, into `_build/`.
It is loaded with `ctypes.CDLL`, which releases the interpreter lock for
every call, so a reward batch on a worker thread runs beside the thread
that launches the policy's kernels. Plain numpy; no tensor passes here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np

from molgym_tpu_torch import host_build
from molgym_tpu_torch.periodic import ATOMIC_NUMBERS

METHOD_LJ = 0
METHOD_MORSE = 1
METHOD_EHT = 2  # extended Hückel (csrc/host/eht.cpp)
METHOD_PM6 = 3  # NDDO/PM6 SCF (csrc/host/nddo.cpp; oracle: nddo_ref.py)
METHODS = {'lj': METHOD_LJ, 'morse': METHOD_MORSE, 'eht': METHOD_EHT,
           'pm6': METHOD_PM6}

_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_dbl_p = ctypes.POINTER(ctypes.c_double)
_c_u8_p = ctypes.POINTER(ctypes.c_ubyte)

# (restype, argtypes) of every function of the library's C interface
_SIGNATURES = {
    'mg_batch_reward': (ctypes.c_int, [
        ctypes.c_int, ctypes.c_int, _c_int_p, _c_dbl_p, _c_int_p, _c_int_p,
        _c_dbl_p, _c_u8_p, ctypes.c_int, ctypes.c_double, _c_dbl_p]),
    'mg_energy': (ctypes.c_double, [_c_int_p, _c_dbl_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_double]),
    'mg_gradients': (ctypes.c_int, [_c_int_p, _c_dbl_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_double, _c_dbl_p]),
    'mg_pool_stats': (None, [ctypes.POINTER(ctypes.c_longlong),
                             ctypes.POINTER(ctypes.c_longlong)]),
    'mg_nddo_energy': (ctypes.c_double, [_c_int_p, _c_dbl_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]),
    'mg_nddo_gradients': (ctypes.c_int, [_c_int_p, _c_dbl_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         _c_dbl_p]),
    'mg_nddo_supported': (ctypes.c_int, [ctypes.c_int]),
    'mg_eht_orbitals': (ctypes.c_int, [_c_int_p, _c_dbl_p, ctypes.c_int,
                                       _c_dbl_p, ctypes.c_int, _c_int_p]),
    'mg_nddo_scf_density': (ctypes.c_int, [
        _c_int_p, _c_dbl_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _c_dbl_p, _c_dbl_p, _c_int_p, _c_dbl_p]),
}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The host library, built first if this host has no current one, with
    its C interface's signatures set."""
    lib = ctypes.CDLL(str(host_build.build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _ints(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.int32)


def _doubles(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64)


def eht_orbital_energies(zs, positions) -> Tuple[np.ndarray, int]:
    """Sorted EHT MO energies (eV) and the valence electron count."""
    lib = load_library()
    zs, pos = _ints(zs), _doubles(positions)
    eps = np.zeros(16 + 4 * len(zs), dtype=np.float64)
    n_elec = ctypes.c_int()
    n = lib.mg_eht_orbitals(_ptr(zs, ctypes.c_int), _ptr(pos, ctypes.c_double),
                            len(zs), _ptr(eps, ctypes.c_double), len(eps),
                            ctypes.byref(n_elec))
    return eps[:n] * 27.211386, n_elec.value


def nddo_scf_density(zs, positions, charge: int = 0, multiplicity: int = 0
                     ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Converged PM6 UHF (energy in Hartree, alpha density, beta density).
    Raises RuntimeError when the SCF does not converge."""
    lib = load_library()
    zs, pos = _ints(zs), _doubles(positions)
    cap = (9 * len(zs)) ** 2  # spd worst case
    pa = np.zeros(cap, dtype=np.float64)
    pb = np.zeros(cap, dtype=np.float64)
    norb = ctypes.c_int()
    energy = ctypes.c_double()
    ret = lib.mg_nddo_scf_density(
        _ptr(zs, ctypes.c_int), _ptr(pos, ctypes.c_double), len(zs),
        charge, multiplicity, cap, _ptr(pa, ctypes.c_double),
        _ptr(pb, ctypes.c_double), ctypes.byref(norb), ctypes.byref(energy))
    if ret != 0:
        raise RuntimeError(f'mg_nddo_scf_density failed (code {ret})')
    n = norb.value
    return energy.value, pa[:n * n].reshape(n, n), pb[:n * n].reshape(n, n)


class NativeBatchCalculator:
    """Batched interaction rewards -(E(canvas + new) - E(canvas) - E(new
    alone)) over the library's thread pool; an SCF that does not converge
    gives -1e6."""

    def __init__(self, method: int = METHOD_LJ, epsilon: float = 0.15) -> None:
        self.lib = load_library()
        self.method = method
        self.epsilon = epsilon

    def batch_reward(self, zs: np.ndarray, positions: np.ndarray,
                     n_atoms: np.ndarray, new_z: np.ndarray,
                     new_pos: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """float64[B] rewards (0 where not `valid`) of zs[B, N] atomic
        numbers (0 = empty), positions[B, N, 3] in Angstrom, n_atoms[B],
        new_z[B], new_pos[B, 3], valid[B]."""
        zs = _ints(zs)
        n_mols, max_atoms = zs.shape
        positions = _doubles(positions)
        n_atoms, new_z = _ints(n_atoms), _ints(new_z)
        new_pos = _doubles(new_pos)
        valid = np.ascontiguousarray(valid, dtype=np.uint8)
        if (positions.shape != (n_mols, max_atoms, 3)
                or new_pos.shape != (n_mols, 3)
                or not n_atoms.shape == new_z.shape == valid.shape == (n_mols, )):
            raise ValueError('batch_reward: zs [B, N], positions [B, N, 3], '
                             'n_atoms, new_z, valid [B] and new_pos [B, 3]')
        rewards = np.zeros(n_mols, dtype=np.float64)
        ret = self.lib.mg_batch_reward(
            n_mols, max_atoms, _ptr(zs, ctypes.c_int),
            _ptr(positions, ctypes.c_double), _ptr(n_atoms, ctypes.c_int),
            _ptr(new_z, ctypes.c_int), _ptr(new_pos, ctypes.c_double),
            _ptr(valid, ctypes.c_ubyte), self.method, self.epsilon,
            _ptr(rewards, ctypes.c_double))
        if ret != 0:
            raise RuntimeError(f'mg_batch_reward failed (code {ret})')
        return rewards

    def pool_stats(self) -> Tuple[int, int]:
        """(energy evaluations, batches) of the library since it loaded."""
        evals = ctypes.c_longlong()
        batches = ctypes.c_longlong()
        self.lib.mg_pool_stats(ctypes.byref(evals), ctypes.byref(batches))
        return evals.value, batches.value


class NativeCalc:
    """Single-molecule calculator with the Sparrow adapter's interface
    (set_elements, set_positions, set_settings, calculate_energy,
    calculate_gradients), over the library. PM6 takes the settings'
    molecular_charge and spin_multiplicity (0: (sum of Z) % 2 + 1); the
    other methods ignore them. The minimizer's backend."""

    def __init__(self, method: str = 'LJ', epsilon: float = 0.15) -> None:
        self.lib = load_library()
        self.method = METHODS[method.lower()]
        self.epsilon = epsilon
        self._zs: Optional[np.ndarray] = None
        self._positions: Optional[np.ndarray] = None
        self._settings: dict = {}

    def set_elements(self, elements: Sequence) -> None:
        self._zs = _ints([ATOMIC_NUMBERS[e] if isinstance(e, str) else int(e)
                          for e in elements])

    def set_positions(self, positions) -> None:
        self._positions = _doubles(positions).reshape(-1, 3)

    def set_settings(self, settings: dict) -> None:
        self._settings = dict(settings)

    def _molecule(self):
        if self._zs is None or self._positions is None:
            raise RuntimeError('set_elements and set_positions first')
        if len(self._zs) != len(self._positions):
            raise ValueError(f'{len(self._zs)} elements but '
                             f'{len(self._positions)} positions')
        return (_ptr(self._zs, ctypes.c_int),
                _ptr(self._positions, ctypes.c_double), len(self._zs))

    def _scf_args(self) -> Tuple[int, int]:
        return (int(self._settings.get('molecular_charge', 0)),
                int(self._settings.get('spin_multiplicity', 0)))

    def calculate_energy(self) -> float:
        molecule = self._molecule()
        if self.method == METHOD_PM6:
            return float(self.lib.mg_nddo_energy(*molecule, *self._scf_args()))
        return float(self.lib.mg_energy(*molecule, self.method, self.epsilon))

    def calculate_gradients(self) -> np.ndarray:
        molecule = self._molecule()
        grad = np.zeros((molecule[2], 3), dtype=np.float64)
        out = _ptr(grad, ctypes.c_double)
        if self.method == METHOD_PM6:
            ret = self.lib.mg_nddo_gradients(*molecule, *self._scf_args(), out)
        else:
            ret = self.lib.mg_gradients(*molecule, self.method, self.epsilon,
                                        out)
        if ret != 0:
            raise RuntimeError(f'gradients failed (code {ret})')
        return grad
