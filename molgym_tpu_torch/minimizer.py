"""Geometry relaxation by BFGS on a calculator's energies and gradients (the
port's counterpart of molgym_tpu/minimizer.py; reference molgym/minimizer.py):
scipy's BFGS with the analytic gradient, converged when the largest gradient
component is below 3e-4 (ORCA's TolMaxG), atoms frozen through a gradient
mask. The calculator has the Sparrow adapter's interface
(calculators/native.NativeCalc, or calculators/sparrow's adapters)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.optimize

from molgym_tpu_torch.atoms import Atoms


def minimize(
    calculator,
    atoms: Atoms,
    charge: int = 0,
    spin_multiplicity: int = 1,
    max_iter: int = 120,
    fixed_indices: Optional[Sequence[int]] = None,
    verbose: bool = False,
) -> Tuple[Atoms, bool]:
    """The relaxed copy of `atoms` and whether BFGS converged."""
    atoms = atoms.copy()
    calculator.set_elements(list(atoms.symbols))
    calculator.set_settings({'molecular_charge': charge,
                             'spin_multiplicity': spin_multiplicity})

    mask = np.ones(len(atoms) * 3, dtype=np.float64)
    for index in fixed_indices or ():
        mask[index * 3:(index + 1) * 3] = 0.0

    def objective(coords: np.ndarray) -> Tuple[float, np.ndarray]:
        calculator.set_positions(coords.reshape(-1, 3))
        energy = calculator.calculate_energy()
        gradients = np.asarray(calculator.calculate_gradients())
        return energy, gradients.flatten() * mask

    result = scipy.optimize.minimize(
        objective,
        x0=atoms.positions.flatten(),
        jac=True,
        method='BFGS',
        options={
            'maxiter': max_iter,
            'disp': verbose,
            'norm': np.inf,
            'gtol': 3e-4,  # ORCA TolMaxG
        },
    )
    atoms.positions = result.x.reshape(-1, 3)
    return atoms, bool(result.success)
