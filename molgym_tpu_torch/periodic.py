"""Standalone periodic-table data (the port's own copy of
molgym_tpu/periodic.py: symbols, atomic numbers, covalent radii, the
validity-rule element sets and the default valences)."""
from __future__ import annotations

# Index == atomic number. Index 0 is the null element 'X' used for canvas
# padding.
CHEMICAL_SYMBOLS = [
    'X', 'H', 'He', 'Li', 'Be', 'B', 'C', 'N', 'O', 'F', 'Ne', 'Na', 'Mg',
    'Al', 'Si', 'P', 'S', 'Cl', 'Ar', 'K', 'Ca', 'Sc', 'Ti', 'V', 'Cr', 'Mn',
    'Fe', 'Co', 'Ni', 'Cu', 'Zn', 'Ga', 'Ge', 'As', 'Se', 'Br', 'Kr', 'Rb',
    'Sr', 'Y', 'Zr', 'Nb', 'Mo', 'Tc', 'Ru', 'Rh', 'Pd', 'Ag', 'Cd', 'In',
    'Sn', 'Sb', 'Te', 'I', 'Xe', 'Cs', 'Ba', 'La', 'Ce', 'Pr', 'Nd', 'Pm',
    'Sm', 'Eu', 'Gd', 'Tb', 'Dy', 'Ho', 'Er', 'Tm', 'Yb', 'Lu', 'Hf', 'Ta',
    'W', 'Re', 'Os', 'Ir', 'Pt', 'Au', 'Hg', 'Tl', 'Pb', 'Bi', 'Po', 'At',
    'Rn', 'Fr', 'Ra', 'Ac', 'Th', 'Pa', 'U', 'Np', 'Pu', 'Am', 'Cm', 'Bk',
    'Cf', 'Es', 'Fm', 'Md', 'No', 'Lr', 'Rf', 'Db', 'Sg', 'Bh', 'Hs', 'Mt',
    'Ds', 'Rg', 'Cn', 'Nh', 'Fl', 'Mc', 'Lv', 'Ts', 'Og'
]

ATOMIC_NUMBERS = {symbol: z for z, symbol in enumerate(CHEMICAL_SYMBOLS)}

NULL_SYMBOL = 'X'

# Covalent radii in Angstrom (Cordero et al. 2008; 0.2 used for unknown/X).
# Others fall back to 1.5 A.
_COVALENT_RADII_KNOWN = {
    0: 0.20, 1: 0.31, 2: 0.28, 3: 1.28, 4: 0.96, 5: 0.84, 6: 0.76, 7: 0.71,
    8: 0.66, 9: 0.57, 10: 0.58, 11: 1.66, 12: 1.41, 13: 1.21, 14: 1.11,
    15: 1.07, 16: 1.05, 17: 1.02, 18: 1.06, 19: 2.03, 20: 1.76, 35: 1.20,
    53: 1.39,
}


def covalent_radius(z: int) -> float:
    return _COVALENT_RADII_KNOWN.get(z, 1.50)


# Elements that must stay near a heavy atom in the environment validity
# check (H, F, Cl, Br).
SOLO_CANDIDATE_ZS = (1, 9, 17, 35)

# Default valence (bond count) of the stochastic environment's even-parity
# check on a sampled bag.
Z_TO_BOND_COUNT = {1: 1, 5: 3, 6: 4, 7: 3, 8: 2, 9: 1}
