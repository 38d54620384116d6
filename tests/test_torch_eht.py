"""The port's extended Hückel backend (molgym_tpu_torch/csrc/host/eht.cpp,
through calculators/native.py) on the CPU: every case of tests/test_eht.py
pointed at the port, with its tolerances — binding curves, invariances,
the reward, the minimizer, and the external anchors (the Wolfsberg-Helmholz
two-level relation, CH4's t2 degeneracy and Koopmans IPs, N2's gap)."""
import numpy as np
import pytest

from molgym_tpu_torch.atoms import Atom, Atoms
from molgym_tpu_torch.calculators.native import (METHOD_EHT,
                                                 NativeBatchCalculator,
                                                 NativeCalc,
                                                 eht_orbital_energies)
from molgym_tpu_torch.calculators.reward_host import InteractionReward
from molgym_tpu_torch.minimizer import minimize


def energy(symbols, positions):
    calc = NativeCalc(method='EHT')
    calc.set_elements(symbols)
    calc.set_positions(np.asarray(positions, np.float64))
    return calc.calculate_energy()


class TestEHTEnergies:
    def test_h2_binding_curve(self):
        """H2 binds with a minimum near the physical bond length."""
        e_atoms = 2 * energy(['H'], [[0, 0, 0]])
        rs = np.arange(0.4, 2.51, 0.05)
        es = np.array([energy(['H', 'H'], [[0, 0, 0], [r, 0, 0]]) - e_atoms
                       for r in rs])
        r_min = rs[np.argmin(es)]
        assert 0.5 < r_min < 1.0
        assert es.min() < -0.1  # bound by > 0.1 Ha
        assert es[0] > es.min()  # repulsive wall at short range

    def test_oh_binding(self):
        e_atoms = energy(['O'], [[0, 0, 0]]) + energy(['H'], [[0, 0, 0]])
        e_bond = energy(['O', 'H'], [[0, 0, 0], [0.97, 0, 0]]) - e_atoms
        assert e_bond < -0.1

    def test_translation_rotation_invariance(self):
        pos = np.array([[0, 0, 0], [0.7, 0.2, -0.1], [0.1, 0.9, 0.3]])
        e0 = energy(['O', 'H', 'H'], pos)
        e1 = energy(['O', 'H', 'H'], pos + np.array([5.0, -3.0, 2.0]))
        rot = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
        e2 = energy(['O', 'H', 'H'], pos @ rot.T)
        assert e0 == pytest.approx(e1, abs=1e-9)
        assert e0 == pytest.approx(e2, abs=1e-8)

    def test_empty_and_single(self):
        assert energy([], np.zeros((0, 3))) == 0.0
        assert np.isfinite(energy(['C'], [[0, 0, 0]]))

    def test_fd_gradients_consistent(self):
        calc = NativeCalc(method='EHT')
        calc.set_elements(['O', 'H'])
        pos = np.array([[0, 0, 0], [1.1, 0.1, 0]], np.float64)
        calc.set_positions(pos)
        grad = calc.calculate_gradients()
        assert grad.shape == (2, 3)
        # translational invariance: gradients sum to ~0
        np.testing.assert_allclose(grad.sum(0), 0.0, atol=1e-5)


class TestEHTReward:
    def test_bond_formation_rewarded(self):
        reward = InteractionReward(backend='eht')
        r, _ = reward.calculate(Atoms(['O'], [[0, 0, 0]]), Atom('H', (0.97, 0, 0)))
        # pure interaction energy: the isolated atom's orbital energies must
        # NOT leak into the reward (E(atom alone) subtracted, reward.py:43-44)
        assert 0.1 < r < 0.4
        r_far, _ = reward.calculate(Atoms(['O'], [[0, 0, 0]]),
                                    Atom('H', (0.3, 0, 0)))
        assert r_far < 0  # compressed bond is punished

    def test_first_atom_zero_reward(self):
        reward = InteractionReward(backend='eht')
        r, _ = reward.calculate(Atoms(), Atom('O', (0, 0, 0)))
        assert r == pytest.approx(0.0, abs=1e-9)

    def test_batched(self):
        calc = NativeBatchCalculator(method=METHOD_EHT)
        zs = np.array([[8, 0], [8, 1]], np.int32)
        positions = np.zeros((2, 2, 3))
        positions[1, 1] = [0.97, 0, 0]
        r = calc.batch_reward(zs, positions, np.array([1, 2], np.int32),
                              np.array([1, 1], np.int32),
                              np.array([[0.97, 0, 0], [-0.97, 0, 0.2]]),
                              np.array([1, 1], np.uint8))
        assert np.isfinite(r).all()
        assert r[0] > 0.1


class TestEHTMinimizer:
    def test_h2_relaxes_to_bond_length(self):
        calc = NativeCalc(method='EHT')
        atoms = Atoms(['H', 'H'], [[0, 0, 0], [1.4, 0, 0]])
        relaxed, success = minimize(calc, atoms, max_iter=200)
        d = np.linalg.norm(relaxed.positions[1] - relaxed.positions[0])
        assert 0.5 < d < 1.0


class TestEHTExternalAnchors:
    """Anchors against published values rather than self-consistency: the
    Hoffmann VSIPs + K = 1.75 Wolfsberg-Helmholz construction has exact
    consequences (two-level relation, symmetry degeneracies) and Koopmans
    ionization potentials that must land near photoelectron data."""

    def test_h2_wolfsberg_helmholz_relation(self):
        """For a homonuclear 2-orbital problem, eps± = Hii (1 ± K S)/(1 ± S)
        with Hii = -13.6 eV (Hoffmann H 1s VSIP) and K = 1.75: both
        eigenvalues must imply the SAME overlap S in (0, 1)."""
        eps, n_elec = eht_orbital_energies([1, 1], [[0, 0, 0], [0.74, 0, 0]])
        assert n_elec == 2 and len(eps) == 2
        h_ii, k = -13.6, 1.75
        s_bond = (eps[0] - h_ii) / (k * h_ii - eps[0])
        s_anti = (eps[1] - h_ii) / (eps[1] - k * h_ii)
        assert 0.0 < s_bond < 1.0
        assert s_bond == pytest.approx(s_anti, abs=1e-6)
        # bonding below Hii, antibonding above (and above |Hii| K S effect)
        assert eps[0] < h_ii < eps[1]

    def test_ch4_t2_degeneracy_and_koopmans(self):
        """Tetrahedral methane: the HOMO is a triply degenerate t2 set; its
        Koopmans IP must land near the photoelectron value (~14 eV; 2a1 at
        ~23 eV) [Hoffmann JCP 39, 1397 (1963); PES: Potts & Price 1972]."""
        d = 1.09 / np.sqrt(3.0)
        pos = [[0, 0, 0], [d, d, d], [d, -d, -d], [-d, d, -d], [-d, -d, d]]
        eps, n_elec = eht_orbital_energies([6, 1, 1, 1, 1], pos)
        assert n_elec == 8 and len(eps) == 8
        # occupied: a1 + t2 (x3); t2 exactly degenerate by symmetry
        assert eps[1] == pytest.approx(eps[2], abs=1e-6)
        assert eps[2] == pytest.approx(eps[3], abs=1e-6)
        assert eps[3] < eps[4] - 1.0  # HOMO-LUMO gap
        assert -16.5 < eps[1] < -12.5   # 1t2 IP ~ 13.6-14.4 eV
        assert -26.5 < eps[0] < -21.0   # 2a1 IP ~ 22.9 eV

    def test_n2_homo_lumo_gap_and_ordering(self):
        """N2 at its bond length: 10 valence electrons fill below a clear
        HOMO-LUMO gap; Koopmans HOMO near the 15.6 eV photoelectron IP."""
        eps, n_elec = eht_orbital_energies([7, 7], [[0, 0, 0], [1.10, 0, 0]])
        assert n_elec == 10
        homo, lumo = eps[4], eps[5]
        assert lumo - homo > 1.0
        assert -19.0 < homo < -12.0
