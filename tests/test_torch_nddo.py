"""The port's PM6 (molgym_tpu_torch/csrc/host/nddo.cpp, through
calculators/native.py) against the reference's golden values and the
port's numpy oracle (calculators/nddo_ref.py), on the CPU: every case of
tests/test_nddo.py pointed at the port, with its tolerances and
allowances (golden atomic energies within 1e-8 Ha, H2 and the H2O fixture
within 5e-8 Ha and the H2O gradients within 5e-7, C++ against the oracle
within 2e-9 Ha with at most one outcome flip and one basin flip in 6
random molecules); the Cl and Br cases that repeat each other are one
parametrised case each. Then the port's oracle against the JAX package's
(molgym_tpu/calculators/nddo_ref.py): the same energies, densities and
gradients, bit for bit, on the golden molecules and on seeded random
clusters, two of them with S or Cl so that the d shell is reached, and the
same PM6 constants.
"""
import dataclasses
import math

import numpy as np
import pytest

from molgym_tpu.calculators import nddo_ref as jax_nddo_ref
from molgym_tpu_torch.atoms import Atom, Atoms
from molgym_tpu_torch.calculators import nddo_ref
from molgym_tpu_torch.calculators.native import (METHOD_PM6,
                                                 NativeBatchCalculator,
                                                 NativeCalc, load_library,
                                                 nddo_scf_density)
from molgym_tpu_torch.calculators.reward_host import InteractionReward
from molgym_tpu_torch.minimizer import minimize

# reference tests/resources/h2o.xyz
H2O_ZS = [8, 1, 1]
H2O_POS = np.array([[-0.27939703, 0.83823215, 0.00973345],
                    [-0.52040310, 1.77677325, 0.21391146],
                    [0.54473632, 0.90669722, -0.53501306]])
# reference tests/resources/energy.dat / gradients.dat (Sparrow 1.0 PM6 CLI)
H2O_ENERGY = -11.72459668
H2O_GRADIENTS = np.array([[-8.700857e-03, -1.502556e-02, 5.081632e-03],
                          [-4.048210e-03, 1.437334e-02, 3.364464e-03],
                          [1.274907e-02, 6.522202e-04, -8.446095e-03]])


def pm6_calc(symbols, positions, charge=0, multiplicity=0):
    calc = NativeCalc(method='PM6')
    calc.set_elements(symbols)
    calc.set_positions(np.asarray(positions, np.float64))
    calc.set_settings({'molecular_charge': charge,
                       'spin_multiplicity': multiplicity})
    return calc


class TestGoldenEnergies:
    """Reference tests/test_sparrow.py parity, scine-free."""

    def test_h2_energy_and_gradients(self):
        calc = pm6_calc(['H', 'H'], [(0, 0, 0), (1.2, 0, 0)],
                        charge=0, multiplicity=1)
        energy = calc.calculate_energy()
        gradients = calc.calculate_gradients()
        assert energy == pytest.approx(-0.9379853016, abs=5e-8)
        assert gradients.shape == (2, 3)

    def test_atomic_energies(self):
        # multiplicities as in reference tests/test_sparrow.py:36-48
        assert pm6_calc(['H'], [(0, 0, 0)], multiplicity=2).calculate_energy() \
            == pytest.approx(-0.4133180865, abs=1e-8)
        assert pm6_calc(['C'], [(0, 0, 0)], multiplicity=1).calculate_energy() \
            == pytest.approx(-4.162353543, abs=1e-8)
        assert pm6_calc(['O'], [(0, 0, 0)], multiplicity=1).calculate_energy() \
            == pytest.approx(-10.37062419, abs=1e-8)

    def test_h2o_energy_and_gradients(self):
        calc = pm6_calc(['O', 'H', 'H'], H2O_POS, multiplicity=1)
        assert calc.calculate_energy() == pytest.approx(H2O_ENERGY, abs=5e-8)
        np.testing.assert_allclose(calc.calculate_gradients(), H2O_GRADIENTS,
                                   atol=5e-7)


class TestGoldenRewards:
    """Reference tests/test_reward.py parity with the pm6 backend."""

    def setup_method(self):
        self.reward = InteractionReward(backend='pm6')

    def test_first_atom_zero(self):
        r, _ = self.reward.calculate(Atoms(), Atom('H', (0, 0, 0)))
        assert r == pytest.approx(0.0, abs=1e-10)

    def test_h2(self):
        atoms = Atoms(['H'], [[0, 0, 0]])
        r, info = self.reward.calculate(atoms, Atom('H', (1.0, 0, 0)))
        assert r == pytest.approx(0.1696435, abs=1e-7)
        assert info['elapsed_time'] > 0

    def test_addition(self):
        atoms = Atoms(['H'], [[0, 0, 0]])
        r1, _ = self.reward.calculate(atoms, Atom('H', (1.0, 0, 0)))
        atoms = Atoms(['H', 'H'], [[0, 0, 0], [1.0, 0, 0]])
        r2, _ = self.reward.calculate(atoms, Atom('H', (2.0, 0, 0)))
        assert r1 + r2 == pytest.approx(0.2141968, abs=1e-7)


class TestOracleParity:
    """C++ implementation vs the pure-numpy oracle (nddo_ref.py)."""

    def test_random_molecules(self):
        """Same SCF outcome both sides: equal energies when converged, and
        consistent non-convergence (NaN) on pathological clusters.

        Knife-edge tolerance: random clusters with sub-0.6-Å contacts (which
        the environment would reject) can sit exactly on the SCF convergence
        boundary, where the converged/NaN outcome legitimately depends on
        machine FP (measured: 3 flips in a 40-cluster fuzz between the two
        implementations, all with near-coincident atoms). Allow at most one
        outcome flip out of 6.

        Basin tolerance: near-degenerate clusters can make both trajectories
        converge but to DIFFERENT genuine UHF solutions depending on machine
        FP (measured: the trial-0 O3NF chain, basins 0.137 Ha apart, when
        the loaded .so was built on a different host than numpy's BLAS runs
        on). A value disagreement is therefore only a real bug if it breaks
        FUNCTIONAL parity: the oracle evaluating ITS energy functional on
        the C++ converged density must reproduce the C++ energy exactly, and
        that density must be stationary under the oracle's Fock operator.
        Allow at most one such basin flip out of 6; a functional-parity
        violation always fails.
        """
        rng = np.random.default_rng(7)
        zs_pool = [1, 6, 7, 8, 9]
        n_converged = 0
        n_outcome_flips = 0
        n_basin_flips = 0
        for trial in range(6):
            n = int(rng.integers(2, 6))
            zs = [int(rng.choice(zs_pool)) for _ in range(n)]
            pos = rng.uniform(-1.0, 1.0, (n, 3)) * 1.4
            pos[:, 0] += np.arange(n) * 1.6
            e_cpp = pm6_calc([int(z) for z in zs], pos).calculate_energy()
            oracle = nddo_ref.NDDO(zs, pos)
            e_py, conv_py = oracle.scf()
            if conv_py and not np.isnan(e_cpp):
                n_converged += 1
                if e_cpp == pytest.approx(e_py, abs=2e-9):
                    continue
                # different basins: demand functional parity instead
                e_dens, pa, pb = nddo_scf_density(zs, pos)
                assert e_dens == pytest.approx(e_cpp, abs=1e-9)
                e_func, stat = oracle.energy_of_density(pa, pb)
                assert e_func == pytest.approx(e_cpp, abs=1e-8), (zs, pos)
                # stationary under the ORACLE's Fock: a genuine UHF solution
                # of the same equations (1e-5 = the SCF's own flat-acceptance
                # commutator bound; energy error is O(err^2))
                assert stat < 1e-5, (zs, pos, stat)
                n_basin_flips += 1
            elif conv_py != (not np.isnan(e_cpp)):
                n_outcome_flips += 1
        assert n_outcome_flips <= 1, 'more than one knife-edge outcome flip'
        assert n_basin_flips <= 1, 'more than one knife-edge basin flip'
        assert n_converged >= 4  # most random molecules do converge

    def test_functional_parity_on_exported_density(self):
        """mg_nddo_scf_density round-trip: the oracle's energy functional
        evaluated on the C++ converged density reproduces the C++ energy to
        ~1e-10 and the density is stationary under the oracle's Fock — the
        implementation-independent parity statement used for basin flips
        (see test_random_molecules), exercised here on the historical
        knife-edge O3NF chain and on plain water."""
        # trial 0 of test_random_molecules' generator: the O3NF chain whose
        # two UHF basins sit 0.137 Ha apart across FP environments
        rng = np.random.default_rng(7)
        n = int(rng.integers(2, 6))
        zs_pool = [1, 6, 7, 8, 9]
        o3nf_zs = [int(rng.choice(zs_pool)) for _ in range(n)]
        o3nf_pos = rng.uniform(-1.0, 1.0, (n, 3)) * 1.4
        o3nf_pos[:, 0] += np.arange(n) * 1.6
        assert o3nf_zs == [8, 8, 9, 7, 8]
        o3nf = (o3nf_zs, o3nf_pos)
        h2o = ([8, 1, 1],
               np.array([[0.0, 0.0, 0.0], [0.9572, 0.0, 0.0],
                         [-0.2399872, 0.9266272, 0.0]]))
        for zs, pos in (o3nf, h2o):
            e_cpp, pa, pb = nddo_scf_density(zs, pos)
            oracle = nddo_ref.NDDO(zs, pos)
            e_func, stat = oracle.energy_of_density(pa, pb)
            assert e_func == pytest.approx(e_cpp, abs=1e-8)
            assert stat < 1e-5

    def test_sulfur_spd_parity(self):
        """S runs through the full spd (MNDO/d) machinery in both
        implementations and they agree."""
        zs = [16, 1, 1]
        pos = np.array([[0, 0, 0], [1.35, 0, 0], [-0.3, 1.3, 0]])
        e_cpp = pm6_calc(['S', 'H', 'H'], pos).calculate_energy()
        assert e_cpp == pytest.approx(nddo_ref.energy(zs, pos), abs=2e-9)
        # bound vs atoms
        e_s = pm6_calc(['S'], [(0, 0, 0)]).calculate_energy()
        e_h = pm6_calc(['H'], [(0, 0, 0)]).calculate_energy()
        assert e_cpp < e_s + 2 * e_h


class TestInvariances:
    def test_translation_rotation(self):
        e0 = pm6_calc(['O', 'H', 'H'], H2O_POS).calculate_energy()
        e1 = pm6_calc(['O', 'H', 'H'],
                      H2O_POS + np.array([3.0, -2.0, 7.0])).calculate_energy()
        rng = np.random.default_rng(3)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        e2 = pm6_calc(['O', 'H', 'H'], H2O_POS @ q.T).calculate_energy()
        assert e1 == pytest.approx(e0, abs=1e-9)
        assert e2 == pytest.approx(e0, abs=1e-8)

    def test_atom_order_permutation(self):
        perm = [2, 0, 1]
        e0 = pm6_calc(['O', 'H', 'H'], H2O_POS).calculate_energy()
        e1 = pm6_calc([['O', 'H', 'H'][i] for i in perm],
                      H2O_POS[perm]).calculate_energy()
        assert e1 == pytest.approx(e0, abs=1e-9)

    def test_gradients_translationally_invariant(self):
        calc = pm6_calc(['O', 'H', 'H'], H2O_POS)
        grad = calc.calculate_gradients()
        np.testing.assert_allclose(grad.sum(0), 0.0, atol=1e-6)

    def test_sulfur_d_rotation_invariance_cpp(self):
        # exercises the 5x5 d rotation + generic spd two-center path in C++.
        # The discrete point-multipole configurations are not exactly
        # axially symmetric as tensors (true of the classic sp model too,
        # ~2e-5 at the ERI level); for sp pairs the deviation cancels
        # exactly in the energy, for d-involving pairs ~1e-6 Ha leaks
        # through — physically negligible (0.0008 kcal/mol), hence the
        # tolerance.
        pos = np.array([[0.0, 0.0, 0.0], [1.59, 0.0, 0.0],
                        [-0.42, 1.55, 0.0]])
        e0 = pm6_calc(['S', 'F', 'F'], pos).calculate_energy()
        rng = np.random.default_rng(5)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        e1 = pm6_calc(['S', 'F', 'F'], pos @ q.T).calculate_energy()
        assert np.isfinite(e0)
        assert e1 == pytest.approx(e0, abs=1e-5)

    def test_sulfur_gradients_frozen_density_accurate(self):
        # C++ frozen-density FD vs the oracle's full-SCF FD on the d path
        zs = [16, 1, 1]
        pos = np.array([[0.0, 0.0, 0.0], [1.34, 0.0, 0.0],
                        [-0.05, 1.33, 0.0]])
        g_cpp = pm6_calc(['S', 'H', 'H'], pos).calculate_gradients()
        g_ref = nddo_ref.gradients(zs, pos)
        np.testing.assert_allclose(g_cpp, g_ref, atol=1e-6)


class TestOverlapIntegrals:
    """STO overlap machinery against closed-form values."""

    def test_1s_1s_equal_zeta(self):
        for z, r in [(1.0, 1.4), (1.3, 2.5)]:
            p = z * r
            expected = np.exp(-p) * (1 + p + p * p / 3)
            got = nddo_ref.sto_overlap(1, 0, z, 1, 0, z, 0, r)
            assert got == pytest.approx(expected, abs=1e-12)

    def test_2p_pi_equal_zeta(self):
        for z, r in [(1.7, 2.6), (2.27, 2.0)]:
            p = z * r
            expected = np.exp(-p) * (1 + p + 2 * p * p / 5 + p ** 3 / 15)
            got = nddo_ref.sto_overlap(2, 1, z, 2, 1, z, 1, r)
            assert got == pytest.approx(expected, abs=1e-12)

    def test_s_pi_is_zero(self):
        assert nddo_ref.sto_overlap(1, 0, 1.3, 2, 1, 2.3, 1, 2.0) == 0.0


class TestMultipoleIntegrals:
    def test_one_center_limits(self):
        """Two-center ERIs approach the Klopman one-center values as R -> 0."""
        par = nddo_ref.PM6_PARAMS[8]
        m = nddo_ref.two_center_eri_local(par, par, 1e-9)
        ev = nddo_ref.EV_PER_HARTREE
        # (ss|ss) -> gss
        assert m[0, 0] * ev == pytest.approx(par.gss, abs=1e-6)
        # (sp_z|sp_z) -> hsp (dipole-dipole at R=0)
        assert m[3, 3] * ev == pytest.approx(par.hsp, abs=1e-5)
        # (p_x p_y|p_x p_y) -> hpp
        hpp = 0.5 * (par.gpp - par.gp2)
        assert m[7, 7] * ev == pytest.approx(hpp, abs=1e-5)

    def test_long_range_monopole(self):
        """(ss|ss) -> 1/R at long range (Hartree, bohr)."""
        par = nddo_ref.PM6_PARAMS[1]
        r = 60.0
        m = nddo_ref.two_center_eri_local(par, par, r)
        assert m[0, 0] == pytest.approx(1.0 / r, rel=1e-3)


class TestRewardPipeline:
    def test_batch_reward_matches_object_api(self):
        batch = NativeBatchCalculator(method=METHOD_PM6)
        zs = np.zeros((2, 4), np.int32)
        pos = np.zeros((2, 4, 3))
        zs[0, 0] = 1
        zs[1, :2] = [8, 1]
        pos[1, 1] = [0.96, 0, 0]
        n_atoms = np.array([1, 2], np.int32)
        new_z = np.array([1, 1], np.int32)
        new_pos = np.array([[1.0, 0, 0], [-0.3, 0.9, 0]])
        r = batch.batch_reward(zs, pos, n_atoms, new_z, new_pos,
                               np.ones(2, np.uint8))
        assert r[0] == pytest.approx(0.1696435, abs=1e-7)
        obj = InteractionReward(backend='pm6')
        r1, _ = obj.calculate(
            Atoms(['O', 'H'], [[0, 0, 0], [0.96, 0, 0]]),
            Atom('H', (-0.3, 0.9, 0)))
        assert r[1] == pytest.approx(r1, abs=1e-6)

    def test_unsupported_element_clamped(self):
        """Elements without PM6 parameters yield the NaN->-1e6 clamp, which
        the env's min_reward rule then terminates on."""
        batch = NativeBatchCalculator(method=METHOD_PM6)
        zs = np.array([[26, 0]], np.int32)  # Fe: unsupported
        r = batch.batch_reward(zs, np.zeros((1, 2, 3)),
                               np.array([1], np.int32),
                               np.array([1], np.int32),
                               np.array([[1.0, 0, 0]]), np.ones(1, np.uint8))
        assert r[0] <= -1e5


class TestMinimizerPM6:
    def test_h2o_relaxes(self):
        calc = pm6_calc(['O', 'H', 'H'], H2O_POS)
        e_before = calc.calculate_energy()
        atoms = Atoms(['O', 'H', 'H'], H2O_POS)
        relaxed, success = minimize(calc, atoms)
        calc.set_positions(relaxed.positions)
        e_after = calc.calculate_energy()
        assert success
        assert e_after < e_before
        # O-H bond lengths land near the PM6 equilibrium (~0.95 A)
        d1 = np.linalg.norm(relaxed.positions[1] - relaxed.positions[0])
        d2 = np.linalg.norm(relaxed.positions[2] - relaxed.positions[0])
        assert 0.85 < d1 < 1.1 and 0.85 < d2 < 1.1

    @pytest.mark.parametrize('symbols,pos', [
        (['O', 'H', 'H'], H2O_POS),
        (['S', 'H', 'H'], [[0.0, 0.0, 0.0], [1.45, 0.2, 0.0],
                           [-0.3, 1.40, 0.1]]),
    ])
    def test_frozen_density_gradients_reach_full_fd_minimum(self, symbols,
                                                            pos):
        """The analytic gradients omit Pulay (density-response) terms
        (csrc/nddo.cpp frozen-density scheme). The consumer is BFGS
        relaxation, so the airtight check is convergence: minimizing with
        the analytic gradients and with full central-difference gradients
        of the SCF energy must land on the SAME minimum — geometry to
        ~2e-3 A and energy to ~1e-6 Ha — including for S where the d shell
        is active (VERDICT r2 'what's weak' #7)."""

        class FullFDCalc:
            """Delegates everything to a NativeCalc but replaces the
            gradients with central finite differences of the energy."""

            def __init__(self, inner, h=1e-4):
                self._inner = inner
                self._h = h

            def __getattr__(self, name):
                return getattr(self._inner, name)

            def calculate_gradients(self):
                pos = np.array(self._inner._positions, dtype=np.float64)
                grad = np.zeros_like(pos)
                for a in range(pos.shape[0]):
                    for c in range(3):
                        for sgn in (+1.0, -1.0):
                            p = pos.copy()
                            p[a, c] += sgn * self._h
                            self._inner.set_positions(p)
                            grad[a, c] += sgn * self._inner.calculate_energy()
                grad /= 2.0 * self._h
                self._inner.set_positions(pos)
                return grad

        pos = np.asarray(pos, np.float64)
        calc_an = pm6_calc(symbols, pos)
        an, ok_an = minimize(calc_an, Atoms(symbols, pos))
        calc_fd = pm6_calc(symbols, pos)
        fd_wrap = FullFDCalc(calc_fd)
        fd, ok_fd = minimize(fd_wrap, Atoms(symbols, pos))
        assert ok_an and ok_fd

        def geom(a):
            d = np.linalg.norm(a.positions[:, None] - a.positions[None],
                               axis=-1)
            return np.sort(d[np.triu_indices(len(symbols), 1)])

        np.testing.assert_allclose(geom(an), geom(fd), atol=2e-3)
        calc_an.set_positions(an.positions)
        e_an = calc_an.calculate_energy()
        calc_fd.set_positions(fd.positions)
        e_fd = calc_fd.calculate_energy()
        assert abs(e_an - e_fd) < 1e-6


class TestDShellMachinery:
    """First-principles checks of the MNDO/d d-shell machinery in the oracle
    (nddo_ref): generalized STO overlaps, the exact 5x5 d rotation, real
    Gaunt coefficients, Slater-Condon radial integrals, the Gaunt-built
    one-center spd tensor, and the reduction of the generic multipole path
    to the classic Dewar-Thiel sp path."""

    def test_d_overlap_numeric_anchor(self):
        # brute-force cylindrical-grid integration of <3d_sigma|3d_sigma>,
        # <3d_pi|2p_pi> style overlaps (moderate grid, loose tol)
        import math

        def numeric(na, la, za, nb, lb, zb, m, r):
            ns_, nz = 300, 600
            smax = 14.0 / min(za, zb)
            zlo, zhi = -14.0 / za, r + 14.0 / zb
            s = (np.arange(ns_) + 0.5) * smax / ns_
            z = zlo + (np.arange(nz) + 0.5) * (zhi - zlo) / nz
            S, Z = np.meshgrid(s, z, indexing='ij')
            rA = np.sqrt(S**2 + Z**2)
            rB = np.sqrt(S**2 + (Z - r)**2)

            def ang(l, mm, ct, st):
                norm = math.sqrt(
                    (2 * l + 1) / (4 * math.pi)
                    * math.factorial(l - mm) / math.factorial(l + mm)
                    * (2.0 if mm else 1.0))
                p = {(0, 0): np.ones_like(ct), (1, 0): ct, (1, 1): st,
                     (2, 0): 0.5 * (3 * ct**2 - 1), (2, 1): 3 * ct * st,
                     (2, 2): 3 * st**2}[(l, mm)]
                return norm * p

            fA = (nddo_ref._sto_norm(na, za) * rA**(na - 1) * np.exp(-za * rA)
                  * ang(la, m, Z / rA, S / rA))
            fB = (nddo_ref._sto_norm(nb, zb) * rB**(nb - 1) * np.exp(-zb * rB)
                  * ang(lb, m, (Z - r) / rB, S / rB))
            phi = 2 * math.pi if m == 0 else math.pi
            return float(np.sum(fA * fB * S)) * (smax / ns_) * \
                ((zhi - zlo) / nz) * phi

        for case in [(3, 2, 2.0, 3, 2, 2.0, 0, 2.2),
                     (3, 2, 2.0, 3, 2, 2.0, 2, 2.2),
                     (3, 2, 1.9, 2, 1, 2.1, 1, 2.8),
                     (3, 2, 2.4, 3, 0, 2.0, 0, 1.9)]:
            assert nddo_ref.sto_overlap(*case) == pytest.approx(
                numeric(*case), abs=5e-5)

    def test_d_rotation_orthogonal_and_homomorphic(self):
        rng = np.random.default_rng(0)
        q1, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        q2, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        d1 = nddo_ref._d_rotation(q1)
        np.testing.assert_allclose(d1 @ d1.T, np.eye(5), atol=1e-12)
        np.testing.assert_allclose(
            nddo_ref._d_rotation(q1 @ q2),
            nddo_ref._d_rotation(q1) @ nddo_ref._d_rotation(q2), atol=1e-12)

    def test_real_gaunt_analytic_values(self):
        import math
        # int S00 S_lm S_lm = 1/sqrt(4 pi); int S1z S1z S20 = 1/sqrt(5 pi)
        assert nddo_ref._real_gaunt(1, 0, 1, 0, 0, 0) == pytest.approx(
            1.0 / math.sqrt(4 * math.pi), abs=1e-12)
        assert nddo_ref._real_gaunt(2, 4, 2, 4, 0, 0) == pytest.approx(
            1.0 / math.sqrt(4 * math.pi), abs=1e-12)
        assert nddo_ref._real_gaunt(1, 0, 1, 0, 2, 0) == pytest.approx(
            1.0 / math.sqrt(5 * math.pi), abs=1e-12)
        # parity: odd l1+l2+L vanishes
        assert nddo_ref._real_gaunt(0, 0, 2, 0, 1, 0) == 0.0
        assert nddo_ref._real_gaunt(1, 1, 2, 1, 2, 1) == 0.0

    def test_slater_condon_hydrogenic(self):
        # R^0(1s 1s; 1s 1s) = 5/8 zeta for equal exponents
        for zeta in (1.0, 1.7, 2.4):
            assert nddo_ref._slater_rk(
                0, 1, zeta, 1, zeta, 1, zeta, 1, zeta) == pytest.approx(
                    0.625 * zeta, rel=1e-12)
        # symmetry under electron swap
        a = nddo_ref._slater_rk(2, 3, 2.0, 3, 1.5, 3, 1.1, 3, 2.2)
        b = nddo_ref._slater_rk(2, 3, 1.5, 3, 2.0, 3, 2.2, 3, 1.1)
        assert a == pytest.approx(b, rel=1e-12)

    def test_one_center_spd_tensor_rotation_invariant(self):
        par = nddo_ref.PM6_PARAMS[16]
        t = nddo_ref.one_center_eri_spd(par)
        rng = np.random.default_rng(7)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        w = nddo_ref._orbital_rotation(q, 9)
        t_rot = np.einsum('am,bn,co,dp,mnop->abcd', w, w, w, w, t,
                          optimize=True)
        np.testing.assert_allclose(t_rot, t, atol=1e-10)

    def test_generic_two_center_reduces_to_classic_sp(self):
        for (za, zb, r) in [(8, 1, 1.8), (6, 7, 2.5), (9, 9, 2.7)]:
            pa = nddo_ref.PM6_PARAMS[za]
            pb = nddo_ref.PM6_PARAMS[zb]
            old = nddo_ref._pairs_to_tensor(
                nddo_ref.two_center_eri_local(pa, pb, r))
            sa, sb = nddo_ref._n_orbs(pa), nddo_ref._n_orbs(pb)
            new = nddo_ref.two_center_eri_spd(za, zb, r)
            np.testing.assert_allclose(new, old[:sa, :sa, :sb, :sb],
                                       atol=1e-14)

    def test_klopman_rho_solutions_consistent(self):
        # the solved rho must reproduce its one-center target channel
        tables = nddo_ref._spd_tables(16)
        par = nddo_ref.PM6_PARAMS[16]
        for key, (mu, nu) in nddo_ref._CANONICAL.items():
            sa, sb, lo = key
            if 2 not in (sa, sb):
                continue
            lm, tm = nddo_ref._ORB_LT[mu]
            ln, tn = nddo_ref._ORB_LT[nu]
            to_c = next(t for t in range(2 * lo + 1)
                        if nddo_ref._real_gaunt(lm, tm, ln, tn, lo, t))
            target = (4.0 * np.pi / (2 * lo + 1)
                      * nddo_ref._one_center_rk(par, lo, (lm, ln), (lm, ln))
                      * nddo_ref._real_gaunt(lm, tm, ln, tn, lo, to_c) ** 2)
            got = nddo_ref._kernel_self_interaction(
                lo, to_c, tables.d[key], tables.rho[key])
            assert got == pytest.approx(target, rel=1e-6)

    def test_sulfur_oracle_rotation_invariance(self):
        zs = [16, 1, 1]
        pos = np.array([[0.0, 0.0, 0.0], [1.34, 0.0, 0.0],
                        [-0.05, 1.33, 0.0]])
        e0 = nddo_ref.energy(zs, pos)
        rng = np.random.default_rng(11)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        e1 = nddo_ref.energy(zs, pos @ q.T)
        assert e1 == pytest.approx(e0, abs=1e-8)

    def test_sulfur_atom_ground_state_is_sp(self):
        m = nddo_ref.NDDO([16], [[0.0, 0.0, 0.0]])
        e, ok = m.scf()
        assert ok
        d_occ = float(np.sum(np.diag(m.p_alpha + m.p_beta)[4:]))
        assert d_occ < 0.05
        # stays within polarization distance of the sp-only ground state
        # (-6.1176479; slight d-p mixing lowers it a touch) — a collapse into
        # the d shell (see the calibration notes on PM6_PARAMS) sits ~0.4 Ha
        # below
        assert abs(e - (-6.117647916855)) < 2e-3

    def test_sf6_hypervalent_binding(self):
        # sp-only NDDO cannot bind six F around S (octet); the d shell must.
        # Loose anchor: atomization within a factor-band of the experimental
        # -472 kcal/mol, octahedral minimum near 1.56 A.
        d = 1.60
        sf6 = [[0, 0, 0], [d, 0, 0], [-d, 0, 0], [0, d, 0], [0, -d, 0],
               [0, 0, d], [0, 0, -d]]
        e = nddo_ref.energy([16] + [9] * 6, sf6)
        e_s = nddo_ref.energy([16], [[0, 0, 0]])
        e_f = nddo_ref.energy([9], [[0, 0, 0]])
        kcal = (e - e_s - 6 * e_f) * 627.509474
        assert -700.0 < kcal < -250.0


def _cpp_energy(zs, pos):
    symbols = {1: 'H', 6: 'C', 7: 'N', 8: 'O', 9: 'F', 16: 'S', 17: 'Cl',
               35: 'Br'}
    calc = pm6_calc([symbols[z] for z in zs], np.asarray(pos, np.float64))
    return calc.calculate_energy()


def _opt_bond(f, lo, hi, n=41):
    rs = np.linspace(lo, hi, n)
    es = [f(r) for r in rs]
    i = int(np.nanargmin(es))
    return rs[i], es[i]


class TestThermochemistryAnchors:
    """Experimental-anchor tests for the calibrated constants
    (experiments/pm6_anchor_fit/; round-3 VERDICT items 4/5). Targets are
    experimental atomization energies (sum dHf(atoms) - dHf(molecule),
    298 K) and bond lengths; tolerances state the achieved accuracy so a
    future parameter change that regresses the thermochemistry fails here.
    All energies via the C++ backend (oracle parity is tested separately)."""

    KCAL = 627.509474

    def _atomization(self, zs, pos):
        e = _cpp_energy(zs, pos)
        atoms = sum(_cpp_energy([z], [[0, 0, 0]]) for z in zs)
        return (e - atoms) * self.KCAL

    @pytest.mark.parametrize('name,zs,build,lo,hi,target_e,tol_e,target_r,tol_r', [
        # O2 run as the (sum Z)%2+1 singlet here (the environment's rule);
        # the triplet anchor fit gives -186 vs exp -120 — the O sp block
        # overbinds O=O and the alpha>=2 locality bound caps the fix
        ('F2', [9, 9], None, 1.2, 1.7, -37.9, 6.0, 1.412, 0.02),
        ('HCl', [17, 1], None, 1.0, 1.6, -103.2, 12.0, 1.275, 0.03),
        ('Cl2', [17, 17], None, 1.7, 2.3, -58.0, 6.0, 1.988, 0.02),
        ('HBr', [35, 1], None, 1.1, 1.8, -87.5, 6.0, 1.414, 0.03),
        ('Br2', [35, 35], None, 1.95, 2.6, -46.1, 6.0, 2.281, 0.02),
    ])
    def test_diatomic(self, name, zs, build, lo, hi, target_e, tol_e,
                      target_r, tol_r):
        def f(r):
            return self._atomization(zs, [[0, 0, 0], [r, 0, 0]])
        r, e = _opt_bond(f, lo, hi)
        assert abs(e - target_e) < tol_e, (name, e)
        assert abs(r - target_r) < tol_r, (name, r)

    def test_o2_triplet(self):
        symbols = ['O', 'O']

        def f(r):
            calc = NativeCalc(method='PM6')
            calc.set_elements(symbols)
            calc.set_positions(np.array([[0, 0, 0], [r, 0, 0]]))
            calc.set_settings({'molecular_charge': 0, 'spin_multiplicity': 3})
            e = calc.calculate_energy()
            return (e - 2 * _cpp_energy([8], [[0, 0, 0]])) * self.KCAL
        r, e = _opt_bond(f, 1.1, 1.7)
        # exp -120.2 / 1.208 A; the O sp block (golden-pinned via H2O)
        # overbinds O=O — the anchor-fit O-O pair cuts -360 -> -186 with the
        # locality bound alpha >= 2 (experiments/pm6_anchor_fit/README.md)
        assert abs(e - (-185.6)) < 25.0, e
        assert abs(r - 1.418) < 0.08, r

    def test_h2s(self):
        import math
        a = math.radians(92.1)

        def f(r):
            return self._atomization(
                [16, 1, 1], [[0, 0, 0], [r, 0, 0],
                             [r * math.cos(a), r * math.sin(a), 0]])
        r, e = _opt_bond(f, 1.15, 1.6)
        assert abs(e - (-173.2)) < 15.0, e  # exp -173.2
        assert abs(r - 1.336) < 0.06, r

    def test_so2(self):
        import math
        a = math.radians(119.5)

        def f(r):
            return self._atomization(
                [16, 8, 8], [[0, 0, 0], [r, 0, 0],
                             [r * math.cos(a), r * math.sin(a), 0]])
        r, e = _opt_bond(f, 1.3, 1.9)
        # exp -256.4 / 1.432 A. The residual (-292, long bond) inherits the
        # O sp overbinding (see test_o2_triplet) — locked here so it cannot
        # silently regress toward the pre-fit -683
        assert abs(e - (-256.4)) < 45.0, e
        assert abs(r - 1.432) < 0.30, r

    def test_sf6(self):
        def f(d):
            pos = [[0, 0, 0], [d, 0, 0], [-d, 0, 0], [0, d, 0], [0, -d, 0],
                   [0, 0, d], [0, 0, -d]]
            return self._atomization([16] + [9] * 6, pos)
        r, e = _opt_bond(f, 1.45, 1.8)
        assert abs(e - (-471.4)) < 25.0, e  # exp -471.4
        assert abs(r - 1.561) < 0.03, r

    def test_sf4(self):
        import math
        aa = math.radians(173.1 / 2)
        ee = math.radians(101.6 / 2)

        def sf4(rax, req):
            pos = [[0, 0, 0],
                   [rax * math.sin(aa), 0, -rax * math.cos(aa)],
                   [-rax * math.sin(aa), 0, -rax * math.cos(aa)],
                   [0, req * math.sin(ee), req * math.cos(ee)],
                   [0, -req * math.sin(ee), req * math.cos(ee)]]
            return self._atomization([16, 9, 9, 9, 9], pos)
        rax, req = 1.65, 1.58
        for _ in range(2):
            rax, _ = _opt_bond(lambda a: sf4(a, req), rax - 0.15, rax + 0.15,
                               n=21)
            req, e = _opt_bond(lambda q: sf4(rax, q), req - 0.15, req + 0.15,
                               n=21)
        assert abs(e - (-324.4)) < 20.0, e  # exp -324.4
        assert 1.5 < rax < 1.75 and 1.45 < req < 1.7

    def test_ch3cl(self):
        import math
        hc = math.radians(180.0 - 108.4)

        def f(rccl):
            pos = [[0, 0, 0], [0, 0, rccl]]
            zs = [6, 17]
            for k in range(3):
                phi = 2 * math.pi * k / 3
                pos.append([1.09 * math.sin(hc) * math.cos(phi),
                            1.09 * math.sin(hc) * math.sin(phi),
                            -1.09 * math.cos(hc)])
                zs.append(1)
            return self._atomization(zs, pos)
        r, e = _opt_bond(f, 1.6, 2.0)
        assert abs(e - (-375.8)) < 12.0, e  # exp -375.8
        assert abs(r - 1.785) < 0.03, r


def _pyramid_pos(zc, zx, r, xcx_deg):
    import math
    ang = math.radians(xcx_deg)
    ct2 = (math.cos(ang) + 0.5) / 1.5
    theta = math.acos(math.sqrt(max(ct2, 0.0)))
    zs = [zc, zx, zx, zx]
    pos = [[0.0, 0.0, 0.0]]
    for k in range(3):
        phi = 2 * math.pi * k / 3
        pos.append([r * math.sin(theta) * math.cos(phi),
                    r * math.sin(theta) * math.sin(phi),
                    r * math.cos(theta)])
    return zs, pos


class TestOrganicAnchors:
    """Round-5 anchor lock-in for the organic + hetero pair constants
    (experiments/pm6_anchor_fit/README.md round-5 tables; VERDICT r04
    next #3). Tolerances state the ACHIEVED accuracy — a parameter change
    that regresses any of these thermochemistry targets fails here. The
    documented residuals (C2H4/CH3OH/CO2 joint-fit compromises, the long
    NH3/NF3 bonds — all O/N sp-block limits under the alpha>=2 locality
    bound) are locked at their achieved values, not at experiment."""

    KCAL = 627.509474

    def _atomization(self, zs, pos, multiplicity=None):
        if multiplicity is not None:
            calc = NativeCalc(method='PM6')
            calc.set_elements(zs)
            calc.set_positions(np.asarray(pos, dtype=float))
            calc.set_settings({'molecular_charge': 0,
                               'spin_multiplicity': multiplicity})
            e = calc.calculate_energy()
        else:
            e = _cpp_energy(zs, pos)
        atoms = sum(_cpp_energy([z], [[0, 0, 0]]) for z in zs)
        return (e - atoms) * self.KCAL

    @pytest.mark.parametrize('name,zs,lo,hi,target_e,tol_e,target_r,tol_r,mult', [
        ('HF', [1, 9], 0.8, 1.1, -136.1, 6.0, 0.917, 0.03, None),
        ('N2', [7, 7], 0.95, 1.35, -225.9, 12.0, 1.098, 0.08, None),
        # NO doublet: achieved -166.1 vs exp -150.9 (N/O sp-block residual)
        ('NO', [7, 8], 1.0, 1.4, -150.9, 22.0, 1.151, 0.09, 2),
    ])
    def test_diatomic(self, name, zs, lo, hi, target_e, tol_e, target_r,
                      tol_r, mult):
        def f(r):
            return self._atomization(zs, [[0, 0, 0], [r, 0, 0]], mult)
        r, e = _opt_bond(f, lo, hi)
        assert abs(e - target_e) < tol_e, (name, e)
        assert abs(r - target_r) < tol_r, (name, r)

    def test_ch4(self):
        def f(rch):
            s = rch / math.sqrt(3)
            return self._atomization(
                [6, 1, 1, 1, 1],
                [[0, 0, 0], [s, s, s], [s, -s, -s], [-s, s, -s], [-s, -s, s]])
        r, e = _opt_bond(f, 0.95, 1.3)
        assert abs(e - (-397.2)) < 8.0, e  # exp -397.2, achieved -399.3
        assert abs(r - 1.087) < 0.03, r

    def test_c2h6(self):
        hcc = math.radians(180.0 - 111.2)

        def f(rcc):
            zs = [6, 6]
            pos = [[0, 0, 0], [0, 0, rcc]]
            for k in range(3):
                phi = 2 * math.pi * k / 3
                pos.append([1.091 * math.sin(hcc) * math.cos(phi),
                            1.091 * math.sin(hcc) * math.sin(phi),
                            -1.091 * math.cos(hcc)])
                zs.append(1)
            for k in range(3):
                phi = 2 * math.pi * k / 3 + math.pi / 3
                pos.append([1.091 * math.sin(hcc) * math.cos(phi),
                            1.091 * math.sin(hcc) * math.sin(phi),
                            rcc + 1.091 * math.cos(hcc)])
                zs.append(1)
            return self._atomization(zs, pos)
        r, e = _opt_bond(f, 1.35, 1.75)
        assert abs(e - (-674.6)) < 10.0, e  # exp -674.6, achieved -670.9
        assert abs(r - 1.536) < 0.06, r

    def test_c2h4(self):
        half = math.radians(117.4 / 2)

        def f(rcc):
            zs = [6, 6, 1, 1, 1, 1]
            pos = [[0, 0, 0], [0, 0, rcc],
                   [1.087 * math.sin(half), 0, -1.087 * math.cos(half)],
                   [-1.087 * math.sin(half), 0, -1.087 * math.cos(half)],
                   [1.087 * math.sin(half), 0, rcc + 1.087 * math.cos(half)],
                   [-1.087 * math.sin(half), 0, rcc + 1.087 * math.cos(half)]]
            return self._atomization(zs, pos)
        r, e = _opt_bond(f, 1.2, 1.5)
        # exp -537.7; achieved -564.3 — the C-C pair's C2H6/C2H4 joint-fit
        # compromise (single bond prioritized), locked at the achieved value
        assert abs(e - (-564.3)) < 12.0, e
        assert abs(r - 1.339) < 0.03, r

    def test_nh3(self):
        def f(rnh):
            zs, pos = _pyramid_pos(7, 1, rnh, 106.7)
            return self._atomization(zs, pos)
        r, e = _opt_bond(f, 0.9, 1.4)
        # exp -280.3 / 1.012; achieved -291.7 / 1.070 with the R^2-form
        # locality bound alpha >= 0.9 (pm6_anchor_fit/README round 5)
        assert abs(e - (-280.3)) < 16.0, e
        assert abs(r - 1.012) < 0.09, r

    def test_hcn(self):
        def f(rcn):
            return self._atomization(
                [1, 6, 7], [[0, 0, -1.065], [0, 0, 0], [0, 0, rcn]])
        r, e = _opt_bond(f, 1.0, 1.35)
        assert abs(e - (-303.7)) < 16.0, e  # exp -303.7, achieved -312.2
        assert abs(r - 1.153) < 0.07, r

    def test_co2(self):
        def f(rco):
            return self._atomization(
                [6, 8, 8], [[0, 0, 0], [0, 0, rco], [0, 0, -rco]])
        r, e = _opt_bond(f, 1.05, 1.35)
        # exp -384.1; achieved -429.1 — CH3OH+CO2 joint-fit compromise on
        # top of the O sp-block overbinding; pre-fit was -668.7
        assert abs(e - (-429.1)) < 20.0, e
        assert abs(r - 1.162) < 0.15, r

    def test_ch3f(self):
        hc = math.radians(180.0 - 108.4)

        def f(rcf):
            pos = [[0, 0, 0], [0, 0, rcf]]
            zs = [6, 9]
            for k in range(3):
                phi = 2 * math.pi * k / 3
                pos.append([1.09 * math.sin(hc) * math.cos(phi),
                            1.09 * math.sin(hc) * math.sin(phi),
                            -1.09 * math.cos(hc)])
                zs.append(1)
            return self._atomization(zs, pos)
        r, e = _opt_bond(f, 1.2, 1.6)
        assert abs(e - (-402.9)) < 8.0, e  # exp -402.9, achieved exact
        assert abs(r - 1.383) < 0.03, r

    def test_nf3(self):
        def f(rnf):
            zs, pos = _pyramid_pos(7, 9, rnf, 102.4)
            return self._atomization(zs, pos)
        r, e = _opt_bond(f, 1.2, 1.65)
        # exp -201.2; achieved -208.0 with the bond running long (1.53 vs
        # 1.365) — N sp-block residual, locked at achieved
        assert abs(e - (-201.2)) < 15.0, e
        assert abs(r - 1.533) < 0.12, r


class TestHalogens:
    """Cl (sp) and Br (sp, n=4) support in the native PM6 backend: element
    blocks + anchor-calibrated pairs, oracle <-> C++ parity. Br completes
    the environment's solo-distance element set H/F/Cl/Br (reference
    molgym/environment.py:103-118; MNDO element block, Dewar & Healy 1983,
    and anchor-calibrated HBr/Br2/CH3Br pairs, experiments/pm6_anchor_fit/);
    its n=4 principal quantum number exercises the general-n STO
    overlap/multipole machinery beyond the n<=3 rows. The cases the two
    halogens share are parametrised over both."""

    @pytest.mark.parametrize('z', [17, 35])
    def test_supported(self, z):
        assert load_library().mg_nddo_supported(z) == 1

    @pytest.mark.parametrize('z,r', [(17, 1.29), (35, 1.414)])
    def test_hx_parity_and_binding(self, z, r):
        pos = [[0, 0, 0], [r, 0, 0]]
        e_cpp = _cpp_energy([z, 1], pos)
        e_py = nddo_ref.energy([z, 1], pos)
        assert e_cpp == pytest.approx(e_py, abs=2e-9)
        assert e_cpp < _cpp_energy([z], [[0, 0, 0]]) + _cpp_energy(
            [1], [[0, 0, 0]])

    def test_ch3cl_parity(self):
        pos = [[0, 0, 0], [0, 0, 1.79], [1.03, 0, -0.36],
               [-0.51, 0.89, -0.36], [-0.51, -0.89, -0.36]]
        zs = [6, 17, 1, 1, 1]
        assert _cpp_energy(zs, pos) == pytest.approx(
            nddo_ref.energy(zs, pos), abs=2e-9)

    @pytest.mark.parametrize('z', [17, 35])
    def test_atom_doublet(self, z):
        m = nddo_ref.NDDO([z], [[0, 0, 0]])
        m.scf()
        # ground state ns2 np5: one unpaired p electron
        assert m.n_alpha - m.n_beta == 1

    def test_unparameterized_pair_fallback_parity(self):
        # N-S carries no pair entry in either backend; both must use the
        # same documented (alpha=2.5, x=1.0) fallback — a mismatched x
        # (the pre-round-3 oracle used 0.5) shows up at the 0.1 Ha scale.
        # Tolerance 1e-6: the NS radical's UHF converges along slightly
        # different DIIS paths in the two implementations.
        pos = [[0, 0, 0], [1.6, 0, 0]]
        assert _cpp_energy([7, 16], pos) == pytest.approx(
            nddo_ref.energy([7, 16], pos), abs=1e-6)

    @pytest.mark.parametrize('symbol,dist', [('Cl', 1.79), ('Br', 1.93)])
    def test_reward_pipeline(self, symbol, dist):
        # the env reward path end-to-end with a halogen (PM6 backend)
        reward = InteractionReward(backend='pm6')
        atoms = Atoms(['C'], [(0.0, 0.0, 0.0)])
        new_atom = Atom(symbol, (dist, 0.0, 0.0))
        r, info = reward.calculate(atoms, new_atom)
        assert np.isfinite(r) and r > 0.0  # C-X binds

    def test_ch3br_parity_and_anchor(self):
        pos = [[0, 0, 0], [0, 0, 1.934], [1.03, 0, -0.36],
               [-0.51, 0.89, -0.36], [-0.51, -0.89, -0.36]]
        zs = [6, 35, 1, 1, 1]
        e_cpp = _cpp_energy(zs, pos)
        assert e_cpp == pytest.approx(nddo_ref.energy(zs, pos), abs=2e-9)
        # anchor: exp atomization -362.0 kcal/mol at the fitted geometry
        atoms = sum(_cpp_energy([z], [[0, 0, 0]]) for z in zs)
        kcal = (e_cpp - atoms) * 627.509474
        assert abs(kcal - (-362.0)) < 10.0, kcal

    def test_br_eht_binding(self):
        # EHT backend covers Br too (cheap-reward path)
        reward = InteractionReward(backend='eht')
        atoms = Atoms(['H'], [(0.0, 0.0, 0.0)])
        new_atom = Atom('Br', (1.41, 0.0, 0.0))
        r, info = reward.calculate(atoms, new_atom)
        assert np.isfinite(r) and r > 0.0  # H-Br binds


class TestDMultipoleRotationLeakBound:
    """The discrete point-multipole configurations for d-involving pairs are
    not exactly axially symmetric as tensors, so rotating a whole molecule
    leaks ~1e-6 Ha into the energy (sp deviations cancel exactly; see the
    TestInvariances notes). This bounds the leak on FULL SF6-episode-scale
    molecules at < 1e-5 Ha — an order of magnitude under the 1e-3 Ha
    reward-difference scale the RL policies train on, so the wart cannot
    affect learning-curve comparisons (round-3 VERDICT stretch item)."""

    def _rot(self, seed):
        rng = np.random.default_rng(seed)
        a = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(a) < 0:
            a[:, 0] *= -1
        return a

    @pytest.mark.parametrize('seed', [0, 1, 2])
    def test_sf6_full_molecule(self, seed):
        d = 1.58
        pos = np.array([[0, 0, 0], [d, 0, 0], [-d, 0, 0], [0, d, 0],
                        [0, -d, 0], [0, 0, d], [0, 0, -d]])
        syms = ['S'] + ['F'] * 6
        e0 = _cpp_energy([16] + [9] * 6, pos)
        e1 = _cpp_energy([16] + [9] * 6, pos @ self._rot(seed).T)
        assert abs(e0 - e1) < 1e-5

    def test_low_symmetry_intermediate(self):
        # a mid-episode-like SF5 fragment with no special symmetry
        pos = np.array([[0, 0, 0], [1.6, 0.1, -0.2], [-1.5, 0.2, 0.3],
                        [0.2, 1.7, 0], [0.1, -1.55, 0.25], [0, 0.2, 1.62]])
        e0 = _cpp_energy([16] + [9] * 5, pos)
        e1 = _cpp_energy([16] + [9] * 5, pos @ self._rot(7).T)
        assert abs(e0 - e1) < 1e-5


# -- the port's oracle against the JAX package's ---------------------------

def _random_clusters(seed, count, first=None):
    """test_random_molecules' generator: 2-4 atoms of H, C, N, O, F along x,
    the first atom `first` where given."""
    rng = np.random.default_rng(seed)
    clusters = []
    for _ in range(count):
        n = int(rng.integers(2, 5))
        zs = [int(rng.choice([1, 6, 7, 8, 9])) for _ in range(n)]
        if first is not None:
            zs[0] = first
        pos = rng.uniform(-1.0, 1.0, (n, 3)) * 1.4
        pos[:, 0] += np.arange(n) * 1.6
        clusters.append((zs, pos, None))
    return clusters


# (atomic numbers, positions in Angstrom, spin multiplicity; None: the
# oracle's (sum Z) % 2 + 1)
ORACLE_CASES = {
    'H atom': ([1], [[0.0, 0.0, 0.0]], 2),
    'C atom': ([6], [[0.0, 0.0, 0.0]], 1),
    'O atom': ([8], [[0.0, 0.0, 0.0]], 1),
    'H2 at 1.2 A': ([1, 1], [[0.0, 0.0, 0.0], [1.2, 0.0, 0.0]], 1),
    'H2O fixture': (H2O_ZS, H2O_POS, 1),
    **{f'HCNOF cluster {i}': c
       for i, c in enumerate(_random_clusters(2017, 6))},
    # S at seed 19 (S, C, F), where the SCF converges, so that gradients
    # over the d shell are compared too (seed 16's S, F, N does not)
    'S cluster': _random_clusters(19, 1, first=16)[0],
    'Cl cluster': _random_clusters(17, 1, first=17)[0],
}


def _gradients_or_error(module, zs, pos, multiplicity):
    try:
        return module.gradients(zs, pos, 0, multiplicity)
    except RuntimeError as exc:
        return str(exc)


@pytest.mark.parametrize('case', list(ORACLE_CASES))
def test_oracle_equals_the_jax_packages(case):
    """The same SCF outcome, energy, alpha and beta densities and
    finite-difference gradients (or the same refusal) from both copies."""
    zs, pos, multiplicity = ORACLE_CASES[case]
    ours = nddo_ref.NDDO(zs, pos, 0, multiplicity)
    ref = jax_nddo_ref.NDDO(zs, pos, 0, multiplicity)
    (e, ok), (ref_e, ref_ok) = ours.scf(), ref.scf()
    assert ok == ref_ok
    assert np.array_equal(e, ref_e, equal_nan=True)
    assert np.array_equal(ours.p_alpha, ref.p_alpha, equal_nan=True)
    assert np.array_equal(ours.p_beta, ref.p_beta, equal_nan=True)
    grad = _gradients_or_error(nddo_ref, zs, pos, multiplicity)
    ref_grad = _gradients_or_error(jax_nddo_ref, zs, pos, multiplicity)
    if isinstance(ref_grad, str):
        assert grad == ref_grad
    else:
        assert np.array_equal(grad, ref_grad)


def test_oracle_cases_reach_both_scf_outcomes_and_the_d_shell():
    """The cases above are not all easy: some SCF converges and some does
    not, and the S cluster's SCF runs over S's nine spd orbitals."""
    outcomes = {nddo_ref.NDDO(zs, pos, 0, m).scf()[1]
                for zs, pos, m in ORACLE_CASES.values()}
    assert outcomes == {True, False}
    zs, pos, m = ORACLE_CASES['S cluster']
    assert nddo_ref.NDDO(zs, pos, 0, m).sizes[0] == 9


def test_pm6_element_params_equal_the_jax_packages():
    assert list(nddo_ref.PM6_PARAMS) == list(jax_nddo_ref.PM6_PARAMS)
    for z, par in nddo_ref.PM6_PARAMS.items():
        assert dataclasses.asdict(par) == dataclasses.asdict(
            jax_nddo_ref.PM6_PARAMS[z]), z


def test_pm6_pair_params_equal_the_jax_packages():
    assert nddo_ref.PM6_PAIR_PARAMS == jax_nddo_ref.PM6_PAIR_PARAMS
    assert list(nddo_ref.PM6_PAIR_PARAMS) == list(
        jax_nddo_ref.PM6_PAIR_PARAMS)


def test_chip_smoke_golden_phase_passes_on_this_host():
    """chip_smoke.py's phase 10c on this host's build: every golden value,
    oracle and EHT reading within its gate (the card's host runs the same
    function on its own build), each reading beside its gate."""
    import json

    import chip_smoke
    result = chip_smoke.check_host_golden()
    assert [r['what'] for r in result['readings'][:4]] == [
        'H atom (multiplicity 2)', 'C atom (multiplicity 1)',
        'O atom (multiplicity 1)', 'H2 at 1.2 A']
    assert all(r['error'] <= r['gate'] for r in result['readings'])
    assert len(result['random_molecules']) == 6
    json.dumps(result)
