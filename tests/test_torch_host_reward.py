"""The port's host reward layer against molgym_tpu's, on the CPU: the native
library (built by the port from molgym_tpu_torch/csrc/host/ into
molgym_tpu_torch/_build), its single-molecule calculator, the reward
classes, the device solvation penalty, the minimizer, and the env's
host-reward step.

Two builds from two source trees are compared. The JAX package's bindings
run here over a library that the test compiles itself
(`jax_library_built_from_csrc`), from a copy of the repository's csrc/
sources with csrc/Makefile's flags: their own loader would run `make -C
csrc`, which rewrites the tracked csrc/libmolgym_host.so, and no test of
the port may write there. The port's library comes from its own copies of
those sources. Each module loads a copy of the test's build as a library
of its own, with its own energy cache and thread pool, so neither package
reads the other's results. Both compile the same code with the same flags,
so batched rewards, energies and gradients agree within 1e-10 relative,
and minimized positions within 1e-6 Angstrom. float32 rewards of the env
step agree within 1e-6 relative (one float32 rounding of equal float64
values). The PM6 geometries are near equilibrium, away from the
near-degenerate clusters on which an SCF may land in another UHF basin
(PARITY.md)."""
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molgym_tpu.atoms import Atom as JaxAtom
from molgym_tpu.atoms import Atoms as JaxAtoms
from molgym_tpu.calculators import native as jnative
from molgym_tpu.calculators import reward_host as jreward_host
from molgym_tpu.envs import environment as jenv
from molgym_tpu.envs import reward as jreward
from molgym_tpu.minimizer import minimize as jax_minimize
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu_torch import host_build
from molgym_tpu_torch.atoms import Atom, Atoms
from molgym_tpu_torch.calculators import native, reward_host
from molgym_tpu_torch.envs import environment as tenv
from molgym_tpu_torch.envs import reward as treward
from molgym_tpu_torch.minimizer import minimize
from molgym_tpu_torch.spaces import ObservationSpace

RTOL = 1e-10
METHODS = ('lj', 'morse', 'eht', 'pm6')


CSRC = Path(__file__).resolve().parents[1] / 'csrc'
# csrc/Makefile's CXXFLAGS and its -shared, and <cstdio> included first:
# csrc/nddo.cpp calls std::fprintf without including it, which newer
# libstdc++ headers no longer bring in by the way
JAX_CXXFLAGS = ('-O3', '-march=native', '-fPIC', '-std=c++17', '-Wall',
                '-pthread', '-shared', '-include', 'cstdio')


def build_jax_library(tmp_path_factory) -> Path:
    """The JAX package's library, compiled once a session from a copy of
    csrc/'s three sources into the session's temporary directory."""
    src = tmp_path_factory.getbasetemp() / 'jax_csrc'
    lib = src / 'libmolgym_host.so'
    if not lib.exists():
        src.mkdir(exist_ok=True)
        for name in host_build.SOURCES:
            shutil.copy2(CSRC / name, src / name)
        tmp = src / 'libmolgym_host.so.tmp'
        subprocess.run([os.environ.get('CXX', 'g++'), *JAX_CXXFLAGS, '-o',
                        str(tmp), *(str(src / n) for n in host_build.SOURCES)],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
    return lib


@pytest.fixture(scope='module', autouse=True)
def jax_library_built_from_csrc(tmp_path_factory):
    """molgym_tpu.calculators.native's library, for the tests of a module,
    loaded by its own `load_library` (its signatures) from a copy of the
    test's build of csrc/ in a directory without a Makefile, so that it
    builds nothing; the module's previous library is restored after."""
    copy = tmp_path_factory.mktemp('jax_native') / 'libmolgym_host.so'
    shutil.copy(build_jax_library(tmp_path_factory), copy)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jnative, '_lib', None)
        patch.setattr(jnative, '_CSRC_DIR', str(copy.parent))
        patch.setattr(jnative, '_LIB_PATH', str(copy))
        jnative.load_library()
        yield


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one intra-op thread: the suite runs six workers on the
    host's cores, and torch's thread pool then waits at its barriers for
    threads the other workers hold (a transport test took 9 s instead of
    0.5 s under such load, 1.1 s on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# canvases of at most 3 atoms and a new atom each, near equilibrium:
# O-H + H (water), C=O + H (formyl), N-H2 + H (ammonia), H + H, nothing + O,
# and an entry that is not valid (reward 0)
PM6_BATCH = dict(
    zs=np.array([[8, 1, 0], [6, 8, 0], [7, 1, 1], [1, 0, 0], [0, 0, 0],
                 [8, 1, 0]], np.int32),
    positions=np.array([
        [[0, 0, 0], [0.96, 0, 0], [0, 0, 0]],
        [[0, 0, 0], [1.20, 0, 0], [0, 0, 0]],
        [[0, 0, 0], [1.01, 0, 0], [-0.34, 0.95, 0]],
        [[0, 0, 0], [0, 0, 0], [0, 0, 0]],
        [[0, 0, 0], [0, 0, 0], [0, 0, 0]],
        [[0, 0, 0], [0.96, 0, 0], [0, 0, 0]]], np.float64),
    n_atoms=np.array([2, 2, 3, 1, 0, 2], np.int32),
    new_z=np.array([1, 1, 1, 1, 8, 1], np.int32),
    new_pos=np.array([[-0.24, 0.93, 0], [-0.55, 0.95, 0],
                      [-0.34, -0.48, 0.82], [0.74, 0, 0], [0, 0, 0],
                      [-0.24, 0.93, 0]], np.float64),
    valid=np.array([1, 1, 1, 1, 1, 0], np.uint8))

H2O_POS = np.array([[-0.27939703, 0.83823215, 0.00973345],
                    [-0.52040310, 1.77677325, 0.21391146],
                    [0.54473632, 0.90669722, -0.53501306]])


def _random_batch(seed, b=12, n=4):
    """Random canvases of H, C, O for the pair potentials and EHT (no SCF)."""
    rng = np.random.RandomState(seed)
    n_atoms = rng.randint(0, n + 1, size=b).astype(np.int32)
    zs = np.zeros((b, n), np.int32)
    for i in range(b):
        zs[i, :n_atoms[i]] = rng.choice([1, 6, 8], size=n_atoms[i])
    return dict(zs=zs, positions=rng.randn(b, n, 3) * 1.5,
                n_atoms=n_atoms, new_z=rng.choice([1, 6, 8], size=b).astype(
                    np.int32), new_pos=rng.randn(b, 3) * 1.5,
                valid=(rng.rand(b) > 0.2).astype(np.uint8))


@pytest.mark.parametrize('method', METHODS)
def test_batch_rewards_match_jax(method):
    batch = PM6_BATCH if method == 'pm6' else _random_batch(len(method))
    ours = native.NativeBatchCalculator(native.METHODS[method])
    ref = jnative.NativeBatchCalculator(
        {'lj': jnative.METHOD_LJ, 'morse': jnative.METHOD_MORSE,
         'eht': jnative.METHOD_EHT, 'pm6': jnative.METHOD_PM6}[method])
    got = ours.batch_reward(**batch)
    want = ref.batch_reward(**batch)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)
    assert (got[batch['valid'] == 0] == 0).all()
    assert np.isfinite(got).all() and (got != 0).any()
    evals, batches = ours.pool_stats()
    assert evals >= 3 and batches >= 1


@pytest.mark.parametrize('method', METHODS)
def test_native_calc_energy_and_gradients_match_jax(method):
    ours, ref = native.NativeCalc(method), jnative.NativeCalc(method)
    for calc in (ours, ref):
        calc.set_elements(['O', 'H', 'H'])
        calc.set_positions(H2O_POS)
        calc.set_settings({'molecular_charge': 0, 'spin_multiplicity': 1})
    e, g = ours.calculate_energy(), ours.calculate_gradients()
    assert e == pytest.approx(ref.calculate_energy(), rel=RTOL, abs=1e-14)
    np.testing.assert_allclose(g, ref.calculate_gradients(), rtol=RTOL,
                               atol=1e-12)
    assert g.shape == (3, 3) and np.isfinite(g).all()


def test_pm6_gradient_matches_finite_difference():
    """mg_nddo_gradients (Hartree/bohr, frozen-density differences) against
    central differences of SCF energies, 1e-4 Angstrom apart."""
    calc = native.NativeCalc('PM6')
    calc.set_elements(['O', 'H', 'H'])
    calc.set_settings({'spin_multiplicity': 1})
    calc.set_positions(H2O_POS)
    grad = calc.calculate_gradients()
    h, bohr_per_angstrom = 1e-4, 1.0 / 0.52917721092
    fd = np.zeros_like(grad)
    for i in range(3):
        for c in range(3):
            pos = H2O_POS.copy()
            pos[i, c] += h
            calc.set_positions(pos)
            e_plus = calc.calculate_energy()
            pos[i, c] -= 2 * h
            calc.set_positions(pos)
            fd[i, c] = (e_plus - calc.calculate_energy()) / (
                2 * h * bohr_per_angstrom)
    np.testing.assert_allclose(grad, fd, atol=2e-6)


def test_orbitals_and_density_match_jax():
    eps, n_elec = native.eht_orbital_energies([8, 1, 1], H2O_POS)
    ref_eps, ref_n = jnative.eht_orbital_energies([8, 1, 1], H2O_POS)
    assert n_elec == ref_n == 8
    np.testing.assert_allclose(eps, ref_eps, rtol=RTOL)
    e, pa, pb = native.nddo_scf_density([8, 1, 1], H2O_POS)
    ref_e, ref_pa, ref_pb = jnative.nddo_scf_density([8, 1, 1], H2O_POS)
    assert e == pytest.approx(ref_e, rel=RTOL)
    np.testing.assert_allclose(pa, ref_pa, atol=1e-10)
    np.testing.assert_allclose(pb, ref_pb, atol=1e-10)


# -- the build --------------------------------------------------------------

def _copy_sources(dst: Path) -> Path:
    dst.mkdir()
    for name in host_build.SOURCES:
        shutil.copy2(host_build.CSRC / name, dst / name)
    return dst


def _snapshot(directory: Path):
    return {p.name: (p.read_bytes(), p.stat().st_mtime_ns)
            for p in sorted(directory.iterdir())}


def test_build_writes_only_into_its_build_dir(tmp_path):
    """A build from a copy of the port's csrc/host/ leaves every file of
    the copy as it was and writes one library into the build directory;
    the port's default build directory is _build/."""
    assert host_build.library_path().parent == (
        Path(host_build.__file__).parent / '_build')
    src = _copy_sources(tmp_path / 'csrc')
    before = _snapshot(src)
    lib = host_build.build(src, tmp_path / 'build')
    assert _snapshot(src) == before
    assert [p.name for p in (tmp_path / 'build').iterdir()] == [lib.name]
    assert lib == host_build.library_path(src, tmp_path / 'build')
    assert host_build.build(src, tmp_path / 'build') == lib   # current: kept


def test_failed_build_raises(tmp_path, monkeypatch):
    src = _copy_sources(tmp_path / 'csrc')
    monkeypatch.setenv('CXX', 'false')
    with pytest.raises(RuntimeError, match='host library build failed'):
        host_build.build(src, tmp_path / 'build')
    assert not any((tmp_path / 'build').iterdir())   # nothing to load


def test_library_hash_covers_flags_and_cpu(monkeypatch):
    base = host_build.library_path()
    monkeypatch.setattr(host_build, 'CXXFLAGS', host_build.CXXFLAGS + ('-g', ))
    flags = host_build.library_path()
    monkeypatch.undo()
    monkeypatch.setattr(host_build, 'cpu_key', lambda: 'another cpu')
    cpu = host_build.library_path()
    assert len({base, flags, cpu}) == 3
    assert cpu.parent == flags.parent == base.parent


# -- rewards ----------------------------------------------------------------

@pytest.mark.parametrize('backend', METHODS)
def test_reward_classes_match_jax(backend):
    canvas = [('O', (0, 0, 0)), ('H', (0.96, 0, 0))]
    new = ('H', (-0.24, 0.93, 0.0))
    atoms = Atoms([s for s, _ in canvas], [p for _, p in canvas])
    jatoms = JaxAtoms([s for s, _ in canvas], [p for _, p in canvas])
    for ours, ref in (
            (reward_host.InteractionReward(backend=backend),
             jreward_host.InteractionReward(backend=backend)),
            (reward_host.SolvationReward(distance_penalty=0.02,
                                         backend=backend),
             jreward_host.SolvationReward(distance_penalty=0.02,
                                          backend=backend))):
        for a, ja in ((atoms, jatoms), (Atoms(), JaxAtoms())):
            r, info = ours.calculate(a, Atom(*new))
            want, _ = ref.calculate(ja, JaxAtom(*new))
            assert r == pytest.approx(want, rel=RTOL, abs=1e-14)
            assert info['elapsed_time'] >= 0
    assert ours.get_minimum_spin_multiplicity(atoms) == \
        ref.get_minimum_spin_multiplicity(jatoms) == 2
    assert treward.get_minimum_spin_multiplicity([8, 1, 1]) == \
        jreward.get_minimum_spin_multiplicity([8, 1, 1]) == 1


def test_sparrow_backend_raises_through_its_gate():
    from molgym_tpu_torch.calculators import sparrow
    assert not sparrow.SPARROW_AVAILABLE and sparrow.Sparrow is None
    with pytest.raises(RuntimeError, match='scine_sparrow'):
        reward_host.InteractionReward(backend='sparrow')
    with pytest.raises(RuntimeError, match='scine_sparrow'):
        sparrow.SparrowBatchCalculator()


def test_make_host_reward_and_solvation_penalty_match_jax():
    """The host RewardFn (float32 on the inputs' device) with and without a
    distance penalty, and the device penalty around the device LJ."""
    rng = np.random.RandomState(3)
    b, n = 8, 4
    zs = np.where(rng.rand(b, n) < 0.6, rng.choice([1, 8], (b, n)), 0)
    positions = (rng.randn(b, n, 3) * 1.5).astype(np.float32)
    new_pos = (rng.randn(b, 3) * 1.5).astype(np.float32)
    new_z = rng.choice([1, 8], b)
    valid = rng.rand(b) > 0.25
    args_t = (torch.from_numpy(positions), torch.from_numpy(zs),
              torch.from_numpy(new_pos), torch.from_numpy(new_z),
              torch.from_numpy(valid))
    args_j = (jnp.asarray(positions), jnp.asarray(zs, jnp.int32),
              jnp.asarray(new_pos), jnp.asarray(new_z, jnp.int32),
              jnp.asarray(valid))
    calc = native.NativeBatchCalculator(native.METHOD_LJ)
    jcalc = jnative.NativeBatchCalculator(jnative.METHOD_LJ)
    for penalty in (0.0, 0.05):
        got = reward_host.make_host_reward(calc, penalty)(*args_t)
        want = jreward_host.make_host_reward(jcalc, penalty)(*args_j)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    got = treward.with_solvation_penalty(
        treward.make_lennard_jones_reward(), 0.05)(*args_t)
    want = jreward.with_solvation_penalty(
        jreward.make_lennard_jones_reward(), 0.05)(*args_j)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    timed = reward_host.TimedBatchCalculator(calc)
    reward_host.make_host_reward(timed)(*args_t)
    assert timed.total_calls == 1 and timed.total_time > 0
    assert timed.pool_stats() == calc.pool_stats()


@pytest.mark.parametrize('backend', ['device_lj', 'lj', 'pm6'])
def test_driver_reward_fn_matches_jax(backend):
    """tools.driver.make_reward_fn: the reward function and the host
    calculator (a timed one for a host reward), as the JAX driver's
    without its solvation penalty."""
    from molgym_tpu.tools.driver import make_reward_fn as jax_make_reward_fn
    from molgym_tpu_torch.tools.driver import make_reward_fn
    config = {'reward': backend, 'distance_penalty': 0.02}
    positions = np.zeros((2, 3, 3), np.float32)
    positions[:, 1] = [0.96, 0, 0]
    zs = np.array([[8, 1, 0], [8, 1, 0]])
    new_pos = np.array([[-0.24, 0.93, 0], [0.2, -1.1, 0.3]], np.float32)
    new_z, valid = np.array([1, 1]), np.array([True, True])
    fn, calc = make_reward_fn(config)
    jfn, jcalc, jpenalty = jax_make_reward_fn(config)
    assert jpenalty == 0.0
    assert (calc is None) == (jcalc is None) == backend.startswith('device')
    if calc is not None:
        assert isinstance(calc, reward_host.TimedBatchCalculator)
    got = fn(torch.from_numpy(positions), torch.from_numpy(zs),
             torch.from_numpy(new_pos), torch.from_numpy(new_z),
             torch.from_numpy(valid))
    want = jfn(jnp.asarray(positions), jnp.asarray(zs, jnp.int32),
               jnp.asarray(new_pos), jnp.asarray(new_z, jnp.int32),
               jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -- minimizer --------------------------------------------------------------

@pytest.mark.parametrize('method,fixed', [('LJ', None), ('PM6', None),
                                          ('PM6', [0])])
def test_minimize_matches_jax(method, fixed):
    start = H2O_POS + np.array([[0, 0, 0], [0.1, -0.05, 0], [0, 0.08, 0.05]])
    got, ok = minimize(native.NativeCalc(method),
                       Atoms(['O', 'H', 'H'], start), fixed_indices=fixed)
    want, jok = jax_minimize(jnative.NativeCalc(method),
                             JaxAtoms(['O', 'H', 'H'], start),
                             fixed_indices=fixed)
    assert ok == jok
    np.testing.assert_allclose(got.positions, want.positions, rtol=0,
                               atol=1e-6)
    assert np.abs(got.positions - start).max() > 1e-3   # it moved
    if fixed:
        np.testing.assert_array_equal(got.positions[0], start[0])


# -- the env's host-reward step ----------------------------------------------

ZS = [0, 1, 6, 8]


def _scripted_actions(b):
    """Per step: elements and positions that grow water, hydroxyl and H2
    near equilibrium on the canvases of the envs, in turns."""
    water = [(3, (0, 0, 0)), (1, (0.96, 0, 0)), (1, (-0.24, 0.93, 0))]
    hydrogen = [(1, (0, 0, 0)), (1, (0.74, 0, 0)), (0, (0, 0, 0))]
    formyl = [(2, (0, 0, 0)), (3, (1.2, 0, 0)), (1, (-0.55, 0.95, 0))]
    plans = [water, hydrogen, formyl]
    for t in range(3):
        elem = np.array([plans[i % 3][t][0] for i in range(b)])
        pos = np.array([plans[i % 3][t][1] for i in range(b)], np.float32)
        yield elem, pos


def _random_actions(b, steps, seed):
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        yield (rng.choice(len(ZS), size=b, p=[0.1, 0.4, 0.2, 0.3]),
               (rng.randn(b, 3) * 1.3).astype(np.float32))


@pytest.mark.parametrize('method', METHODS)
def test_host_reward_step_matches_jax(method):
    """reward_inputs -> make_host_reward -> finalize_step of the port's env
    against the JAX env's step with its io_callback host reward, from the
    same states and actions."""
    b = 6
    formulas = np.array([[0, 2, 1, 1]])
    calc = native.NativeBatchCalculator(native.METHODS[method])
    jcalc = jnative.NativeBatchCalculator(calc.method)
    jax_env = jenv.MolecularEnv(jreward_host.make_host_reward(jcalc),
                                JaxObservationSpace(4, ZS), formulas)
    env = tenv.MolecularEnv(reward_host.make_host_reward(calc),
                            ObservationSpace(4, ZS), formulas, device='cpu')
    js = jax_env.init_states(jax.random.PRNGKey(0), b)
    ts = env.init_states(b)
    actions = (_scripted_actions(b) if method == 'pm6'
               else _random_actions(b, 8, len(method)))
    placed = 0
    for elem, pos in actions:
        jr = jax_env.step(js, jnp.asarray(elem, jnp.int32), jnp.asarray(pos))
        elem_t, pos_t = torch.from_numpy(elem), torch.from_numpy(pos)
        stop, valid, needs, zs_atomic, new_z = env.reward_inputs(ts, elem_t,
                                                                 pos_t)
        raw = env.reward_fn(ts.positions, zs_atomic, pos_t, new_z, needs)
        tr = env.finalize_step(ts, elem_t, pos_t, stop, valid, raw)
        np.testing.assert_allclose(tr.reward.numpy(), np.asarray(jr.reward),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        np.testing.assert_array_equal(tr.state.elements.numpy(),
                                      np.asarray(jr.state.elements))
        placed += int(needs.sum())
        js, _ = jax_env.reset_if_terminal(jr.state, jr.done)
        ts, _ = env.reset_if_terminal(tr.state, tr.done)
    assert placed >= b
