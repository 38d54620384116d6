"""Rotation equivariance of the port's covariant agent, as
tests/covariant/test_covariant_agent.py holds the JAX agent's: rotating a
molecule rotates the coefficients of the placement density by the
rotation's Wigner-D matrices (within 1e-5 in float32, the JAX test's
tolerance), leaves their AtomicScalars invariants as they were (1e-5), and
leaves the extrema of the log-density over a fine grid where they were
(5e-3, the grid's resolution). On the CPU the agent's kernels run as their
plain versions; the `cuda` test runs the same check on the card, through
the kernels, at the JAX test's configuration and at the SF6 agent's full
width (chip_smoke.py's phase 12 runs the second)."""
import numpy as np
import pytest
import torch

from molgym_tpu_torch.agents.covariant import CovariantAC
from molgym_tpu_torch.distributions import spherical
from molgym_tpu_torch.equivariance import (COVARIANCE_AGENT,
                                           COVARIANCE_FORMULA, MOLECULES,
                                           SF6_AGENT, SF6_FORMULA,
                                           SF6_MOLECULES, covariance_errors,
                                           rotated, so3_coefficients)
from molgym_tpu_torch.ops.so3 import (apply_wigner, gen_rot,
                                      generate_fibonacci_grid)
from molgym_tpu_torch.spaces import ObservationSpace

TOL = 1e-5
MAXL = COVARIANCE_AGENT['maxl']


def make(cfg, device, seed=0):
    torch.manual_seed(seed)
    return (CovariantAC(**cfg, device=device),
            ObservationSpace(cfg['canvas_size'], list(cfg['zs'])))


@pytest.fixture(scope='module')
def small():
    return make(COVARIANCE_AGENT, 'cpu')


@pytest.mark.parametrize('seed', [0, 1])
def test_alms_transform_covariantly(small, seed):
    agent, space = small
    errors = covariance_errors(agent, space, MOLECULES, COVARIANCE_FORMULA,
                               seed=seed)
    assert [e['molecule'] for e in errors] == ['H2O', 'CH3', 'CH4']
    for e in errors:
        assert e['covariance'] < TOL, e
        assert e['invariance'] < TOL, e


def test_log_prob_extrema_rotation_invariant(small):
    agent, space = small
    pts = torch.from_numpy(
        generate_fibonacci_grid(20000).astype(np.float32))[:, None, :]
    rng = np.random.RandomState(1)
    for atoms in MOLECULES:
        _ds, rot, _ = gen_rot(MAXL, rng)
        lps = []
        for canvas in (atoms, rotated(atoms, rot)):
            obs = space.build(canvas, COVARIANCE_FORMULA).map(
                lambda x: x[None])
            gen = torch.Generator().manual_seed(1)
            with torch.no_grad():
                _out, dists = agent.act_with_dists(obs, gen, False)
                lps.append(spherical.log_prob(dists['so3_dist'], pts).numpy())
        np.testing.assert_allclose(lps[0].max(0), lps[1].max(0), atol=5e-3)
        np.testing.assert_allclose(lps[0].min(0), lps[1].min(0), atol=5e-3)


def test_a_non_rotation_is_caught(small):
    """The check has teeth: under -R (R composed with the inversion, not a
    rotation) the coefficients of CH4 are not D(R) of the original's."""
    agent, space = small
    coeffs = so3_coefficients(agent, space, MOLECULES[2], COVARIANCE_FORMULA)
    ds, rot, _ = gen_rot(MAXL, np.random.RandomState(0))
    other = so3_coefficients(agent, space, rotated(MOLECULES[2], -rot),
                             COVARIANCE_FORMULA)
    err = max(float((g - w).abs().max())
              for g, w in zip(other, apply_wigner(coeffs, ds)))
    assert err > 100 * TOL


@pytest.mark.cuda
@pytest.mark.parametrize('cfg', ['small', 'sf6'])
def test_agent_is_covariant_on_the_card(cfg):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    config, molecules, formula = {
        'small': (COVARIANCE_AGENT, MOLECULES, COVARIANCE_FORMULA),
        'sf6': (SF6_AGENT, SF6_MOLECULES, SF6_FORMULA)}[cfg]
    agent, space = make(config, 'cuda')
    for seed in (0, 1):
        for e in covariance_errors(agent, space, molecules, formula,
                                   seed=seed):
            assert e['covariance'] < TOL, e
            assert e['invariance'] < TOL, e
