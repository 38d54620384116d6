"""The port's z-matrix geometry (molgym_tpu_torch/ops/zmat.py) against
molgym_tpu/ops/zmat.py on the CPU: the distance, angle and dihedral
helpers, position_point, and position_atom batched over B against the JAX
function vmapped, for canvases of 0, 1, 2 and more atoms, for the
octahedral SF6 canvas, whose equidistant atoms tie in the sort of the
distances to the focus, and for a canvas of 25 whose 24 atoms past the
focus all tie (an unstable sort takes other reference atoms: the CPU's
does so above 16 entries).

Tolerance: 1e-4 relative and absolute in float32 (the functions are a few
dozen float32 operations; both packages differ by some ulps)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molgym_tpu.ops import zmat as jzmat
from molgym_tpu_torch.ops import zmat

TOL = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.fixture(scope='module')
def points():
    rng = np.random.RandomState(0)
    return [rng.randn(16, 3).astype(np.float32) for _ in range(4)]


def test_distance_angle_dihedral_match(points):
    p = points
    _close(zmat.get_distance(_t(p[0]), _t(p[1])),
           jzmat.get_distance(jnp.asarray(p[0]), jnp.asarray(p[1])))
    _close(zmat.get_angle(*map(_t, p[:3])),
           jzmat.get_angle(*map(jnp.asarray, p[:3])))
    _close(zmat.get_dihedral(*map(_t, p)),
           jzmat.get_dihedral(*map(jnp.asarray, p)))


def test_dihedral_sign_convention():
    """A right-handed quarter turn, and its mirror image: the JAX
    package's signs, which are the reference's."""
    p = [np.array(x, np.float32) for x in
         ([1, 0, 0], [0, 0, 0], [0, 0, 1], [0, 1, 1])]
    mirror = p[:3] + [np.array([0, -1, 1], np.float32)]
    for quad in (p, mirror):
        got = float(zmat.get_dihedral(*map(_t, quad)))
        ref = float(jzmat.get_dihedral(*map(jnp.asarray, quad)))
        assert abs(got - ref) <= TOL and abs(abs(got) - np.pi / 2) <= TOL


def test_position_point_round_trips(points):
    """The point placed from (distance, angle, dihedral) has them, and
    equals the JAX placement."""
    p0, p1, p2 = map(_t, points[:3])
    rng = np.random.RandomState(1)
    d = rng.uniform(0.8, 2.0, 16).astype(np.float32)
    a = rng.uniform(0.3, 2.8, 16).astype(np.float32)
    h = rng.uniform(-3.0, 3.0, 16).astype(np.float32)
    got = zmat.position_point(p0, p1, p2, _t(d), _t(a), _t(h))
    _close(got, jzmat.position_point(*map(jnp.asarray, points[:3]), d, a, h))
    _close(zmat.get_distance(got, p2), d)
    _close(zmat.get_angle(got, p2, p1), a)


def _jax_position_atom(positions, n_atoms, focus, d, a, h):
    return jax.vmap(jzmat.position_atom)(
        jnp.asarray(positions), jnp.asarray(n_atoms), jnp.asarray(focus),
        jnp.asarray(d), jnp.asarray(a), jnp.asarray(h))


def _torch_position_atom(positions, n_atoms, focus, d, a, h):
    return zmat.position_atom(_t(positions), _t(n_atoms).long(),
                              _t(focus).long(), _t(d), _t(a), _t(h))


@pytest.mark.parametrize('canvas', [1, 2, 3, 7])
def test_position_atom_matches_for_every_atom_count(canvas):
    """Every count from 0 atoms to a full canvas, with padding slots that
    hold garbage positions (they must not be taken as references)."""
    rng = np.random.RandomState(canvas)
    batch = 4 * (canvas + 1)
    n_atoms = np.arange(batch) % (canvas + 1)
    positions = (rng.randn(batch, canvas, 3) * 1.3).astype(np.float32)
    focus = (rng.randint(0, canvas, batch) % np.maximum(n_atoms, 1)).astype(
        np.int64)
    d = rng.uniform(0.8, 2.0, batch).astype(np.float32)
    a = rng.uniform(0.3, 2.8, batch).astype(np.float32)
    h = rng.uniform(-3.0, 3.0, batch).astype(np.float32)
    got = _torch_position_atom(positions, n_atoms, focus, d, a, h)
    _close(got, _jax_position_atom(positions, n_atoms, focus, d, a, h))
    # the empty canvas places at the origin
    assert not got[n_atoms == 0].any()
    # a new atom is `distance` from the focus's nearest atom: the focus
    nonempty = n_atoms > 0
    focus_pos = positions[np.arange(batch), focus]
    _close(zmat.get_distance(got[nonempty], _t(focus_pos[nonempty])),
           d[nonempty])


@pytest.mark.parametrize('canvas', [7, 25])
def test_position_atom_ties_follow_the_stable_order(canvas):
    """The SF6 octahedron (S at the origin, six F at 1.56 A on the axes),
    each F focused in turn, on SF6's canvas and on the CLI's default canvas
    of 25 (its padded slots tie too; above 16 entries the CPU's unstable
    sort reorders ties): the four equatorial F tie in distance, so the
    third reference atom is the tie's first slot. The placements match
    JAX's, and differ from those with another of the tied atoms as p0."""
    r = 1.56
    octahedron = np.array([[0, 0, 0], [r, 0, 0], [-r, 0, 0], [0, r, 0],
                           [0, -r, 0], [0, 0, r], [0, 0, -r]], np.float32)
    batch = 6
    positions = np.zeros((batch, canvas, 3), np.float32)
    positions[:, :7] = octahedron
    n_atoms = np.full(batch, 7)
    focus = np.arange(1, 7)
    d = np.full(batch, 1.56, np.float32)
    a = np.full(batch, 1.2, np.float32)
    h = np.full(batch, 0.7, np.float32)
    got = _torch_position_atom(positions, n_atoms, focus, d, a, h)
    _close(got, _jax_position_atom(positions, n_atoms, focus, d, a, h))

    # the stable order: focus (itself, 0 A), S (1.56 A), then the first
    # of the four equatorial F at 2.21 A by slot
    for b, f in enumerate(focus):
        dists = np.linalg.norm(octahedron - octahedron[f], axis=-1)
        tied = np.flatnonzero(np.isclose(dists, r * np.sqrt(2)))
        assert len(tied) == 4
        want = zmat.position_point(
            _t(octahedron[tied[0]]), _t(octahedron[0]), _t(octahedron[f]),
            _t(d[b]), _t(a[b]), _t(h[b]))
        other = zmat.position_point(
            _t(octahedron[tied[1]]), _t(octahedron[0]), _t(octahedron[f]),
            _t(d[b]), _t(a[b]), _t(h[b]))
        _close(got[b], want.numpy())
        assert float((other - got[b]).abs().max()) > 0.1


def test_position_atom_ties_on_a_full_shell():
    """A canvas of 25: the focus at the origin and 24 atoms at exactly 3 A
    from it (the signed permutations of (1, 2, 2)). Every reference atom
    past the focus is a tie, and at 25 entries the CPU's unstable sort
    reorders ties: the placement matches JAX's only in the stable order."""
    shell = {(sx * a, sy * b, sz * c)
             for a, b, c in ((1, 2, 2), (2, 1, 2), (2, 2, 1))
             for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)}
    canvas = np.concatenate([np.zeros((1, 3)), sorted(shell)]).astype(np.float32)
    assert canvas.shape == (25, 3)
    positions = canvas[None].repeat(3, axis=0)
    n_atoms = np.full(3, 25)
    focus = np.zeros(3, np.int64)
    d = np.array([1.0, 1.5, 2.0], np.float32)
    a = np.array([0.9, 1.9, 2.5], np.float32)
    h = np.array([-2.0, 0.3, 1.1], np.float32)
    got = _torch_position_atom(positions, n_atoms, focus, d, a, h)
    _close(got, _jax_position_atom(positions, n_atoms, focus, d, a, h))
    want = zmat.position_point(_t(canvas[2]), _t(canvas[1]), _t(canvas[0]),
                               _t(d), _t(a), _t(h))
    _close(got, want.numpy())
