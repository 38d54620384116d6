"""The port's MolecularEnv against molgym_tpu's: the same element and
position inputs give the same rewards, dones and canvases through step and
reset_if_terminal. Rewards at 1e-5 relative (float32 LJ sums); everything
else exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molgym_tpu.envs import environment as jenv
from molgym_tpu.envs import reward as jreward
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu_torch.envs import environment as tenv
from molgym_tpu_torch.envs import reward as treward
from molgym_tpu_torch.spaces import ObservationSpace

ZS = [0, 1, 6, 8, 9]
CANVAS = 5
FORMULAS = np.array([[0, 2, 1, 1, 0], [0, 0, 1, 0, 2]])


def _compare_states(js, ts):
    np.testing.assert_array_equal(ts.elements.numpy(), np.asarray(js.elements))
    np.testing.assert_allclose(ts.positions.numpy(), np.asarray(js.positions),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(ts.bag.numpy(), np.asarray(js.bag))
    np.testing.assert_array_equal(ts.n_atoms.numpy(), np.asarray(js.n_atoms))
    np.testing.assert_array_equal(ts.formula_cursor.numpy(),
                                  np.asarray(js.formula_cursor))
    np.testing.assert_array_equal(ts.refill_count.numpy(),
                                  np.asarray(js.refill_count))


# a tetrahedral carbon scaffold, pre-placed on a larger canvas
SCAFFOLD = np.array([[1.2, 1.2, 1.2], [-1.2, -1.2, 1.2], [-1.2, 1.2, -1.2],
                     [1.2, -1.2, -1.2]], np.float32)


def _scaffold_kwargs(canvas):
    elements = np.zeros(canvas, np.int64)
    elements[:4] = 2
    positions = np.zeros((canvas, 3), np.float32)
    positions[:4] = SCAFFOLD
    return dict(initial_elements=elements, initial_positions=positions,
                scaffold_halfspaces=tenv.scaffold_halfspaces(SCAFFOLD),
                n_scaffold=4)


@pytest.mark.parametrize('reward,num_refills,scaffold', [
    ('lj', 0, False), ('lj', 1, False), ('morse', 0, False), ('lj', 0, True)])
def test_step_and_reset_match(reward, num_refills, scaffold):
    B, steps = 16, 12
    make_j = (jreward.make_lennard_jones_reward if reward == 'lj'
              else jreward.make_morse_reward)
    make_t = (treward.make_lennard_jones_reward if reward == 'lj'
              else treward.make_morse_reward)
    canvas = CANVAS + 4 if scaffold else CANVAS
    kwargs = _scaffold_kwargs(canvas) if scaffold else {}
    ja, jb = jenv.scaffold_halfspaces(SCAFFOLD)
    np.testing.assert_allclose(tenv.scaffold_halfspaces(SCAFFOLD)[0], ja)
    np.testing.assert_allclose(tenv.scaffold_halfspaces(SCAFFOLD)[1], jb)
    jax_env = jenv.MolecularEnv(make_j(), JaxObservationSpace(canvas, ZS),
                                FORMULAS, num_refills=num_refills, **kwargs)
    env = tenv.MolecularEnv(make_t(), ObservationSpace(canvas, ZS), FORMULAS,
                            num_refills=num_refills, device='cpu', **kwargs)
    js = jax_env.init_states(jax.random.PRNGKey(0), B)
    ts = env.init_states(B)
    _compare_states(js, ts)

    rng = np.random.RandomState(num_refills + len(reward))
    for _ in range(steps):
        # mostly atoms of the bag, some stop actions, some bag misses
        elem = rng.choice(len(ZS), size=B, p=[0.1, 0.3, 0.2, 0.2, 0.2])
        pos = (rng.randn(B, 3) * (0.6 if scaffold else 1.3)).astype(np.float32)
        jr = jax_env.step(js, jnp.asarray(elem, jnp.int32), jnp.asarray(pos))
        tr = env.step(ts, torch.from_numpy(elem), torch.from_numpy(pos))
        np.testing.assert_allclose(tr.reward.numpy(), np.asarray(jr.reward),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tr.done.numpy(), np.asarray(jr.done))
        _compare_states(jr.state, tr.state)
        js, _ = jax_env.reset_if_terminal(jr.state, jr.done)
        ts, tobs = env.reset_if_terminal(tr.state, tr.done)
        _compare_states(js, ts)
        np.testing.assert_array_equal(tobs.elements.numpy(),
                                      np.asarray(js.elements))


def test_is_valid_rules_match():
    """Validity alone, on canvases with atoms: min distance, solo atoms near
    a heavy atom, bag membership and a full canvas."""
    jax_env = jenv.MolecularEnv(jreward.make_lennard_jones_reward(),
                                JaxObservationSpace(CANVAS, ZS), FORMULAS)
    env = tenv.MolecularEnv(treward.make_lennard_jones_reward(),
                            ObservationSpace(CANVAS, ZS), FORMULAS,
                            device='cpu')
    rng = np.random.RandomState(5)
    B = 64
    n_atoms = rng.randint(0, CANVAS + 1, size=B)
    elements = np.zeros((B, CANVAS), np.int64)
    positions = np.zeros((B, CANVAS, 3), np.float32)
    for b in range(B):
        elements[b, :n_atoms[b]] = rng.randint(1, len(ZS), size=n_atoms[b])
        positions[b, :n_atoms[b]] = rng.randn(n_atoms[b], 3)
    bag = rng.randint(0, 2, size=(B, len(ZS)))
    new_pos = (rng.randn(B, 3) * 1.5).astype(np.float32)
    elem = rng.randint(1, len(ZS), size=B)
    zero = np.zeros(B, np.int64)
    ts = tenv.EnvState(*(torch.from_numpy(x) for x in (
        elements, positions, bag, n_atoms, zero, zero)))
    js = jenv.EnvState(elements=jnp.asarray(elements, jnp.int32),
                       positions=jnp.asarray(positions),
                       bag=jnp.asarray(bag, jnp.int32),
                       n_atoms=jnp.asarray(n_atoms, jnp.int32),
                       formula_cursor=jnp.zeros(B, jnp.int32),
                       refill_count=jnp.zeros(B, jnp.int32),
                       rng=jax.random.split(jax.random.PRNGKey(0), B))
    jvalid = jax.vmap(jax_env._is_valid)(js, jnp.asarray(new_pos),
                                         jnp.asarray(elem, jnp.int32))
    tvalid = env._is_valid(ts, torch.from_numpy(new_pos), torch.from_numpy(elem))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert 0 < int(tvalid.sum()) < B
