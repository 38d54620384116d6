"""The port's VecEnv against molgym_tpu's on the CPU: the same action
sequences give the same observations, rewards and dones, step for step,
in the scenarios of tests/test_environment.py (a fresh bag, a first atom
alone, a bag emptied, the stop action, atoms too close, H and the halogens
too far from a heavy atom, an element the bag lacks) and through
step_async/step_wait and reset_if_terminal. Rewards to 1e-6 (float32 LJ,
another summation order); everything else exactly."""
import numpy as np
import pytest
import torch

from molgym_tpu.envs.environment import MolecularEnv as JaxMolecularEnv
from molgym_tpu.envs.reward import make_lennard_jones_reward as jax_lj
from molgym_tpu.envs.vec_env import VecEnv as JaxVecEnv
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu_torch.envs.environment import MolecularEnv
from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
from molgym_tpu_torch.envs.vec_env import VecEnv
from molgym_tpu_torch.formula import string_to_formula
from molgym_tpu_torch.spaces import ObservationSpace

O, H, CL = 2, 1, 2   # element indices of the scenarios' spaces


def _pos(*xs):
    return np.array([[x, 0.0, 0.0] for x in xs], np.float32)


# (formula, zs, canvas, env kwargs, [(elements, x positions), ...])
SCENARIOS = {
    'first_atom_alone': ('H2O', (0, 1, 8), 5, {}, [([O], [0.0])]),
    'bag_emptied': ('H2O', (0, 1, 8), 5, {},
                    [([O], [0.0]), ([H], [0.96]), ([H], [-0.96])]),
    'stop': ('H2O', (0, 1, 8), 5, {}, [([0], [0.0])]),
    'too_close': ('H2O', (0, 1, 8), 5, {}, [([O], [0.0]), ([H], [0.1])]),
    'solo_too_far': ('H2O', (0, 1, 8), 5, dict(max_solo_distance=2.0),
                     [([O], [0.0]), ([H], [3.0])]),
    'chlorine': ('CCl2', (0, 6, 17), 4, dict(max_solo_distance=2.0),
                 [([1], [0.0]), ([CL], [4.0])]),
    'chlorine_near': ('CCl2', (0, 6, 17), 4, dict(max_solo_distance=2.0),
                      [([1], [0.0]), ([CL], [1.75])]),
    'bromine': ('CBr2', (0, 6, 35), 4, dict(max_solo_distance=2.0),
                [([1], [0.0]), ([2], [4.0]), ([2], [1.9])]),
    'heavy_far': ('O2', (0, 8), 4, {}, [([1], [0.0]), ([1], [4.0])]),
    'element_not_in_bag': ('H2O', (0, 1, 8), 5, {},
                           [([O], [0.0]), ([O], [1.5])]),
    'two_envs': ('H2O', (0, 1, 8), 5, dict(min_reward=-0.6),
                 [([O, 0], [0.0, 0.0]), ([H, O], [0.96, 0.0]),
                  ([H, H], [-0.96, 0.2])]),
    'canvas_full': ('H2O', (0, 1, 8), 2, {},
                    [([O], [0.0]), ([H], [0.96])]),
}


def _pair(formula, zs, canvas, kwargs, num_envs):
    space = ObservationSpace(canvas, list(zs))
    jspace = JaxObservationSpace(canvas, list(zs))
    bags = np.stack([space.bag_from_formula(string_to_formula(formula))])
    vec = VecEnv(MolecularEnv(make_lennard_jones_reward(), space, bags,
                              device='cpu', **kwargs), num_envs)
    jvec = JaxVecEnv(JaxMolecularEnv(reward_fn=jax_lj(),
                                     observation_space=jspace,
                                     formulas=bags, **kwargs), num_envs)
    return vec, jvec


def _assert_obs(obs, jobs):
    np.testing.assert_array_equal(obs.elements.numpy(), np.asarray(jobs.elements))
    np.testing.assert_array_equal(obs.positions.numpy(),
                                  np.asarray(jobs.positions))
    np.testing.assert_array_equal(obs.bag.numpy(), np.asarray(jobs.bag))


@pytest.mark.parametrize('name', list(SCENARIOS))
def test_steps_match_jax(name):
    formula, zs, canvas, kwargs, steps = SCENARIOS[name]
    num_envs = len(steps[0][0])
    vec, jvec = _pair(formula, zs, canvas, kwargs, num_envs)
    assert vec.get_size() == jvec.get_size() == num_envs
    _assert_obs(vec.reset(), jvec.reset())
    for i, (elements, xs) in enumerate(steps):
        action = (np.array(elements), _pos(*xs))
        if i % 2:   # the async pair, and a tensor action
            vec.step_async((torch.tensor(elements), torch.from_numpy(_pos(*xs))))
            obs, reward, done, info = vec.step_wait()
        else:
            obs, reward, done, info = vec.step(action)
        jobs, jreward, jdone, _ = jvec.step(action)
        _assert_obs(obs, jobs)
        np.testing.assert_allclose(reward, np.asarray(jreward), rtol=0,
                                   atol=1e-6)
        assert reward.dtype == np.float32 and done.dtype == bool
        np.testing.assert_array_equal(done, np.asarray(jdone))
        np.testing.assert_array_equal(vec.states.n_atoms.numpy(),
                                      np.asarray(jvec.states.n_atoms))
        assert info['elapsed_time'] > 0
    # the finished envs start over, the others keep their canvas
    _assert_obs(vec.reset_if_terminal(done), jvec.reset_if_terminal(done))


def test_semantics_of_the_scenarios():
    """What the scenarios show (tests/test_environment.py): the stop ends
    an episode at 0, a close atom or a far H ends it at min_reward without
    placing, a bonded water is rewarded."""
    vec, _ = _pair('H2O', (0, 1, 8), 5, {}, 1)
    vec.reset()
    _obs, reward, done, _ = vec.step((np.array([0]), _pos(0.0)))
    assert done[0] and reward[0] == 0.0
    vec.reset()
    vec.step((np.array([O]), _pos(0.0)))
    _obs, reward, done, _ = vec.step((np.array([H]), _pos(0.1)))
    assert done[0] and reward[0] == pytest.approx(-0.6)
    assert int(vec.states.n_atoms[0]) == 1
    vec.reset()
    vec.step((np.array([O]), _pos(0.0)))
    vec.step((np.array([H]), _pos(0.96)))
    obs, reward, done, _ = vec.step((np.array([H]), _pos(-0.96)))
    assert done[0] and int(obs.bag.sum()) == 0 and reward[0] > 0


def test_stochastic_bags_come_from_the_generator():
    """A stochastic-bag env draws its bags from the VecEnv's generator:
    the same seed gives the same bags, another seed others."""
    space = ObservationSpace(8, [0, 1, 6, 8])
    bags = np.stack([space.bag_from_formula(string_to_formula('C2H6O'))])

    def first_bags(seed):
        env = MolecularEnv(make_lennard_jones_reward(), space, bags,
                           device='cpu', stochastic_size_range=(3, 8))
        vec = VecEnv(env, 16, seed=seed)
        assert vec.device == torch.device('cpu')
        return vec.reset().bag

    assert torch.equal(first_bags(3), first_bags(3))
    assert not torch.equal(first_bags(3), first_bags(4))


def test_step_before_reset_raises():
    vec, _ = _pair('H2O', (0, 1, 8), 5, {}, 1)
    with pytest.raises(RuntimeError, match='reset'):
        vec.step((np.array([O]), _pos(0.0)))
    vec.reset()
    with pytest.raises(RuntimeError, match='step_async'):
        vec.step_wait()
