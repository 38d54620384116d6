"""The port's stochastic-bag environment and its entry point
(molgym_tpu_torch/run_stochastic.py) against molgym_tpu's.

JAX and PyTorch draw different numbers from the same seed, so the sampler is
held by its properties over a few thousand draws: every bag has lo <= size
< hi atoms of the base formula's elements and an even total valence, and
the element frequencies and the mean size agree with the JAX sampler's
(each under its own seed) within 0.02 and 0.1: about six and three standard
errors of 4,000 draws of ~6 atoms."""
import json

import jax
import numpy as np
import pytest
import torch

from molgym_tpu import formula as jformula
from molgym_tpu import periodic as jperiodic
from molgym_tpu.envs import environment as jenv
from molgym_tpu.envs import reward as jreward
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu_torch import formula, periodic, run_stochastic
from molgym_tpu_torch.agents.covariant import CovariantAC
from molgym_tpu_torch.envs import environment as tenv
from molgym_tpu_torch.envs import reward as treward
from molgym_tpu_torch.rl.rollout import make_rollout_fn
from molgym_tpu_torch.spaces import ObservationSpace

ZS = [0, 1, 6, 8]                       # X, H, C, O
BASE = np.array([[0, 6, 2, 1]])         # C2H6O
VALENCE = np.array([0, 1, 4, 2])
DRAWS = 4000


def _env(size_range, canvas=10, base=BASE):
    return tenv.MolecularEnv(treward.make_lennard_jones_reward(),
                             ObservationSpace(canvas, ZS), base,
                             stochastic_size_range=size_range, device='cpu')


def test_copied_tables_and_parser_match():
    assert periodic.Z_TO_BOND_COUNT == jperiodic.Z_TO_BOND_COUNT
    for text in ('4,9', '3, 3'):
        assert formula.parse_size_range(text) == jformula.parse_size_range(text)
    with pytest.raises(ValueError, match='lo,hi'):
        formula.parse_size_range('4')


@pytest.mark.parametrize('size_range', [(4, 9), (2, 5)])
def test_sampler_properties_match_the_jax_sampler(size_range):
    lo, hi = size_range
    env = _env(size_range)
    bags = env._sample_bags(DRAWS, torch.Generator().manual_seed(0)).numpy()
    jax_env = jenv.MolecularEnv(jreward.make_lennard_jones_reward(),
                                JaxObservationSpace(10, ZS), BASE,
                                stochastic_size_range=size_range)
    np.testing.assert_allclose(env.z_probs.numpy(), np.asarray(jax_env.z_probs))
    np.testing.assert_array_equal(env.bond_counts.numpy(),
                                  np.asarray(jax_env.bond_counts))
    jbags = np.asarray(jax.jit(jax.vmap(jax_env._sample_bag))(
        jax.random.split(jax.random.PRNGKey(0), DRAWS)))
    for b in (bags, jbags):
        sizes = b.sum(-1)
        assert sizes.min() >= lo and sizes.max() < hi
        assert set(np.unique(sizes)) == set(range(lo, hi))
        assert not ((b @ VALENCE) % 2).any()
        assert not b[:, 0].any() and (b[:, 1:].max(0) > 0).all()
    freq, jfreq = (b.sum(0) / b.sum() for b in (bags, jbags))
    np.testing.assert_allclose(freq, jfreq, atol=0.02)
    assert abs(bags.sum(-1).mean() - jbags.sum(-1).mean()) < 0.1
    assert len({tuple(b) for b in bags}) > 10


def test_fixed_size_and_support():
    """lo == hi draws bags of exactly hi atoms; an element the base formula
    lacks is never drawn."""
    env = _env((6, 6), base=np.array([[0, 4, 0, 2]]))
    bags = env._sample_bags(500, torch.Generator().manual_seed(1)).numpy()
    assert (bags.sum(-1) == 6).all() and not bags[:, [0, 2]].any()
    assert not ((bags @ VALENCE) % 2).any()


def test_reset_draws_from_the_generator():
    env = _env((4, 9))
    with pytest.raises(ValueError, match='Generator'):
        env.init_states(4)
    a = env.init_states(64, torch.Generator().manual_seed(3))
    b = env.init_states(64, torch.Generator().manual_seed(3))
    c = env.init_states(64, torch.Generator().manual_seed(4))
    assert torch.equal(a.bag, b.bag) and not torch.equal(a.bag, c.bag)
    assert len({tuple(x) for x in a.bag.tolist()}) > 1
    # only the finished envs get a new bag
    done = torch.arange(64) % 2 == 0
    gen = torch.Generator().manual_seed(5)
    new, obs = env.reset_if_terminal(a, done, gen)
    assert torch.equal(new.bag[~done], a.bag[~done])
    assert not torch.equal(new.bag[done], a.bag[done])
    assert torch.equal(obs.bag, new.bag)
    assert not ((new.bag.numpy() @ VALENCE) % 2).any()


def test_a_fixed_bag_env_draws_nothing_from_the_generator():
    """The rollout hands its generator to every reset; an env over fixed
    formulas leaves it as it was, so its runs keep their random stream."""
    env = tenv.MolecularEnv(treward.make_lennard_jones_reward(),
                            ObservationSpace(10, ZS), BASE, device='cpu')
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    states = env.init_states(4, gen)
    env.reset_if_terminal(states, torch.ones(4, dtype=torch.bool), gen)
    assert torch.equal(gen.get_state(), before)
    assert torch.equal(states.bag, env.init_states(4).bag)


def test_rollout_on_sampled_bags():
    """Bags differ inside one batch, so the element mask and the episode
    lengths do; every episode ends within its bag's size."""
    env = _env((2, 5), canvas=5)
    torch.manual_seed(0)
    agent = CovariantAC(zs=tuple(ZS), canvas_size=5, network_width=16, maxl=2,
                        num_cg_levels=2, num_channels_hidden=3,
                        num_channels_per_element=2, bag_scale=6, device='cpu')
    gen = torch.Generator().manual_seed(0)
    rollout = make_rollout_fn(env, agent, 6)
    _states, traj = rollout(agent, env.init_states(16, gen), gen)
    assert torch.isfinite(traj.logps).all() and torch.isfinite(traj.rewards).all()
    first = traj.obs.bag[0]
    assert len({tuple(x) for x in first.tolist()}) > 1
    assert len({tuple(x) for x in (first > 0).tolist()}) > 1
    sizes = traj.obs.bag.sum(-1)
    assert int(sizes.max()) <= 4
    term = traj.terminals.numpy()
    for b in range(16):
        ends = np.flatnonzero(term[:, b])
        assert len(ends) and ends[0] <= 3 and (np.diff(ends) <= 4).all()


def test_envs_train_on_sampled_bags_and_evaluate_on_fixed_ones():
    config = dict(formulas='C2H6O,CH4', eval_formulas=None, size_range='4,9',
                  min_atomic_distance=0.6, max_solo_distance=2.0,
                  min_reward=-0.6)
    space = ObservationSpace(10, ZS)
    train_env, eval_env = run_stochastic.stochastic_envs(
        config, space, treward.make_lennard_jones_reward(),
        torch.device('cpu'))
    assert train_env.stochastic_size_range == (4, 9)
    np.testing.assert_array_equal(train_env.formulas.numpy(), BASE)
    assert eval_env.stochastic_size_range is None
    np.testing.assert_array_equal(eval_env.formulas.numpy(),
                                  [[0, 6, 2, 1], [0, 4, 1, 0]])
    np.testing.assert_array_equal(eval_env.init_states(3).bag.numpy(),
                                  [[0, 6, 2, 1]] * 3)


TINY = ['--name=tiny', '--formulas=C2H6O', '--canvas_size=5',
        '--symbols=X,H,C,O', '--bag_scale=6', '--model=covariant', '--maxl=2',
        '--num_cg_levels=2', '--network_width=16', '--num_channels_hidden=3',
        '--num_channels_per_element=2', '--num_gaussians=2',
        '--reward=device_lj', '--num_envs=4', '--num_steps_per_iter=8',
        '--mini_batch_size=8', '--max_num_train_iters=2', '--num_steps=16',
        '--seed=1', '--save_rollouts=train', '--device=cpu']


def test_size_range_is_required():
    with pytest.raises(SystemExit):
        run_stochastic.build_parser().parse_args(TINY)


def test_run_stochastic_trains_on_the_cpu(tmp_path):
    dirs = [f'--{d}_dir={tmp_path / d}' for d in ('log', 'model', 'data',
                                                  'results')]
    agent, optimizer = run_stochastic.main(TINY + dirs + ['--size_range=2,5'])
    results = tmp_path / 'results'
    opt = [json.loads(x) for x in
           (results / 'tiny_run-1_opt.txt').read_text().splitlines()]
    evals = [json.loads(x) for x in
             (results / 'tiny_run-1_eval.txt').read_text().splitlines()]
    assert [r['total_num_steps'] for r in opt] == [0, 8] and len(evals) == 2
    assert all(np.isfinite(v) for r in opt for v in r.values())
    assert optimizer.count == sum(r['num_opt_steps'] for r in opt) >= 1
    assert next(agent.parameters()).device.type == 'cpu'
    saved = json.loads((tmp_path / 'log' / 'tiny_run-1.json').read_text())
    assert saved['size_range'] == '2,5'
    assert (tmp_path / 'model' / 'tiny_run-1_steps-16.model').exists()
    # the training rollouts start from sampled bags of 2-4 atoms
    import pickle
    with open(tmp_path / 'data' / 'tiny_run-1_steps-0_train.pkl', 'rb') as f:
        rollout = pickle.load(f)
    sizes = rollout['obs']['bag'][0].sum(-1)
    assert sizes.min() >= 2 and sizes.max() <= 4
