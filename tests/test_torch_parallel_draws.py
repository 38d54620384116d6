"""Data parallelism that does not change the run: W ranks draw every random
number of the rollout for the global batch from one stream and keep their
rows (molgym_tpu_torch/draws.py, parallel/mesh.py), so that they train what
one process trains from the same seed and weights. The port's counterparts
of tests/test_parallel.py's test_dp_matches_single_device (an 8-way mesh
against one device) and test_two_process_full_ppo_matches_single_process,
over gloo at W = 2 and 3.

The draws themselves are held bit for bit: a rank's Draws at batch axis 0
and 1 against the rows of the whole draw, each sampler of the rollout
(the categorical head's uniforms, the normal heads, the GMM head's sample
and its 128 candidates, the sphere's rotations and grid gumbel) and the
stochastic bags with their parity loop, and the generator's state after
them.

The runs (tests/torch_parallel_ranks.py's DRAWS_RUNS: the covariant SF6
family, stochastic bags, the internal agent and the pipelined host
transport, one PPO iteration each) against one process: the gathered
training rollout's discrete sub-actions, terminals, elements and bags
equal; its continuous sub-actions and positions within 1e-5, its rewards,
values and log-probs within 1e-5 of max(1, |value|) (the policy's forward
over B / W rows rounds otherwise than over B: measured up to 5e-7; the
pipelined run's LJ at epsilon 40 gives rewards up to 35, where a float32
ulp is 3.8e-6 and a position 1 ulp off moved one by 1.5e-5, 4.4e-7 of
it); the parameters after the
iteration by assert_params_close's rule (every element within 2 lr per step
+ 1e-5, at most 1% beyond 1e-5: a gradient at the float32 noise floor
gets Adam's lr-sized step of the noise's sign; measured up to 4e-5); the
records within rtol 1e-4, the times and the pipelined transport's
`recomputes` (each rank counts its own envs') aside."""
import json

import numpy as np
import pytest
import torch

from molgym_tpu_torch.distributions import gmm, spherical
from molgym_tpu_torch.distributions.discrete import (categorical_head,
                                                     normal_sample)
from molgym_tpu_torch.draws import Draws, as_draws
from molgym_tpu_torch.envs.environment import MolecularEnv
from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
from molgym_tpu_torch.formula import string_to_formula
from molgym_tpu_torch.parallel import mesh as pmesh
from molgym_tpu_torch.rl import ppo
from molgym_tpu_torch.spaces import ObservationSpace
from molgym_tpu_torch.tools.util import MemoryInfoSaver
from tests import torch_parallel_ranks as ranks

JOIN_S = 240   # each spawn's time limit
UNTIMED = ('time', 'iteration_time', 'reward_time', 'recomputes')


def rank_draws(seed, world, rank, total):
    n = total // world
    return Draws(torch.Generator().manual_seed(seed), rank * n,
                 (rank + 1) * n, total)


def rows(x, world, rank, batch_dim):
    n = x.shape[batch_dim] // world
    return x.narrow(batch_dim, rank * n, n)


def world_ranks():
    return [(w, r) for w in (2, 3) for r in range(w)]


@pytest.mark.parametrize('kind', ['rand', 'randn'])
@pytest.mark.parametrize('batch_dim', [0, 1])
@pytest.mark.parametrize('world,rank', world_ranks())
def test_a_rank_draws_the_rows_of_the_whole_draw(world, rank, batch_dim,
                                                 kind):
    """A rank's draw of its rows (along axis 0 or 1) is those rows of the
    whole batch's draw, bit for bit, and leaves the generator where the
    whole draw does."""
    shape = [(6, 5), (4, 6, 3)][batch_dim]
    whole = torch.Generator().manual_seed(7)
    want = getattr(torch, kind)(shape, generator=whole)
    draws = rank_draws(7, world, rank, 6)
    local = list(shape)
    local[batch_dim] = 6 // world
    got = getattr(draws, kind)(local, batch_dim=batch_dim)
    assert torch.equal(got, rows(want, world, rank, batch_dim))
    assert torch.equal(draws.get_state(), whole.get_state())


def test_a_plain_generator_draws_the_whole_batch():
    """as_draws of a torch.Generator makes the plain call: W = 1 keeps its
    bits. A draw of another row count than the rank's raises."""
    a, b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert torch.equal(as_draws(a).rand((5, 4)), torch.rand((5, 4),
                                                            generator=b))
    assert torch.equal(as_draws(a).randn((2, 5), batch_dim=1),
                       torch.randn((2, 5), generator=b))
    assert torch.equal(a.get_state(), b.get_state())
    assert as_draws(None).generator is None and as_draws(a).generator is a
    draws = rank_draws(3, 2, 1, 6)
    assert as_draws(draws) is draws
    with pytest.raises(ValueError, match='a draw of 4 rows where this rank '
                       'keeps 3 of 6'):
        draws.rand((4, 2))
    with pytest.raises(ValueError, match=r'rows \[3, 3\) of a batch of 6'):
        Draws(torch.Generator(), 3, 3, 6)


def _sampler_inputs(total):
    rng = np.random.RandomState(5)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return dict(logits=t(total, 7), mask=torch.from_numpy(
        rng.rand(total, 7) < 0.7) | (torch.arange(7) == 0),
        mean=t(total, 3), std=torch.exp(t(3)),
        log_w=t(total, 3), means=t(total, 3), stds=torch.exp(t(3)) * 0.2,
        alms=[t(total, 2, 2 * l + 1, 2) for l in range(3)],
        empty=torch.from_numpy(rng.rand(total) < 0.3))


def _sample(name, x, rng):
    if name == 'categorical_head':
        return categorical_head(x['logits'], x['mask'], rng)[1]
    if name == 'normal_sample':
        return normal_sample(rng, x['mean'], x['std'].expand_as(x['mean']))
    if name == 'gmm_sample':
        return gmm.gmm_sample(rng, x['log_w'], x['means'], x['stds'])
    if name == 'gmm_argmax':
        return gmm.gmm_argmax(rng, x['log_w'], x['means'], x['stds'])
    dist = spherical.make_so3_distribution(x['alms'], x['empty'], beta=-10.0)
    return spherical.sample(dist, rng)


@pytest.mark.parametrize('name', ['categorical_head', 'normal_sample',
                                  'gmm_sample', 'gmm_argmax',
                                  'spherical_sample'])
def test_the_samplers_keep_the_rows_of_the_whole_batch(name):
    """Each sampler of the rollout, called on a rank's rows with its Draws,
    gives those rows of the whole batch's samples, bit for bit (the GMM
    head's candidates and the sphere's grid draw with the batch on axis
    1), and the generator ends where the whole batch's does."""
    total = 6
    x = _sampler_inputs(total)
    whole = torch.Generator().manual_seed(11)
    want = _sample(name, x, whole)
    for world, rank in world_ranks():
        mine = {k: ([rows(a, world, rank, 0) for a in v] if k == 'alms'
                    else v if k in ('std', 'stds')
                    else rows(v, world, rank, 0)) for k, v in x.items()}
        draws = rank_draws(11, world, rank, total)
        got = _sample(name, mine, draws)
        assert torch.equal(got, rows(want, world, rank, 0)), (world, rank)
        assert torch.equal(draws.get_state(), whole.get_state())


def _stochastic_env(size_range):
    space = ObservationSpace(canvas_size=6, zs=[0, 1, 6, 8])
    bag = space.bag_from_formula(string_to_formula('C2H6O'))
    return MolecularEnv(make_lennard_jones_reward(), space, bag[None],
                        stochastic_size_range=size_range, device='cpu')


def test_stochastic_bags_keep_the_rows_of_the_global_bags():
    """The parity loop runs over the global batch's bags: a rank's reset
    and init_states hold the rows of one process's, bit for bit, where the
    loop draws again, and the generator ends where one process's does."""
    env = _stochastic_env((3, 6))
    assert env.draw_bags(6, torch.Generator().manual_seed(2))[1] >= 1
    whole = torch.Generator().manual_seed(2)
    want = env.init_states(6, whole)
    want_reset, _obs = env.reset(want, whole)
    for world, rank in world_ranks():
        draws = rank_draws(2, world, rank, 6)
        got = env.init_states(6 // world, draws)
        got_reset, _obs = env.reset(got, draws)
        for a, b in ((got, want), (got_reset, want_reset)):
            assert torch.equal(a.bag, rows(b.bag, world, rank, 0))
        assert torch.equal(draws.get_state(), whole.get_state())


def test_training_draws_do_not_depend_on_the_evaluation():
    """The evaluation draws from its own generator (eval_seed): two
    iterations with an evaluation after each train what two without any
    train, bit for bit; the evaluation's generator is not the training
    one's."""
    kwargs = dict(num_envs=4, num_steps_per_iter=8, max_num_steps=16,
                  config=ppo.PPOConfig(mini_batch_size=6,
                                       max_num_train_iters=2),
                  eval_freq=1, seed=3)
    out = []
    for evaluate in (True, False):
        envs, eval_envs, agent = ranks.tiny_setup()
        records = MemoryInfoSaver()
        ppo.batch_ppo(envs, eval_envs if evaluate else None, agent,
                      info_saver=records, **kwargs)
        out.append((ranks.params_of(agent), [
            (n, {k: v for k, v in r.items() if k not in UNTIMED})
            for n, r in records.lines if n != 'eval']))
    (params, lines), (ref_params, ref_lines) = out
    assert all(torch.equal(p, ref_params[k]) for k, p in params.items())
    assert json.dumps(lines) == json.dumps(ref_lines)
    assert ppo.eval_seed(3) != 3


class Runs:
    """DRAWS_RUNS in one process (here, one thread) and at W ranks (one
    spawn per W, every run inside it)."""

    def __init__(self):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            self.single = {name: ranks.draws_run(name)
                           for name in ranks.DRAWS_RUNS}
        finally:
            torch.set_num_threads(threads)
        self.dp = {}

    def world(self, w):
        if w not in self.dp:
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                self.dp[w] = pmesh.spawn(
                    ranks.draws_rank,
                    pmesh.Launch(w, w, 0, 'localhost', pmesh.free_port()),
                    (w, ), timeout=JOIN_S)
            finally:
                torch.set_num_threads(threads)
        return self.dp[w]


@pytest.fixture(scope='module')
def runs():
    return Runs()


def assert_rollout_matches(got, want, discrete):
    for o in ('obs', 'next_obs'):
        for f in ('elements', 'bag'):
            np.testing.assert_array_equal(got[o][f], want[o][f])
        np.testing.assert_allclose(got[o]['positions'], want[o]['positions'],
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got['terminals'], want['terminals'])
    cols = list(discrete)
    np.testing.assert_array_equal(got['actions'][..., cols],
                                  want['actions'][..., cols])
    np.testing.assert_allclose(got['actions'], want['actions'], rtol=0,
                               atol=1e-5)
    for f in ('rewards', 'values', 'logps', 'bootstrap_value'):
        err = np.abs(got[f] - want[f]) / np.maximum(1.0, np.abs(want[f]))
        assert float(err.max()) <= 1e-5, (f, float(err.max()))


def assert_records_match(got, want):
    assert [n for n, _r in got] == [n for n, _r in want]
    for (name, rec), (_n, ref) in zip(got, want):
        assert rec.keys() == ref.keys(), name
        for key, value in rec.items():
            if key in UNTIMED:
                continue
            if isinstance(value, str):
                assert value == ref[key], (name, key)
            else:
                np.testing.assert_allclose(value, ref[key], rtol=1e-4,
                                           atol=1e-6, err_msg=f'{name} {key}')


def assert_params_rule(params, ref, lr, steps):
    """assert_params_close's rule (tests/test_torch_ppo.py) between two of
    the port's parameter sets."""
    n_off = n_total = 0
    for name, p in params.items():
        diff = (p - ref[name]).abs()
        assert float(diff.max()) <= 2 * lr * steps + 1e-5, name
        n_off += int((diff > 1e-5).sum())
        n_total += diff.numel()
    assert n_off <= 0.01 * n_total, (n_off, n_total)


@pytest.mark.parametrize('name', list(ranks.DRAWS_RUNS))
@pytest.mark.parametrize('world', [2, 3])
def test_dp_run_matches_one_process(runs, world, name):
    """One PPO iteration of DRAWS_RUNS[name] at W ranks against one
    process from the same seed and weights: the global training rollout,
    the parameters and the records (rank 0's evaluation too), on every
    rank; the replicas hold the same bits."""
    want = runs.single[name]
    results = runs.world(world)
    assert [r['rank'] for r in results] == list(range(world))
    _argv, discrete, _eps = ranks.DRAWS_RUNS[name]
    config = ranks.draws_config(name)
    (opt, ) = [r for n, r in want['records'] if n == 'opt']
    assert opt['num_opt_steps'] >= 1
    for res in results:
        got = res['runs'][name]
        assert_rollout_matches(got['rollouts']['train'],
                               want['rollouts']['train'], discrete)
        assert_params_rule(got['params'], want['params'],
                           config['learning_rate'], opt['num_opt_steps'])
        assert_records_match(got['records'], [
            (n, r) for n, r in want['records']
            if n != 'eval' or res['rank'] == 0])
        first = results[0]['runs'][name]['params']
        assert all(torch.equal(p, first[k])
                   for k, p in got['params'].items())
    if name == 'pipelined':
        # the speculative forward was computed again: the fix-up ran
        def recomputes(records):
            return sum(r['recomputes'] for n, r in records if n == 'train')
        assert recomputes(want['records']) >= 1
        assert sum(recomputes(r['runs'][name]['records'])
                   for r in results) >= 1
    if name == 'stochastic':
        # the run's start drew its bags again in the parity loop
        env = _stochastic_env((3, 6))
        assert env.draw_bags(config['num_envs'], torch.Generator().manual_seed(
            config['seed']))[1] >= 1
        bags = want['rollouts']['train']['obs']['bag']
        assert len({tuple(b) for b in bags.reshape(-1, 4).tolist()}) > 1
