"""What the data-parallel tests run inside their spawned ranks. It imports
torch and the port only, so that a rank starts without JAX; the tests
themselves (test_torch_parallel.py, test_torch_parallel_draws.py,
test_torch_driver.py) hold the results against the JAX package and against
one process."""
import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from molgym_tpu_torch.agents.covariant import CovariantAC
from molgym_tpu_torch.envs.environment import MolecularEnv
from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
from molgym_tpu_torch.formula import string_to_formula
from molgym_tpu_torch.parallel.mesh import make_dp_ppo_iteration, make_mesh
from molgym_tpu_torch.rl import ppo
from molgym_tpu_torch.rl.buffer import Trajectory
from molgym_tpu_torch.spaces import Observation, ObservationSpace
from molgym_tpu_torch.tools.util import MemoryInfoSaver

# the driver tests' TINY covariant configuration (test_torch_driver.py)
TINY_AGENT = dict(zs=(0, 1, 8), canvas_size=3, network_width=16, maxl=2,
                  num_cg_levels=2, num_channels_hidden=3,
                  num_channels_per_element=2, num_gaussians=2, bag_scale=3)


def params_of(agent):
    return {k: v.detach().clone() for k, v in agent.named_parameters()}


def train_once(agent_kwargs, state, config, data, seed, mesh=None):
    """(parameters, info, the first step's gradients) after one train() call
    from `state`: with a mesh, this rank's part of the data-parallel
    update."""
    agent = CovariantAC(**agent_kwargs, device='cpu')
    agent.load_state_dict(state)
    optimizer = ppo.make_optimizer(config, agent)
    steps = []
    step = optimizer.step

    def spy(grads):
        steps.append({k: g.clone() for k, g in grads.items()})
        step(grads)
    optimizer.step = spy
    info = ppo.make_train_fn(agent, optimizer, config,
                             int(data['adv'].shape[0]), mesh=mesh)(
        data, torch.Generator().manual_seed(seed))
    return params_of(agent), info, steps[0]


def chunked_grads(agent_kwargs, state, config, data, seed, world):
    """The first epoch's gradient of make_train_fn(mesh=...) over `world`
    ranks, computed in one process: the same permutation and chunks, each
    rank's sum of its chunks' gradients, then the sum over ranks in rank
    order."""
    agent = CovariantAC(**agent_kwargs, device='cpu')
    agent.load_state_dict(state)
    loss_fn = ppo.make_loss_fn(agent, config)
    n = int(data['adv'].shape[0])
    mb = min(config.mini_batch_size, n)
    num_batches = -(-n // mb)
    pad = num_batches * mb - n
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    idx = torch.cat([perm, perm[:pad]]).reshape(num_batches, mb)
    weights = torch.ones(num_batches, mb)
    if pad:
        weights[-1, mb - pad:] = 0.0
    total = {k: torch.zeros_like(p) for k, p in agent.named_parameters()}
    for rank in range(world):
        agent.zero_grad(set_to_none=True)
        for i, w in zip(idx, weights):
            norm = w.sum().clamp(min=1.0)
            i, w = (torch.tensor_split(x, world)[rank] for x in (i, w))
            loss, _info = loss_fn(data['obs'].map(lambda x: x[i]),
                                  data['act'][i], data['logp'][i],
                                  data['adv'][i], data['ret'][i], w, norm)
            loss.backward()
        for k, p in agent.named_parameters():
            if p.grad is not None:
                total[k] += p.grad
    return total


def marked_trajectory(rank, T=3, b=2):
    """A [T, b] trajectory whose every value names its rank, time and env."""
    t = torch.arange(T)[:, None] * 100 + torch.arange(b)[None] + 1000 * rank

    def obs(shift):
        return Observation(elements=(t + shift)[..., None].repeat(1, 1, 4),
                           positions=(t + shift).float()[..., None, None]
                           .repeat(1, 1, 4, 3),
                           bag=(t + shift)[..., None].repeat(1, 1, 2))
    return Trajectory(obs=obs(0), next_obs=obs(1),
                      actions=t.float()[..., None].repeat(1, 1, 6),
                      rewards=t.float(), terminals=(t % 2) == 1,
                      values=t.float() + 0.5, logps=-t.float(),
                      bootstrap_value=t[0].float() + 7)


def update_rank(world, agent_kwargs, state, cases):
    """In each of `world` ranks: every case's data-parallel update, one
    marked trajectory gathered, and the start broadcast of perturbed
    replicas; returns this rank's results."""
    with make_mesh(world, 'cpu') as mesh:
        out = dict(rank=mesh.rank, updates=[
            train_once(agent_kwargs, state, config, data, seed, mesh)
            for config, data, seed in cases])
        traj = mesh.gather_trajectory(marked_trajectory(mesh.rank))
        out['gathered'] = {f.name: getattr(traj, f.name)
                           for f in dataclasses.fields(traj)}
        agent = CovariantAC(**agent_kwargs, device='cpu')
        agent.load_state_dict(state)
        optimizer = ppo.make_optimizer(ppo.PPOConfig(), agent)
        with torch.no_grad():
            for p in agent.parameters():
                p.add_(mesh.rank)
        for k in optimizer.mu:
            optimizer.mu[k].fill_(mesh.rank + 1.0)
        optimizer.count = 5 + mesh.rank
        mesh.broadcast_optimizer_(optimizer)
        out['broadcast'] = (params_of(agent), optimizer.count,
                            {k: v.clone() for k, v in optimizer.mu.items()})
        return out


def tiny_setup():
    """Training and evaluation envs over H2O and OH2 on a canvas of 3, and
    the TINY agent from seed 0."""
    space = ObservationSpace(canvas_size=3, zs=list(TINY_AGENT['zs']))
    bags = np.stack([space.bag_from_formula(string_to_formula(f))
                     for f in ('H2O', 'OH2')])
    envs, eval_envs = (MolecularEnv(make_lennard_jones_reward(), space, bags,
                                    device='cpu') for _ in range(2))
    torch.manual_seed(0)
    return envs, eval_envs, CovariantAC(**TINY_AGENT, device='cpu')


def batch_ppo_rank(kwargs):
    """In one rank (W = 1): two PPO iterations of plain batch_ppo, then the
    same from the same weights through batch_ppo(mesh=...); returns the
    parameters and records of both."""
    envs, eval_envs, agent = tiny_setup()
    init = {k: v.clone() for k, v in agent.state_dict().items()}
    out = {}
    for name in ('plain', 'mesh'):
        agent.load_state_dict(init)
        records = MemoryInfoSaver()
        if name == 'plain':
            ppo.batch_ppo(envs, eval_envs, agent, info_saver=records,
                          **kwargs)
        else:
            with make_mesh(1, 'cpu') as mesh:
                ppo.batch_ppo(envs, eval_envs, agent, info_saver=records,
                              mesh=mesh, **kwargs)
        out[name] = (params_of(agent), records.lines)
    return out


def dp_iteration_rank(world, kwargs):
    """In each of `world` ranks: one iteration of make_dp_ppo_iteration,
    then one of batch_ppo(mesh=...) without evaluation from the same
    weights and seed; returns the parameters and the train info of each."""
    envs, _eval_envs, agent = tiny_setup()
    init = {k: v.clone() for k, v in agent.state_dict().items()}
    with make_mesh(world, 'cpu') as mesh:
        init_fn, iteration = make_dp_ppo_iteration(
            envs, agent, kwargs['config'], kwargs['num_envs'],
            kwargs['num_steps_per_iter'], mesh)
        states, _optimizer, generator = init_fn(kwargs['seed'])
        _states, _traj, info = iteration(states, generator)
        out = dict(iteration=(params_of(agent), info))
        agent.load_state_dict(init)
        records = MemoryInfoSaver()
        ppo.batch_ppo(envs, None, agent, info_saver=records, mesh=mesh,
                      max_num_steps=kwargs['num_steps_per_iter'], **kwargs)
        out['batch_ppo'] = (params_of(agent), records.lines)
        return out


# the runs of test_torch_parallel_draws.py, each one PPO iteration of 6 envs
# x 4 steps (so that W = 2 and W = 3 divide the envs) with an evaluation:
# name -> (argv, the action columns that are discrete indices, the host LJ
# epsilon or None)
DRAWS_SHAPE = ['--num_envs=6', '--num_steps_per_iter=24',
               '--mini_batch_size=12', '--max_num_train_iters=2',
               '--num_steps=24', '--eval_freq=1', '--device=cpu']
DRAWS_COVARIANT = ['--model=covariant', '--maxl=2', '--num_cg_levels=2',
                   '--network_width=16', '--num_channels_hidden=3',
                   '--num_channels_per_element=2', '--beta=-10']
DRAWS_RUNS = {
    # the canonical SF6 run's env and agent family, narrowed
    'sf6': (['--formulas=SF6', '--symbols=X,S,F', '--canvas_size=7',
             '--bag_scale=5', '--min_mean_distance=1.10',
             '--max_mean_distance=2.10', '--reward=device_lj', '--seed=1']
            + DRAWS_COVARIANT, (0, 1), None),
    # stochastic bags: the parity loop draws again at the start (the test
    # checks that it does)
    'stochastic': (['--formulas=C2H6O', '--symbols=X,H,C,O',
                    '--canvas_size=6', '--bag_scale=6', '--size_range=3,6',
                    '--min_mean_distance=0.9', '--max_mean_distance=1.8',
                    '--reward=device_lj', '--seed=2'] + DRAWS_COVARIANT,
                   (0, 1), None),
    # the internal agent: its normal heads and its kappa head
    'internal': (['--formulas=H2O', '--symbols=X,H,O', '--canvas_size=3',
                  '--bag_scale=3', '--model=internal', '--num_interactions=2',
                  '--network_width=16', '--reward=device_lj', '--seed=3'],
                 (1, 2, 6), None),
    # the pipelined host transport over stochastic bags, LJ on the host at
    # tests/test_torch_host_rollout.py's fixup_lj: close placements in a
    # deep well, so that rewards below min_reward end episodes that the
    # speculative rewards of 0 did not, and the forward is computed again
    'pipelined': (['--formulas=H2O', '--symbols=X,H,O', '--canvas_size=4',
                   '--bag_scale=3', '--size_range=2,4', '--reward=lj',
                   '--host_reward_mode=loop', '--min_mean_distance=0.7',
                   '--max_mean_distance=1.0', '--seed=5'] + DRAWS_COVARIANT,
                  (0, 1), 40.0),
}


# --host_reward_mode=auto over 5 iterations of the O2 mlp model with the
# host LJ reward (test_torch_parallel.py's test_auto_transport_at_w2): the
# selector probes on iterations 0-3 and keeps its choice on the fifth
AUTO_RUN = (['--formulas=O2', '--symbols=X,O', '--canvas_size=3',
             '--bag_scale=3', '--model=mlp', '--network_width=16',
             '--reward=lj', '--host_reward_mode=auto', '--seed=1',
             '--num_steps=120'], (1, 2), None)
RUNS = dict(DRAWS_RUNS, auto=AUTO_RUN)


def draws_config(name):
    from molgym_tpu_torch.run_stochastic import build_parser
    from molgym_tpu_torch.tools.arg_parser import build_default_argparser
    argv = ['--name=' + name] + DRAWS_SHAPE + RUNS[name][0]
    parser = (build_parser() if any(a.startswith('--size_range=')
                                    for a in argv)
              else build_default_argparser())
    return vars(parser.parse_args(argv))


def draws_run(name, mesh=None):
    """RUNS[name] through batch_ppo (with `mesh`:
    this rank's part; a writer evaluates), from random weights of seed 0:
    the global training rollout (numpy), the records and the parameters."""
    from molgym_tpu_torch.calculators.native import (METHOD_LJ,
                                                     NativeBatchCalculator)
    from molgym_tpu_torch.calculators.reward_host import (
        TimedBatchCalculator, make_host_reward)
    from molgym_tpu_torch.run_stochastic import stochastic_envs
    from molgym_tpu_torch.spaces import symbols_to_zs
    from molgym_tpu_torch.tools.driver import (host_transport,
                                               make_reward_fn,
                                               ppo_config_from, standard_envs)
    from molgym_tpu_torch.tools.model_util import build_model

    config = draws_config(name)
    space = ObservationSpace(config['canvas_size'],
                             symbols_to_zs(config['symbols']))
    epsilon = RUNS[name][2]
    if epsilon is None:
        reward_fn, host_calc = make_reward_fn(config)
    else:
        host_calc = TimedBatchCalculator(NativeBatchCalculator(METHOD_LJ,
                                                               epsilon))
        reward_fn = make_host_reward(host_calc)
    build = stochastic_envs if config.get('size_range') else standard_envs
    envs, eval_envs = build(config, space, reward_fn, torch.device('cpu'))
    torch.manual_seed(0)
    agent = build_model(config, space, device='cpu')
    rollouts, records = {}, MemoryInfoSaver()

    class Saver:
        def save(self, obj, num_steps, info):
            rollouts[info] = obj

    writer = mesh is None or mesh.writer
    ppo.batch_ppo(
        envs, eval_envs if writer else None, agent,
        num_envs=config['num_envs'],
        num_steps_per_iter=config['num_steps_per_iter'],
        max_num_steps=config['max_num_steps'],
        config=ppo_config_from(config),
        eval_freq=config['eval_freq'],
        num_eval_episodes=int(eval_envs.formulas.shape[0]),
        rollout_saver=Saver(), save_train_rollout=True,
        info_saver=records, seed=config['seed'], mesh=mesh,
        **host_transport(config['host_reward_mode'], host_calc))
    return dict(rollouts=rollouts, records=records.lines,
                params=params_of(agent))


def draws_rank(world):
    """In each of `world` ranks: every run of DRAWS_RUNS; returns this
    rank's results by name."""
    with make_mesh(world, 'cpu') as mesh:
        return dict(rank=mesh.rank, runs={name: draws_run(name, mesh)
                                          for name in DRAWS_RUNS})


def _stub(delay):
    def fn(params, states, generator):
        time.sleep(delay)
        return states, SimpleNamespace(rewards=torch.zeros(1))
    return fn


def auto_rank(world):
    """In each of `world` ranks: a selector over stubs whose delays favour
    the pipelined transport on rank 0 and the in-step one elsewhere (its
    choice and timed seconds after 5 calls: the MAX over the ranks makes
    them one), and the run RUNS['auto']."""
    from molgym_tpu_torch.rl.rollout import AutoTransportRollout
    with make_mesh(world, 'cpu') as mesh:
        slow, fast = 0.05, 0.001
        selector = AutoTransportRollout(
            {'pipelined': _stub(fast if mesh.rank == 0 else slow),
             'in_step': _stub(slow if mesh.rank == 0 else fast)}, mesh=mesh)
        for _ in range(5):
            selector(None, None, None)
        return dict(rank=mesh.rank, stub=(selector.choice, selector.times),
                    run=draws_run('auto', mesh))
