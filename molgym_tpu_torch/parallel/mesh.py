"""Data-parallel PPO over torch.distributed (counterpart of
molgym_tpu/parallel/mesh.py).

The JAX package runs one jitted program over a 'dp' mesh: env states
sharded along it, parameters and optimizer state replicated, and the
gradient all-reduce compiled into the update by XLA. Here each rank is a
process that owns one device (`cuda:{local_rank}`, or the CPU), steps its
shard of the envs and runs the update of rl/ppo.py; the collectives are
explicit, and few:

  * at the start, rank 0 broadcasts the parameters and the optimizer state;
  * after each rollout, every field of the trajectory is all-gathered along
    the env axis in rank order, so that every rank holds the global [T, B]
    trajectory that one process with B envs would (the JAX `host_fetch`);
  * each epoch, rank r runs the r-th of W contiguous chunks of every
    minibatch, normalized by the whole minibatch's weight sum; then one
    flat buffer of the summed gradients and loss sums is all-reduced with
    SUM, before the KL check.

No collective carries a random number. Every rank seeds the training
generator with `seed`, as one process does, and draws every random number
of the rollout at the global batch's size, keeping its rows (`Mesh.draws`,
draws.py), as the JAX package draws the global batch from one key and
shards it; every rank draws each epoch's permutation itself, the same one.
So the run does not depend on W: W ranks compute what one process computes
from the same seed and weights, up to the float order of the policy's
forward over B / W rows against B, and at W = 1 the same bits.

Ranks are processes. `spawn` starts the local ranks of the calling process
with torch.multiprocessing and gives each torchrun's variables (RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, GROUP_RANK, MASTER_ADDR,
MASTER_PORT); `make_mesh` forms the calling rank's process group from them,
so a rank that torchrun started works the same way.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from molgym_tpu_torch.device import DeviceLike
from molgym_tpu_torch.draws import Draws
from molgym_tpu_torch.rl.buffer import Trajectory
from molgym_tpu_torch.spaces import Observation

# a rank that dies fails the others' collectives after this long instead of
# hanging them
TIMEOUT_S = 600


@dataclasses.dataclass
class Mesh:
    """The calling rank's place in the data-parallel group. `process` is
    the index of the process (host) that started this rank; its local rank
    0 is a writer: it evaluates and writes the run's files."""
    rank: int
    world_size: int
    local_rank: int
    process: int
    device: torch.device
    backend: str

    @property
    def writer(self) -> bool:
        return self.local_rank == 0

    def __enter__(self) -> 'Mesh':
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()

    def shard(self, num_envs: int) -> int:
        """The envs of each rank: rank r steps [r * n, (r + 1) * n)."""
        return shard_size(num_envs, self.world_size)

    def draws(self, generator: torch.Generator, num_envs: int) -> Draws:
        """`generator`'s draws for all `num_envs` envs, of which this rank
        keeps its shard."""
        n = self.shard(num_envs)
        return Draws(generator, self.rank * n, (self.rank + 1) * n, num_envs)

    def all_gather(self, tensor: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's `tensor`, concatenated along `dim` in rank order."""
        tensor = tensor.contiguous()
        parts = [torch.empty_like(tensor) for _ in range(self.world_size)]
        dist.all_gather(parts, tensor)
        return torch.cat(parts, dim)

    def gather_trajectory(self, traj: Trajectory) -> Trajectory:
        """The global trajectory of all ranks' envs: [T, B] fields gathered
        along axis 1, the bootstrap values along axis 0."""
        def obs(o: Observation) -> Observation:
            return o.map(lambda x: self.all_gather(x, 1))
        return Trajectory(
            obs=obs(traj.obs), next_obs=obs(traj.next_obs),
            **{f.name: self.all_gather(getattr(traj, f.name), 1)
               for f in dataclasses.fields(traj)
               if f.name not in ('obs', 'next_obs', 'bootstrap_value')},
            bootstrap_value=self.all_gather(traj.bootstrap_value, 0))

    def all_reduce_sum(self, tensors: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """The SUM over ranks of each tensor (one dtype), through one flat
        buffer: one collective."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        return _split(flat, tensors)

    def all_reduce_max(self, values: Sequence[float]) -> List[float]:
        """The MAX over ranks of each number, in one collective."""
        flat = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(flat, op=dist.ReduceOp.MAX)
        return flat.tolist()

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's values into every rank's `tensors` (one dtype), in
        place, through one flat buffer."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.broadcast(flat, src=0)
        for t, part in zip(tensors, _split(flat, tensors)):
            t.copy_(part)

    def broadcast_optimizer_(self, optimizer) -> None:
        """Rank 0's parameters and optimizer state (an rl.ppo.Optimizer:
        count, mu, nu and nu_max) on every rank: the replicas start from the
        same bits."""
        self.broadcast_(
            list(optimizer.params.values()) + list(optimizer.mu.values())
            + list(optimizer.nu.values())
            + list((optimizer.nu_max or {}).values()))
        count = torch.tensor([optimizer.count], device=self.device)
        dist.broadcast(count, src=0)
        optimizer.count = int(count)


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    out, offset = [], 0
    for t in like:
        out.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


def shard_size(num_envs: int, world_size: int) -> int:
    if num_envs % world_size:
        raise ValueError(f'num_envs ({num_envs}) must divide evenly across '
                         f'the {world_size} data-parallel ranks')
    return num_envs // world_size


def check_devices(num_local_ranks: int, device: DeviceLike) -> None:
    """Raises ValueError when `device` is `cuda` (no index: one card a
    local rank) and fewer cards are visible than local ranks."""
    device = torch.device(device or 'cuda')
    if device.type == 'cuda' and device.index is None:
        have = torch.cuda.device_count()
        if num_local_ranks > have:
            raise ValueError(f'{num_local_ranks} local ranks need '
                             f'{num_local_ranks} CUDA devices; {have} visible')


def make_mesh(num_devices: int, device: DeviceLike = 'cuda',
              backend: Optional[str] = None) -> Mesh:
    """Forms the process group of the calling rank from torchrun's
    variables (`spawn` sets them) and returns its Mesh; `num_devices` is
    the world size, the ranks over all processes (0: WORLD_SIZE).

    `device` `cuda` puts local rank r on `cuda:{r}` and raises ValueError
    when there are fewer cards than local ranks; `cpu` puts every rank on
    the CPU. The backend is nccl on cuda and gloo on the CPU.

    Two modes serve tests only, and no driver path takes them: a device
    with an index (`cuda:0`) puts every rank on that card, and `backend`
    names the backend; together (`cuda:0`, 'gloo') they run several ranks
    on one card, as chip_smoke.py's phase 13b does where only one card is
    visible (nccl refuses two ranks on one card)."""
    env = os.environ
    world = int(env.get('WORLD_SIZE', '1'))
    if num_devices and num_devices != world:
        raise ValueError(f'a mesh of {num_devices} devices in a world of '
                         f'{world} ranks')
    rank = int(env.get('RANK', '0'))
    local_rank = int(env.get('LOCAL_RANK', '0'))
    local_world = int(env.get('LOCAL_WORLD_SIZE', str(world)))
    device = torch.device(device or 'cuda')
    if device.type == 'cuda':
        if device.index is None:
            check_devices(local_world, device)
            device = torch.device('cuda', local_rank)
        torch.cuda.set_device(device)
    backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
    dist.init_process_group(
        backend, init_method='env://', world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Mesh(rank=rank, world_size=world, local_rank=local_rank,
                process=int(env.get('GROUP_RANK', str(rank // local_world))),
                device=device, backend=backend)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class Launch:
    """The ranks of one process of a data-parallel run: `local_ranks` to
    spawn (0: the process is a rank itself, started by torchrun), numbered
    from process_id * local_ranks, meeting at master_addr:master_port."""
    world_size: int
    local_ranks: int
    process_id: int
    master_addr: str
    master_port: int


def launch_from(num_devices: int, multihost: bool) -> Optional[Launch]:
    """The ranks that --num_devices and --multihost ask of this process;
    None for a single process without a process group.

    --num_devices counts ranks over all processes. --multihost reads
    MOLGYM_COORDINATOR_ADDRESS (host:port), MOLGYM_NUM_PROCESSES and
    MOLGYM_PROCESS_ID, and each process spawns num_devices /
    num_processes local ranks (one a process when num_devices < 2);
    without them, torchrun's variables make this process one rank."""
    num_devices = num_devices or 0
    if not multihost:
        if num_devices <= 1:
            return None
        return Launch(num_devices, num_devices, 0, 'localhost', free_port())
    env = os.environ
    if env.get('MOLGYM_COORDINATOR_ADDRESS'):
        num_processes = int(env['MOLGYM_NUM_PROCESSES'])
        world = max(num_devices, num_processes)
        if world % num_processes:
            raise ValueError(f'--num_devices={num_devices} does not divide '
                             f'over {num_processes} processes')
        host, port = env['MOLGYM_COORDINATOR_ADDRESS'].rsplit(':', 1)
        return Launch(world, world // num_processes,
                      int(env['MOLGYM_PROCESS_ID']), host, int(port))
    if all(k in env for k in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                              'MASTER_PORT')):
        world = int(env['WORLD_SIZE'])
        if num_devices > 1 and num_devices != world:
            raise ValueError(f'--num_devices={num_devices} in a torchrun '
                             f'world of {world}')
        return Launch(world, 0, int(env.get('GROUP_RANK', '0')),
                      env['MASTER_ADDR'], int(env['MASTER_PORT']))
    raise RuntimeError(
        '--multihost needs MOLGYM_COORDINATOR_ADDRESS, MOLGYM_NUM_PROCESSES '
        'and MOLGYM_PROCESS_ID, or torchrun\'s RANK, WORLD_SIZE, MASTER_ADDR '
        'and MASTER_PORT')


def _rank_main(local_rank: int, fn: Callable, args: tuple, launch: Launch,
               num_threads: int, out_dir: str) -> None:
    os.environ.update(
        RANK=str(launch.process_id * launch.local_ranks + local_rank),
        WORLD_SIZE=str(launch.world_size), LOCAL_RANK=str(local_rank),
        LOCAL_WORLD_SIZE=str(launch.local_ranks),
        GROUP_RANK=str(launch.process_id), MASTER_ADDR=launch.master_addr,
        MASTER_PORT=str(launch.master_port))
    torch.set_num_threads(num_threads)
    result = fn(*args)
    if result is not None:
        torch.save(result, os.path.join(out_dir, f'{local_rank}.pt'))


def spawn(fn: Callable, launch: Launch, args: tuple = (),
          timeout: Optional[float] = None) -> list:
    """Runs fn(*args) in `launch.local_ranks` new processes (start method
    spawn), each with torchrun's variables of its rank set, and returns
    their return values (CPU objects; torch.save'd through a temporary
    directory) in local rank order. The intra-op threads of this process
    are divided among them. A rank's exception fails the others and is
    raised here; so is a run longer than `timeout` seconds, whose ranks are
    killed."""
    num_threads = max(1, torch.get_num_threads() // launch.local_ranks)
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, launch, num_threads, out_dir),
            nprocs=launch.local_ranks, join=False, start_method='spawn')
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while not ctx.join(None if deadline is None else
                               max(0.0, deadline - time.monotonic())):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f'{launch.local_ranks} ranks still '
                                       f'running after {timeout} s')
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(path, weights_only=False)
                if os.path.exists(path := os.path.join(out_dir, f'{r}.pt'))
                else None for r in range(launch.local_ranks)]


def make_dp_ppo_iteration(env, agent: torch.nn.Module, config,
                          num_envs: int, num_steps_per_iter: int,
                          mesh: Optional[Mesh] = None
                          ) -> Tuple[Callable, Callable]:
    """Returns (init_fn, iteration_fn), to be called inside a rank:

      init_fn(seed) -> (states, optimizer, generator): this rank's env
          shard, drawn for all num_envs, its Draws (the generator seeded
          with `seed` on every rank), and the agent's optimizer, with rank
          0's parameters and optimizer state on every rank
      iteration_fn(states, generator) -> (states, traj, info):
          one PPO iteration: the rollout of this rank's envs, the global
          trajectory `traj` (every rank's, gathered), GAE and the clipped
          update, which steps the agent in place

    With mesh=None the single-process iteration. It is batch_ppo's
    iteration without the evaluation and the writes, from the same start
    (rl.ppo.start_rollouts): from the same weights and seed, the same
    bits."""
    from molgym_tpu_torch.rl.buffer import compute_ppo_data
    from molgym_tpu_torch.rl.ppo import (make_optimizer, make_train_fn,
                                         start_rollouts)
    from molgym_tpu_torch.rl.rollout import make_rollout_fn

    if num_steps_per_iter % num_envs:
        raise ValueError('num_steps_per_iter must be divisible by num_envs')
    rollout = make_rollout_fn(env, agent, num_steps_per_iter // num_envs)
    optimizer = make_optimizer(config, agent)
    train = make_train_fn(agent, optimizer, config, num_steps_per_iter,
                          mesh=mesh)

    def init_fn(seed: int):
        states, generator = start_rollouts(env, num_envs, optimizer, seed,
                                           mesh)
        return states, optimizer, generator

    def iteration_fn(states, generator):
        states, traj = rollout(agent, states, generator)
        if mesh is not None:
            traj = mesh.gather_trajectory(traj)
        data = compute_ppo_data(traj, config.gamma, config.lam)
        return states, traj, train(data, generator)

    return init_fn, iteration_fn


def _dryrun_rank(n: int, device: str) -> dict:
    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.envs.environment import MolecularEnv
    from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
    from molgym_tpu_torch.formula import string_to_formula
    from molgym_tpu_torch.rl.ppo import PPOConfig
    from molgym_tpu_torch.spaces import ObservationSpace

    with make_mesh(n, device) as mesh:
        torch.manual_seed(0)
        space = ObservationSpace(canvas_size=4, zs=[0, 9, 16])
        bag = space.bag_from_formula(string_to_formula('SF2'))
        env = MolecularEnv(make_lennard_jones_reward(), space, bag[None],
                           device=mesh.device)
        agent = CovariantAC(zs=(0, 9, 16), canvas_size=4, maxl=2,
                            num_cg_levels=2, num_channels_hidden=3,
                            num_channels_per_element=2, network_width=16,
                            device=mesh.device)
        num_envs = n * max(1, 8 // n)
        steps = num_envs * 2
        config = PPOConfig(mini_batch_size=steps // 2, max_num_train_iters=2,
                           gamma=1.0)
        init_fn, iteration = make_dp_ppo_iteration(env, agent, config,
                                                   num_envs, steps, mesh)
        states, _optimizer, generator = init_fn(0)
        _states, traj, info = iteration(states, generator)
        if tuple(traj.rewards.shape) != (2, num_envs):
            raise AssertionError(f'rewards {tuple(traj.rewards.shape)}')
        if not (torch.isfinite(traj.rewards).all()
                and np.isfinite(info['total_loss'])):
            raise AssertionError('non-finite rewards or loss')
        return dict(num_envs=num_envs, **info) if mesh.rank == 0 else None


def dryrun_multichip(n: int, device: DeviceLike = 'cuda') -> dict:
    """One data-parallel PPO iteration (rollout, gather, GAE and update) of
    a tiny covariant agent over `n` spawned ranks on `device` (cuda: a card
    each; cpu: gloo processes); the port's counterpart of
    __graft_entry__.dryrun_multichip. Returns rank 0's train info."""
    if str(device) != 'cpu':
        check_devices(n, device)
    info = spawn(_dryrun_rank, Launch(n, n, 0, 'localhost', free_port()),
                 (n, str(device)))[0]
    print(f'dryrun_multichip OK: {n} ranks on {device}, envs='
          f'{info["num_envs"]}, loss={info["total_loss"]:.4f}, '
          f'opt_steps={info["num_opt_steps"]}')
    return info
