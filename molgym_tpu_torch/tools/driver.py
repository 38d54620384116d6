"""Experiment driver (counterpart of molgym_tpu/tools/driver.py): directories,
logger, config snapshot, seeds, device, spaces, reward, model build or
resume, and the PPO launch, in one process or in data-parallel ranks.

`arg_parser.check_supported` refuses every option the port does not run
yet before anything is built."""
from __future__ import annotations

import logging
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from molgym_tpu_torch.atoms import Atoms
from molgym_tpu_torch.device import DeviceLike, resolve_device
from molgym_tpu_torch.envs import reward as device_reward
from molgym_tpu_torch.envs.environment import MolecularEnv
from molgym_tpu_torch.envs.reward import RewardFn
from molgym_tpu_torch.formula import string_to_formula
from molgym_tpu_torch.parallel.mesh import (Mesh, check_devices, launch_from,
                                            make_mesh, shard_size, spawn)
from molgym_tpu_torch.rl.ppo import PPOConfig, batch_ppo, make_optimizer
from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
from molgym_tpu_torch.tools import util
from molgym_tpu_torch.tools.arg_parser import check_supported
from molgym_tpu_torch.tools.model_io import ModelIO
from molgym_tpu_torch.tools.model_util import build_model


def distance_penalty(config: dict, solvation: bool) -> float:
    """The solvation distance penalty of `config` (0.01 unless given), 0
    without solvation: one number for the env's reward and the pipelined
    transport alike."""
    return config.get('distance_penalty', 0.01) if solvation else 0.0


def make_reward_fn(config: dict, solvation: bool = False
                   ) -> Tuple[RewardFn, Optional[object]]:
    """(batched RewardFn, host batch calculator or None) of
    `config['reward']`. A host reward's calculator is a
    TimedBatchCalculator, and its RewardFn calls the host in the env's
    step. With `solvation` the reward is less distance_penalty(config) *
    |new position|."""
    backend = config.get('reward', 'sparrow')
    penalty = distance_penalty(config, solvation)
    device_fns = {'device_lj': device_reward.make_lennard_jones_reward,
                  'device_morse': device_reward.make_morse_reward}
    if backend in device_fns:
        fn = device_fns[backend]()
        return (device_reward.with_solvation_penalty(fn, penalty)
                if solvation else fn), None

    from molgym_tpu_torch.calculators.reward_host import (
        TimedBatchCalculator, make_host_reward)
    if backend == 'sparrow':
        from molgym_tpu_torch.calculators.sparrow import SparrowBatchCalculator
        calc = SparrowBatchCalculator(
            num_threads=config.get('num_reward_threads', 8))
    else:
        from molgym_tpu_torch.calculators.native import (METHODS,
                                                         NativeBatchCalculator)
        calc = NativeBatchCalculator(method=METHODS[backend])
    calc = TimedBatchCalculator(calc)
    return make_host_reward(calc, distance_penalty=penalty), calc


def host_transport(mode: str, host_calc) -> dict:
    """batch_ppo's host_loop_calculator and host_loop_pipelined for
    --host_reward_mode and a host reward's calculator (None for a device
    reward: nothing to choose). 'loop' is the pipelined host loop;
    'loop_serial' and 'callback' step in the env; 'auto' measures both on
    the first warm iterations and keeps the faster, as the JAX package does
    on a backend without io_callback. That is the port's position: its
    in-step transport copies the reward's inputs to the host inside the
    step, which is the JAX serial host loop's work in its order, not a
    callback inside a compiled step."""
    if host_calc is None or mode not in ('loop', 'auto'):
        return dict(host_loop_calculator=None)
    return dict(host_loop_calculator=host_calc,
                host_loop_pipelined=True if mode == 'loop' else 'auto')


EnvBuilder = Callable[[dict, ObservationSpace, RewardFn, torch.device],
                      Tuple[MolecularEnv, MolecularEnv]]


def standard_envs(config: dict, observation_space: ObservationSpace,
                  reward_fn: RewardFn, device: torch.device, **env_kwargs
                  ) -> Tuple[MolecularEnv, MolecularEnv]:
    """Training and evaluation environments over comma-separated bags;
    `env_kwargs` (a pre-placed canvas, refills, a scaffold's hull) go to
    both."""

    def env(strings: str) -> MolecularEnv:
        bags = np.stack([observation_space.bag_from_formula(string_to_formula(s))
                         for s in strings.split(',')])
        return MolecularEnv(
            reward_fn=reward_fn, observation_space=observation_space,
            formulas=bags, min_atomic_distance=config['min_atomic_distance'],
            max_solo_distance=config['max_solo_distance'],
            min_reward=config['min_reward'], device=device, **env_kwargs)

    return (env(config['formulas']),
            env(config.get('eval_formulas') or config['formulas']))


def initial_canvas(observation_space: ObservationSpace, atoms: Atoms,
                   what: str) -> Tuple[np.ndarray, np.ndarray]:
    """`atoms` pre-placed on an empty canvas: (element indices int64[N],
    positions float32[N, 3]). Raises ValueError when they leave no free
    slot or hold an element the space lacks; `what` names them."""
    n = observation_space.canvas_size
    if len(atoms) >= n:
        raise ValueError(f'{what} has {len(atoms)} atoms but the canvas '
                         f'holds only {n}; raise --canvas_size')
    elements = np.zeros(n, np.int64)
    positions = np.zeros((n, 3), np.float32)
    for i, atom in enumerate(atoms):
        if atom.z not in observation_space.z_to_index:
            raise ValueError(f'{what} element {atom.symbol} must be listed '
                             f'in --symbols')
        elements[i] = observation_space.z_to_index[atom.z]
        positions[i] = atom.position
    return elements, positions


def ppo_config_from(config: dict) -> PPOConfig:
    return PPOConfig(
        gamma=config['discount'], lam=config['lam'],
        clip_ratio=config['clip_ratio'], vf_coef=config['vf_coef'],
        entropy_coef=config['entropy_coef'], target_kl=config['target_kl'],
        gradient_clip=config['gradient_clip'],
        learning_rate=config['learning_rate'],
        max_num_train_iters=config['max_num_train_iters'],
        mini_batch_size=config['mini_batch_size'],
        amsgrad=config.get('optimizer', 'adam') == 'amsgrad')


def run_experiment(config: dict, env_builder: EnvBuilder = standard_envs,
                   device: DeviceLike = None, solvation: bool = False):
    """Trains as `config` says and returns (agent, optimizer). `device`
    (else config['device']) is cuda unless it names the CPU; without a
    visible card, cuda raises. `solvation` subtracts the distance penalty
    from every reward, in the env's step and in the pipelined transport.

    With --num_devices > 1 or --multihost the run is data-parallel
    (parallel/mesh.py): this process spawns its ranks, one card each on
    cuda (ValueError when there are too few), gloo processes on the CPU,
    and returns the trained agent and optimizer of its first rank, rebuilt
    on `device` (cuda: cuda:0, where that rank ran); a rank that torchrun
    started runs here. Every entry point that calls this gets the
    options."""
    check_supported(config)
    device = device if device is not None else config.get('device')
    launch = launch_from(config.get('num_devices'), config.get('multihost'))
    if launch is None:
        return _train(config, env_builder, resolve_device(device), solvation)
    shard_size(config['num_envs'], launch.world_size)
    if launch.local_ranks == 0:
        return _train_rank(config, env_builder, device, solvation,
                           launch.world_size)
    check_devices(launch.local_ranks, device)
    state = spawn(_spawned_rank, launch,
                  (config, env_builder, device, solvation, launch.world_size))
    space = ObservationSpace(canvas_size=config['canvas_size'],
                             zs=symbols_to_zs(config['symbols']))
    agent = build_model(config, space, device=resolve_device(device))
    agent.load_state_dict(state[0]['model'])
    optimizer = make_optimizer(ppo_config_from(config), agent)
    optimizer.load_state_dict(state[0]['optimizer'])
    return agent, optimizer


def _train_rank(config, env_builder, device, solvation, world_size):
    with make_mesh(world_size, device) as mesh:
        return _train(config, env_builder, mesh.device, solvation, mesh)


def _cpu(obj):
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    return obj.detach().cpu() if isinstance(obj, torch.Tensor) else obj


def _spawned_rank(config, env_builder, device, solvation, world_size):
    """A spawned rank's run; the first local rank returns its trained
    state on the CPU."""
    agent, optimizer = _train_rank(config, env_builder, device, solvation,
                                   world_size)
    if int(os.environ['LOCAL_RANK']):
        return None
    return {'model': _cpu(agent.state_dict()),
            'optimizer': _cpu(optimizer.state_dict())}


def load_checkpoint(config: dict, model_handler: ModelIO, agent,
                    optimizer, device: torch.device) -> int:
    """--load_latest / --load_model: the checkpoint's weights into `agent`
    and its optimizer state, where it has one, into `optimizer` (else the
    optimizer starts fresh); returns the steps to resume from, those in the
    checkpoint's name, or 0 when neither option is given. A checkpoint is
    the port's own file or a JAX orbax directory (ModelIO.load), carried
    over by the map of --model."""
    if not (config.get('load_latest') or config.get('load_model')):
        return 0
    kwargs = dict(map_location=device, family=config['model'],
                  template=agent.state_dict())
    if config.get('load_latest'):
        state, num_steps = model_handler.load_latest(**kwargs)
    else:
        state, num_steps = model_handler.load(config['load_model'], **kwargs)
    agent.load_state_dict(state['model'])
    if 'optimizer' in state:
        optimizer.load_state_dict(state['optimizer'])
    logging.info(f'Loaded a {state.get("format", "torch")} checkpoint at '
                 f'{num_steps} steps'
                 + ('' if 'optimizer' in state else
                    '; no optimizer state: the optimizer starts fresh'))
    return num_steps


def _train(config: dict, env_builder: EnvBuilder, device: torch.device,
           solvation: bool, mesh: Optional[Mesh] = None):
    """The run on `device`, in one process or in a data-parallel rank of
    `mesh`, where only a writer rank makes directories, logs to a file,
    evaluates and writes rollouts, metric streams, checkpoints and traces
    (rank-tagged rollouts under --multihost) and every rank reads the
    checkpoint it resumes from."""
    writer = mesh is None or mesh.writer
    # a host reward's calculator first: its library builds, or a missing
    # backend (scine) raises, before anything is written
    reward_fn, host_calc = make_reward_fn(config, solvation=solvation)
    tag = util.get_tag(config)
    if writer:
        util.create_directories([config['log_dir'], config['model_dir'],
                                 config['data_dir'], config['results_dir']])
        util.setup_logger(config, directory=config['log_dir'], tag=tag)
        util.save_config(config, directory=config['log_dir'], tag=tag)
    else:
        util.setup_logger(dict(config, log_level='WARNING'), directory=None,
                          tag=tag)
    util.set_seeds(config['seed'])
    logging.info(f'Device: {device}' + (
        f' ({torch.cuda.get_device_name(device)})' if device.type == 'cuda'
        else ''))
    if mesh is not None:
        logging.info(f'Data-parallel rank {mesh.rank} of {mesh.world_size} '
                     f'({mesh.backend}), process {mesh.process}')

    observation_space = ObservationSpace(canvas_size=config['canvas_size'],
                                         zs=symbols_to_zs(config['symbols']))
    train_env, eval_env = env_builder(config, observation_space, reward_fn,
                                      device)

    agent = build_model(config, observation_space, device=device)
    logging.info(f'Model parameters: {util.count_params(agent)}')
    ppo_config = ppo_config_from(config)
    optimizer = make_optimizer(ppo_config, agent)

    model_handler = ModelIO(directory=config['model_dir'], tag=tag,
                            keep=config.get('keep_models', False))
    start_num_steps = load_checkpoint(config, model_handler, agent,
                                      optimizer, device)

    save_mode = config.get('save_rollouts', 'none')
    rollout_saver = (util.RolloutSaver(
        directory=config['data_dir'], tag=tag,
        rank=mesh.process if mesh is not None and config.get('multihost')
        else None) if writer and save_mode != 'none' else None)
    info_saver = (util.InfoSaver(
        directory=config['results_dir'], tag=tag,
        tensorboard_dir=(os.path.join(config['log_dir'], 'tb')
                         if config.get('tensorboard') else None))
        if writer else None)

    try:
        result = batch_ppo(
            train_env, eval_env if writer else None, agent,
            optimizer=optimizer,
            num_envs=config['num_envs'],
            num_eval_envs=1,
            config=ppo_config,
            start_num_steps=start_num_steps,
            max_num_steps=config['max_num_steps'],
            num_steps_per_iter=config['num_steps_per_iter'],
            save_freq=config['save_freq'],
            eval_freq=config['eval_freq'],
            # one greedy episode per eval formula by default
            num_eval_episodes=(config.get('num_eval_episodes')
                               or int(eval_env.formulas.shape[0])),
            eval_sample_k=config.get('eval_sample_k', 0) or 0,
            model_handler=model_handler if writer else None,
            rollout_saver=rollout_saver,
            save_train_rollout=save_mode in ('train', 'all'),
            save_eval_rollout=save_mode in ('eval', 'all'),
            info_saver=info_saver,
            seed=config['seed'],
            profile_dir=(os.path.join(config['log_dir'], 'profile')
                         if config.get('profile') and writer else None),
            mesh=mesh,
            **host_transport(config.get('host_reward_mode', 'auto'),
                             host_calc),
            host_distance_penalty=distance_penalty(config, solvation),
            host_reward_timer=host_calc,
        )
    finally:
        if info_saver is not None:
            info_saver.close()
    if host_calc is not None:
        logging.info(f'Host reward pool stats: {host_calc.pool_stats()}')
    return result
