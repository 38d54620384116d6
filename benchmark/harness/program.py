"""The system under test: the PyTorch port's environment, agent, optimizer,
rollout and PPO update, built by the port's own entry code from a
configuration's recorded flags and a traffic mix's batch. Nothing here
computes; it only builds and hands over."""
from __future__ import annotations

import importlib

import torch


def _resolve(path: str):
    module, name = path.split(':')
    return getattr(importlib.import_module(module), name)


class Program:
    """The port's objects for one cell: `env`, `agent`, `optimizer`,
    `rollout(agent, states, generator)`, `train(data, generator)`,
    `compute_ppo_data(traj, gamma, lam)` and `ppo` (its PPOConfig);
    `losses`, each loss that `train` has computed since it was last
    cleared, as the tensor the program reports it in (read without a
    synchronize)."""

    def __init__(self, config: dict, traffic: dict, device: torch.device):
        from molgym_tpu_torch.rl import ppo
        from molgym_tpu_torch.rl.buffer import compute_ppo_data
        from molgym_tpu_torch.rl.ppo import make_optimizer
        from molgym_tpu_torch.rl.rollout import make_rollout_fn
        from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
        from molgym_tpu_torch.tools.driver import (make_reward_fn,
                                                     ppo_config_from)
        from molgym_tpu_torch.tools.model_util import build_model

        torch.backends.cuda.matmul.allow_tf32 = bool(config['tf32'])
        torch.backends.cudnn.allow_tf32 = bool(config['tf32'])
        num_envs, steps = traffic['num_envs'], traffic['steps_per_env']
        flags = dict(config, num_envs=num_envs, num_steps_per_iter=num_envs * steps,
                     mini_batch_size=traffic.get('mini_batch_size',
                                                 config['mini_batch_size']))
        space = ObservationSpace(canvas_size=flags['canvas_size'],
                                 zs=symbols_to_zs(flags['symbols']))
        reward_fn, host = make_reward_fn(flags)
        if host is not None:
            raise ValueError('the benchmark drives device rewards only')
        self.env, _eval_env = _resolve(config['env_builder'])(
            flags, space, reward_fn, device)
        self.agent = build_model(flags, space, device=device)
        self.ppo = ppo_config_from(flags)
        self.optimizer = make_optimizer(self.ppo, self.agent)
        self.rollout = make_rollout_fn(self.env, self.agent, steps)
        self.samples = num_envs * steps
        self.losses = []
        self.build_train(ppo.make_loss_fn)
        self.compute_ppo_data = compute_ppo_data
        self.num_envs, self.steps = num_envs, steps

    def build_train(self, make_loss_fn):
        """`train` as the port's make_train_fn builds it around the loss of
        `make_loss_fn`, each loss it computes kept in `losses`."""
        from molgym_tpu_torch.rl import ppo

        def keeping(agent, config):
            loss_fn = make_loss_fn(agent, config)

            def kept(*args, **kwargs):
                loss, info = loss_fn(*args, **kwargs)
                self.losses.append(info['total_loss'])
                return loss, info
            return kept
        make, ppo.make_loss_fn = ppo.make_loss_fn, keeping
        try:
            self.train = ppo.make_train_fn(self.agent, self.optimizer, self.ppo,
                                           self.samples)
        finally:
            ppo.make_loss_fn = make
