"""Host-facing vectorized environment (counterpart of
molgym_tpu/envs/vec_env.py): the VecEnv API (reset, step, step_async,
step_wait, reset_if_terminal, get_size) over the batched MolecularEnv, for
drivers, notebooks and tests. The PPO loop does not go through it: it calls
the env's methods itself.

The JAX VecEnv splits a PRNG key per reset; here one explicit
`torch.Generator` on the env's device, seeded with `seed`, draws every bag
a stochastic-bag env samples. Observations stay on the env's device;
rewards and dones come back as numpy arrays.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from molgym_tpu_torch.envs.environment import EnvState, MolecularEnv
from molgym_tpu_torch.spaces import Observation


class VecEnv:
    def __init__(self, env: MolecularEnv, num_envs: int, seed: int = 0) -> None:
        self.env = env
        self.num_envs = num_envs
        self.generator = torch.Generator(device=env.device).manual_seed(seed)
        self._states: Optional[EnvState] = None
        self._actions = None

    @property
    def device(self) -> torch.device:
        return self.env.device

    def get_size(self) -> int:
        return self.num_envs

    @property
    def states(self) -> EnvState:
        if self._states is None:
            raise RuntimeError('call reset() first')
        return self._states

    def reset(self) -> Observation:
        self._states = self.env.init_states(self.num_envs, self.generator)
        return self._states.observation()

    def step_async(self, actions) -> None:
        self._actions = actions

    def step_wait(self) -> Tuple[Observation, np.ndarray, np.ndarray, dict]:
        if self._actions is None:
            raise RuntimeError('call step_async() first')
        actions, self._actions = self._actions, None
        return self.step(actions)

    def step(self, actions) -> Tuple[Observation, np.ndarray, np.ndarray, dict]:
        """actions: (element index int[B], position float[B, 3]), as arrays
        or tensors, or an object with .element and .position (an agent's
        output). Returns the observation, rewards float32[B], dones bool[B]
        and {'elapsed_time': seconds of the whole step, reward included}."""
        if hasattr(actions, 'element'):
            element, position = actions.element, actions.position
        else:
            element, position = actions
        start = time.perf_counter()
        result = self.env.step(
            self.states, torch.as_tensor(element, device=self.device).long(),
            torch.as_tensor(position, dtype=torch.float32, device=self.device))
        reward = result.reward.cpu().numpy()   # waits for the device
        done = result.done.cpu().numpy()
        self._states = result.state
        info = {'elapsed_time': time.perf_counter() - start}
        return result.observation, reward, done, info

    def reset_if_terminal(self, dones) -> Observation:
        """Reset the envs whose `dones` are set, leave the others."""
        dones = torch.as_tensor(dones, dtype=torch.bool, device=self.device)
        self._states, obs = self.env.reset_if_terminal(self.states, dones,
                                                       self.generator)
        return obs
