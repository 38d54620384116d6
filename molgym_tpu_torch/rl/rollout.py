"""Rollouts (counterpart of molgym_tpu/rl/rollout.py): all envs are reset at
rollout start, stepped T times with auto-reset at terminals, and the value
head on the final observation gives the bootstrap value. The JAX
`lax.scan` becomes a Python loop; the rollout runs without autograd. A
stochastic-bag env draws its bags from the rollout's generator. The
generator is a torch.Generator, or a data-parallel rank's Draws
(draws.py), which draws every random number for the global batch and keeps
the rank's rows: W ranks then step what one process steps.

Two transports for a host reward (calculators/reward_host.py), each with
the (params_or_module, states, generator) -> (states, Trajectory) contract
and the same trajectory, bit for bit, from one generator state:
  * make_rollout_fn                — in step: the env's reward function
                                     copies its inputs to the host itself
                                     (the JAX package's io_callback and its
                                     serial host loop alike)
  * make_pipelined_host_rollout_fn — the host reward batch runs on a worker
                                     thread while the next policy forward
                                     runs on the device (SURVEY §7 hard-part
                                     3). The next state depends on the
                                     reward only through the `reward <
                                     min_reward` termination, so the next
                                     forward is computed speculatively with
                                     rewards of 0, and computed again from
                                     the same generator state on the steps
                                     where that guessed another `done`.
Both draw from the generator in the same order: the policy's draws of step
t, then the auto-reset's (a stochastic-bag env's bags), then step t + 1's.
The pipelined transport speculates from a copy of the generator's state and
leaves the generator where the in-step order does.

make_auto_host_rollout_fn measures the two on the first warm calls and keeps
the faster (AutoTransportRollout), as the JAX package's
--host_reward_mode=auto does on a backend without io_callback.
"""
from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from molgym_tpu_torch.calculators.reward_host import (host_rewards,
                                                      inputs_to_host)
from molgym_tpu_torch.draws import Rng
from molgym_tpu_torch.envs.environment import EnvState, MolecularEnv
from molgym_tpu_torch.rl.buffer import Trajectory
from molgym_tpu_torch.spaces import Observation


def _module(agent: nn.Module, params) -> nn.Module:
    if isinstance(params, nn.Module):
        return params
    agent.load_state_dict(params)
    return agent


class _Recorder:
    """The per-step tensors of a rollout, stacked into a Trajectory."""

    def __init__(self):
        self.obs, self.next_obs = [], []
        self.act, self.rew, self.term, self.val, self.logp = [], [], [], [], []

    def add(self, obs, out, result) -> None:
        self.obs.append(obs)
        self.next_obs.append(result.observation)
        self.act.append(out.action_flat)
        self.rew.append(result.reward)
        self.term.append(result.done)
        self.val.append(out.v)
        self.logp.append(out.logp)

    def trajectory(self, bootstrap_value: torch.Tensor) -> Trajectory:
        return Trajectory(obs=Observation.stack(self.obs),
                          next_obs=Observation.stack(self.next_obs),
                          actions=torch.stack(self.act),
                          rewards=torch.stack(self.rew),
                          terminals=torch.stack(self.term),
                          values=torch.stack(self.val),
                          logps=torch.stack(self.logp),
                          bootstrap_value=bootstrap_value)


def make_rollout_fn(env: MolecularEnv, agent: nn.Module,
                    num_steps_per_env: int,
                    deterministic: bool = False) -> Callable:
    """Returns rollout(params_or_module, states, generator) ->
    (states, Trajectory). `params_or_module` is the agent itself (or another
    module of its kind) or a state_dict to load into `agent` first.
    `deterministic` takes the policy's mode at every step (greedy
    evaluation) instead of sampling."""

    def rollout(params, states: EnvState,
                generator: Rng) -> Tuple[EnvState, Trajectory]:
        module = _module(agent, params)
        rec = _Recorder()
        with torch.no_grad():
            states, obs = env.reset(states, generator)
            for _ in range(num_steps_per_env):
                out = module.act(obs, generator, deterministic)
                result = env.step(states, out.element, out.position)
                rec.add(obs, out, result)
                states, obs = env.reset_if_terminal(
                    result.state, result.done, generator)
            final_out = module.act(obs, generator, True)
        return states, rec.trajectory(final_out.v)

    rollout.transport = 'in_step'
    return rollout


def make_pipelined_host_rollout_fn(env: MolecularEnv, agent: nn.Module,
                                   batch_calculator, num_steps_per_env: int,
                                   deterministic: bool = False,
                                   distance_penalty: float = 0.0) -> Callable:
    """Host-reward rollout with the reward batch overlapped against the next
    policy forward (see the module docstring for why it is exact).
    `env.reward_fn` is not called: the rewards are `batch_calculator`'s,
    less `distance_penalty` * |new position|, as `make_host_reward`'s.

    Per step: copy the reward inputs to the host (this synchronises with the
    device), hand the numpy arrays to a worker thread (the library's ctypes
    call releases the interpreter lock, and its pool fans out over the
    cores), then enqueue the speculative state update, auto-reset and next
    forward on the device from a copy of the generator's state, then join the
    reward and finalize. The rollout function's `recomputes` is the number
    of forwards its last call computed again: one per step, not the last,
    whose real rewards ended another set of episodes than rewards of 0
    would have (a reward below min_reward, whatever its sign)."""
    executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix='mg_reward')

    def rollout(params, states: EnvState,
                generator: Rng) -> Tuple[EnvState, Trajectory]:
        module = _module(agent, params)
        rec = _Recorder()
        rollout.recomputes = 0
        with torch.no_grad():
            states, obs = env.reset(states, generator)
            device = obs.elements.device
            out = module.act(obs, generator, deterministic)
            for t in range(num_steps_per_env):
                element = out.element.long()
                stop, valid, needs, zs_atomic, new_z = env.reward_inputs(
                    states, element, out.position)
                host = inputs_to_host(states.positions, zs_atomic,
                                      out.position, new_z, needs)
                future = executor.submit(host_rewards, batch_calculator,
                                         distance_penalty, *host)
                last = t + 1 == num_steps_per_env
                if not last:
                    before_reset = generator.get_state()
                    spec = env.finalize_step(states, element, out.position,
                                             stop, valid,
                                             torch.zeros_like(out.v))
                    _spec_states, spec_obs = env.reset_if_terminal(
                        spec.state, spec.done, generator)
                    out_next = module.act(spec_obs, generator, deterministic)
                    after_act = generator.get_state()
                    generator.set_state(before_reset)
                rewards = future.result().astype(np.float32)
                result = env.finalize_step(
                    states, element, out.position, stop, valid,
                    torch.from_numpy(rewards).to(device))
                rec.add(obs, out, result)
                states, obs = env.reset_if_terminal(result.state, result.done,
                                                    generator)
                if not last:
                    # the reward reaches the next state only through `done`:
                    # with the same dones the speculative state, reset (whose
                    # draws depend on the batch size alone) and forward are
                    # the real ones
                    if torch.equal(spec.done, result.done):
                        generator.set_state(after_act)
                    else:
                        out_next = module.act(obs, generator, deterministic)
                        rollout.recomputes += 1
                    out = out_next
            final_out = module.act(obs, generator, True)
        return states, rec.trajectory(final_out.v)

    rollout.recomputes = 0
    rollout.transport = 'pipelined'
    return rollout


def sync(device: torch.device) -> None:
    """Waits for the work queued on `device` (a card; the CPU has none)."""
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class AutoTransportRollout:
    """Measured choice between host-reward transports (counterpart of the
    JAX package's AutoTransportRollout). Which is faster depends on the
    reward: a cheap one (EHT, or a cached geometry) gains little from the
    overlap and pays the pipelined loop's speculative work, an expensive one
    (PM6's SCF) hides the policy's forward behind it. So each transport runs
    once untimed (calls 0 and 1: the warm-up, which builds the kernels and
    fills the host energy cache), once timed (calls 2 and 3), and the faster
    is kept for every later call. The transports give the same trajectory
    from one generator state, so the choice changes only the time.

    `fns` maps a transport's name to its rollout function, with the
    (params_or_module, states, generator) -> (states, Trajectory) contract;
    their order is the probe order. `transport`, as a rollout function's,
    names the next call's. The clock stops after the device has
    finished the call's work, which the pipelined transport leaves queued.
    With a `mesh` (parallel/mesh.py) the timed seconds are the MAX over the
    ranks (one all-reduce at lock-in), so that every rank keeps the same
    transport. `recomputes` is the last call's transport's, None where it
    has none (the in-step transport)."""

    def __init__(self, fns: Dict[str, Callable], mesh=None):
        self._fns = dict(fns)
        if len(self._fns) < 2:
            raise ValueError('a choice needs two transports at least')
        self._order = list(self._fns)
        self._calls = 0
        self._mesh = mesh
        self.times: Dict[str, float] = {}
        self.choice = None
        self.recomputes = None

    def current_transport(self) -> str:
        """The transport of the next call."""
        if self.choice is not None:
            return self.choice
        return self._order[self._calls % len(self._order)]

    @property
    def transport(self) -> str:
        return self.current_transport()

    def __call__(self, params, states: EnvState,
                 generator: Rng) -> Tuple[EnvState, Trajectory]:
        name = self.current_transport()
        fn = self._fns[name]
        if self.choice is not None:
            out = fn(params, states, generator)
            self.recomputes = getattr(fn, 'recomputes', None)
            return out
        t0 = time.perf_counter()
        states, traj = fn(params, states, generator)
        sync(traj.rewards.device)
        # each transport's first call is a warm-up, its second is timed
        if self._calls >= len(self._order):
            self.times[name] = time.perf_counter() - t0
        self._calls += 1
        self.recomputes = getattr(fn, 'recomputes', None)
        if len(self.times) == len(self._order):
            self._lock_in()
        return states, traj

    def _lock_in(self) -> None:
        if self._mesh is not None:
            self.times = dict(zip(self.times, self._mesh.all_reduce_max(
                list(self.times.values()))))
        self.choice = min(self.times, key=self.times.__getitem__)
        logging.info(f'host-reward transport auto-selected {self.choice!r} ('
                     + ', '.join(f'{n}: {t * 1e3:.3f} ms'
                                 for n, t in self.times.items()) + ')')


def make_auto_host_rollout_fn(env: MolecularEnv, agent: nn.Module,
                              batch_calculator, num_steps_per_env: int,
                              deterministic: bool = False,
                              distance_penalty: float = 0.0,
                              mesh=None) -> AutoTransportRollout:
    """The measured choice between the pipelined host loop and the in-step
    transport (make_rollout_fn over `env`, whose reward function must then
    be make_host_reward(batch_calculator, distance_penalty)), probed in the
    JAX package's order: pipelined first. The in-step transport is the
    port's counterpart of the JAX package's `serial` host loop: the same
    work in the same order, so it keeps the port's name, `in_step`."""
    return AutoTransportRollout({
        'pipelined': make_pipelined_host_rollout_fn(
            env, agent, batch_calculator, num_steps_per_env, deterministic,
            distance_penalty),
        'in_step': make_rollout_fn(env, agent, num_steps_per_env,
                                   deterministic),
    }, mesh=mesh)
