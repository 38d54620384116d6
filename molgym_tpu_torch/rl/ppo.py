"""Proximal Policy Optimization (counterpart of molgym_tpu/rl/ppo.py), with
the same training semantics:

  * clipped surrogate + value MSE + entropy bonus
  * gradients ACCUMULATE (sum) across all minibatches of an epoch, with ONE
    clipped optimizer step per epoch
  * the epoch loop stops when the epoch's mean approx-KL exceeds
    1.5 * target_kl, checked on the pre-step parameters BEFORE the step: the
    epoch that trips it computed its gradients but does not step, and the
    reported info comes from the last epoch that stepped
  * minibatches are a fresh permutation each epoch; the remainder forms a
    final batch padded with zero-weight samples, and each minibatch's
    weights are normalized by max(sum of weights, 1)

The JAX package compiles the update as one XLA program (lax.scan over epochs
with an `active` flag); here it is a Python loop over epochs and minibatches
with autograd that breaks at the KL stop. The optimizer is optax's
clip_by_global_norm followed by adam or amsgrad, written out (see
`Optimizer`).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from molgym_tpu_torch.draws import Rng, as_draws
from molgym_tpu_torch.envs.environment import MolecularEnv
from molgym_tpu_torch.rl.buffer import (buffer_stats, compute_ppo_data,
                                        episode_stats)
from molgym_tpu_torch.rl.rollout import (AutoTransportRollout,
                                         make_auto_host_rollout_fn,
                                         make_pipelined_host_rollout_fn,
                                         make_rollout_fn, sync)

INFO_KEYS = ('policy_loss', 'entropy_loss', 'vf_loss', 'total_loss',
             'approx_kl', 'clip_fraction')


class PPOConfig(NamedTuple):
    gamma: float = 0.99
    lam: float = 0.97
    clip_ratio: float = 0.2
    vf_coef: float = 0.5
    entropy_coef: float = 0.0
    target_kl: float = 0.01
    gradient_clip: float = 0.5
    learning_rate: float = 3e-4
    max_num_train_iters: int = 80
    mini_batch_size: int = 64
    amsgrad: bool = False


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Optimizer:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr) or amsgrad(lr))
    over the named parameters of a module, with optax's defaults (b1 0.9,
    b2 0.999, eps 1e-8, eps_root 0).

    Written out because the obvious torch calls differ from optax:
    `clip_grad_norm_` scales by max_norm / (norm + 1e-6), optax by
    max_norm / norm and only when norm >= max_norm; torch's AMSGrad keeps the
    maximum of the raw second moment, optax the maximum of the bias-corrected
    one. The state mirrors optax's ScaleByAdamState (count, mu, nu) and, for
    amsgrad, ScaleByAmsgradState's nu_max."""

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]],
                 learning_rate: float, max_norm: float, amsgrad: bool = False,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params: Dict[str, nn.Parameter] = dict(named_params)
        self.learning_rate = learning_rate
        self.max_norm = max_norm
        self.amsgrad = amsgrad
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.nu_max = ({k: torch.zeros_like(p) for k, p in self.params.items()}
                       if amsgrad else None)

    def _bias_correction(self, decay: float) -> float:
        # optax computes 1 - decay**count in float32
        return float(np.float32(1.0) - np.float32(decay) ** np.float32(self.count))

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update of every parameter from its gradient in `grads`."""
        norm = global_norm(grads.values())
        keep = norm < self.max_norm
        self.count += 1
        c1 = self._bias_correction(self.b1)
        c2 = self._bias_correction(self.b2)
        for name, p in self.params.items():
            g = grads[name]
            g = torch.where(keep, g, (g / norm) * self.max_norm)
            mu, nu = self.mu[name], self.nu[name]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            nu_hat = nu / c2
            if self.nu_max is not None:
                nu_hat = torch.maximum(self.nu_max[name], nu_hat)
                self.nu_max[name].copy_(nu_hat)
            p.add_((mu / c1) / (torch.sqrt(nu_hat) + self.eps) *
                   -self.learning_rate)

    def state_dict(self) -> dict:
        out = {'count': self.count, 'mu': dict(self.mu), 'nu': dict(self.nu)}
        if self.nu_max is not None:
            out['nu_max'] = dict(self.nu_max)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if ('nu_max' in state) != self.amsgrad:
            raise ValueError('optimizer state of '
                             f'{"amsgrad" if "nu_max" in state else "adam"} '
                             f'for an {"amsgrad" if self.amsgrad else "adam"} '
                             'optimizer')
        self.count = int(state['count'])
        for key in ('mu', 'nu') + (('nu_max', ) if self.amsgrad else ()):
            ours = getattr(self, key)
            if set(state[key]) != set(ours):
                raise KeyError(f'optimizer state {key}: parameter names '
                               'differ from the model\'s')
            for name, t in ours.items():
                t.copy_(state[key][name])


def make_optimizer(config: PPOConfig, agent: nn.Module) -> Optimizer:
    """clip-by-global-norm + (ams)adam over the agent's parameters."""
    return Optimizer(agent.named_parameters(), config.learning_rate,
                     config.gradient_clip, amsgrad=config.amsgrad)


def make_loss_fn(agent: nn.Module, config: PPOConfig) -> Callable:
    """loss_fn(obs, act, old_logp, adv, ret, weights, norm=None) ->
    (loss, info) at the agent's current parameters; info values are
    detached. The weights are divided by `norm`, by default
    max(sum of weights, 1): a data-parallel rank's chunk of a minibatch
    passes the whole minibatch's."""

    def loss_fn(obs, act, old_logp, adv, ret, weights, norm=None):
        logp, ent, v = agent.evaluate(obs, act)
        if norm is None:
            norm = weights.sum().clamp(min=1.0)
        w = weights / norm
        ratio = torch.exp(logp - old_logp)
        obj = ratio * adv
        clipped_obj = ratio.clamp(1 - config.clip_ratio,
                                  1 + config.clip_ratio) * adv
        policy_loss = -(w * torch.minimum(obj, clipped_obj)).sum()
        entropy_loss = -config.entropy_coef * (w * ent).sum()
        vf_loss = config.vf_coef * (w * torch.square(v - ret)).sum()
        loss = policy_loss + entropy_loss + vf_loss
        with torch.no_grad():
            approx_kl = (w * (old_logp - logp)).sum()
            clipped = ((ratio < 1 - config.clip_ratio) |
                       (ratio > 1 + config.clip_ratio))
            clip_fraction = (w * clipped.to(w.dtype)).sum()
        info = dict(policy_loss=policy_loss.detach(),
                    entropy_loss=entropy_loss.detach(),
                    vf_loss=vf_loss.detach(), total_loss=loss.detach(),
                    approx_kl=approx_kl, clip_fraction=clip_fraction)
        return loss, info

    return loss_fn


def make_train_fn(agent: nn.Module, optimizer: Optimizer, config: PPOConfig,
                  num_samples: int, mesh=None) -> Callable:
    """Returns train(data, generator) -> info, which updates the agent's
    parameters and the optimizer state in place. num_samples = T * B.
    `generator` is a torch.Generator or a rank's Draws (draws.py); each
    epoch's permutation of the samples is drawn from the generator under
    it.

    info holds the losses of the last epoch that stepped, its grad_norm,
    num_opt_steps, and num_grad_passes: the epochs whose gradients were
    computed (the steps, plus one when the KL stop fired).

    With a `mesh` (parallel/mesh.py) every rank holds the same global
    `data` and the same generator state: each rank draws the epoch's
    permutation itself, the same on every rank, runs the r-th of W
    contiguous chunks of each minibatch (normalized by the whole
    minibatch's weight sum), and the epoch's summed gradients and loss sums
    are all-reduced (SUM) in one collective before the KL check, so that
    every rank takes the same decision and the same step."""
    loss_fn = make_loss_fn(agent, config)
    params = optimizer.params
    mb = min(config.mini_batch_size, num_samples)
    num_batches = -(-num_samples // mb)
    pad = num_batches * mb - num_samples

    def epoch_grads(data, generator):
        device = data['adv'].device
        perm = torch.randperm(num_samples,
                              generator=as_draws(generator).generator,
                              device=device)
        # pad with arbitrary (weight-0) indices so every batch has size mb
        idx = (torch.cat([perm, perm[:pad]]) if pad else perm).reshape(
            num_batches, mb)
        weights = torch.ones((num_batches, mb), device=device)
        if pad:
            weights[-1, mb - pad:] = 0.0
        for p in params.values():
            p.grad = None
        info_sum = dict.fromkeys(INFO_KEYS, 0.0)
        for b in range(num_batches):
            i, w = idx[b], weights[b]
            norm = w.sum().clamp(min=1.0)
            if mesh is not None:
                i, w = (torch.tensor_split(x, mesh.world_size)[mesh.rank]
                        for x in (i, w))
                if not len(i):   # fewer samples in a minibatch than ranks
                    continue
            loss, info = loss_fn(data['obs'].map(lambda x: x[i]),
                                 data['act'][i], data['logp'][i],
                                 data['adv'][i], data['ret'][i], w, norm)
            loss.backward()   # sums into .grad over the epoch's minibatches
            info_sum = {k: info_sum[k] + info[k] for k in INFO_KEYS}
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if mesh is not None:
            sums = torch.stack([torch.as_tensor(info_sum[k], device=device)
                                for k in INFO_KEYS])
            *reduced, sums = mesh.all_reduce_sum(list(grads.values())
                                                 + [sums])
            grads = dict(zip(grads, reduced))
            info_sum = dict(zip(INFO_KEYS, sums))
        return grads, {k: v / num_batches for k, v in info_sum.items()}

    def train(data, generator: Rng) -> Dict[str, float]:
        last_info = dict.fromkeys(INFO_KEYS + ('grad_norm', ), 0.0)
        num_opt_steps = num_grad_passes = 0
        for _ in range(config.max_num_train_iters):
            grads, info = epoch_grads(data, generator)
            num_grad_passes += 1
            info['grad_norm'] = global_norm(grads.values())
            info = {k: float(v) for k, v in info.items()}
            if not info['approx_kl'] <= 1.5 * config.target_kl:
                break
            optimizer.step(grads)
            num_opt_steps += 1
            last_info = info
        for p in params.values():
            p.grad = None
        return dict(last_info, num_opt_steps=num_opt_steps,
                    num_grad_passes=num_grad_passes)

    return train


def _episodes(traj, gamma: float) -> Tuple[list, list]:
    return episode_stats(traj.rewards.cpu().numpy(),
                         traj.terminals.cpu().numpy(), gamma)


def _episode_info(returns: list, lengths: list) -> dict:
    nan = float('nan')
    return {
        'return_mean': float(np.mean(returns)) if returns else nan,
        'return_std': float(np.std(returns)) if returns else nan,
        'episode_length_mean': float(np.mean(lengths)) if lengths else nan,
        'episode_length_std': float(np.std(lengths)) if lengths else nan,
    }


def _make_rollout(env, agent, num_steps, deterministic, calculator,
                  pipelined, distance_penalty, mesh=None):
    """A rollout function: in step without a host-loop calculator or with
    `pipelined` False; with one, the pipelined host loop (whose rewards are
    less distance_penalty * |new position|) where `pipelined` is True, and
    the measured choice between the two (AutoTransportRollout) where it is
    'auto'."""
    if calculator is None or pipelined is False:
        return make_rollout_fn(env, agent, num_steps, deterministic)
    if pipelined == 'auto':
        return make_auto_host_rollout_fn(env, agent, calculator, num_steps,
                                         deterministic, distance_penalty,
                                         mesh)
    return make_pipelined_host_rollout_fn(env, agent, calculator, num_steps,
                                          deterministic, distance_penalty)


class _Following:
    """The evaluation rollout under a selector: it steps in the selector's
    choice, pipelined until there is one (the transports give the same
    trajectory, so this is a matter of time only), through one rollout
    function per transport, `make(pipelined)`'s, built at its first use.
    `recomputes` is its last call's."""

    def __init__(self, selector: AutoTransportRollout, make: Callable):
        self.selector, self.make = selector, make
        self.fns = {}
        self.recomputes = None

    @property
    def transport(self) -> str:
        return self.selector.choice or 'pipelined'

    def __call__(self, params, states, generator):
        name = self.transport
        if name not in self.fns:
            self.fns[name] = self.make(name == 'pipelined')
        out = self.fns[name](params, states, generator)
        self.recomputes = getattr(self.fns[name], 'recomputes', None)
        return out


def eval_rollout_size(num_eval_episodes: int, eval_sample_k: int,
                      canvas_size: int) -> Tuple[int, int]:
    """(episodes, steps) of batch_ppo's evaluation rollout: K =
    eval_sample_k episodes per eval episode (one when greedy). Every episode
    ends within canvas_size + 1 steps (each step places an atom or ends the
    episode), so this many steps with auto-reset complete at least the
    required episodes; the first are kept."""
    episodes = num_eval_episodes * max(1, eval_sample_k)
    return episodes, episodes * (canvas_size + 1)


def eval_seed(seed: int) -> int:
    """The seed of the evaluation's generator: a stream apart from the
    training one (seeded with `seed`), as the JAX package's eval_key, so
    that the training draws do not depend on whether or how often a rank
    evaluates."""
    return int(np.random.SeedSequence((seed, 1)).generate_state(
        1, np.uint64)[0])


def start_rollouts(envs: MolecularEnv, num_envs: int, optimizer: Optimizer,
                   seed: int, mesh=None) -> Tuple[object, Rng]:
    """(env states, generator) of the calling rank at the start of training:
    a generator seeded with `seed`, on every rank alike, and the initial
    states of the rank's envs drawn from it. Without a mesh the generator is
    a torch.Generator and the states are all `num_envs`; with one, it is the
    rank's Draws (mesh.draws), which draws for all `num_envs` and keeps the
    rank's shard, so that W ranks hold what one process holds; rank 0's
    parameters and optimizer state then go to every replica. batch_ppo and
    parallel.mesh.make_dp_ppo_iteration start here."""
    device = next(iter(optimizer.params.values())).device
    generator = torch.Generator(device=device).manual_seed(seed)
    if mesh is None:
        return envs.init_states(num_envs, generator), generator
    draws = mesh.draws(generator, num_envs)
    states = envs.init_states(mesh.shard(num_envs), draws)
    mesh.broadcast_optimizer_(optimizer)
    return states, draws


def batch_ppo(
    envs: MolecularEnv,
    eval_envs: Optional[MolecularEnv],
    agent: nn.Module,
    *,
    optimizer: Optional[Optimizer] = None,
    num_envs: int,
    num_eval_envs: int = 1,
    config: PPOConfig = PPOConfig(),
    start_num_steps: int = 0,
    max_num_steps: int = 4096,
    num_steps_per_iter: int = 200,
    save_freq: int = 5,
    eval_freq: int = 10,
    num_eval_episodes: int = 1,
    model_handler=None,
    rollout_saver=None,
    save_train_rollout: bool = False,
    save_eval_rollout: bool = True,
    info_saver=None,
    seed: int = 0,
    profile_dir: Optional[str] = None,
    mesh=None,
    host_loop_calculator=None,
    host_loop_pipelined=True,
    host_distance_penalty: float = 0.0,
    host_reward_timer=None,
    eval_sample_k: int = 0,
) -> Tuple[nn.Module, Optimizer]:
    """Top-level PPO loop: alternate the rollout and the multi-epoch update
    on the agent's device, with JSONL metrics, periodic evaluation and
    checkpointing on the host. Returns the trained agent and its optimizer.

    The training rollouts and the update draw from a generator seeded with
    `seed`; the evaluation envs' states and every evaluation from a second
    one, seeded with eval_seed(seed).

    With a `mesh` (parallel/mesh.py) this runs in one data-parallel rank:
    it steps envs [r * B / W, (r + 1) * B / W), drawing every random number
    for all B envs from the same training generator as every other rank and
    keeping its rows (start_rollouts), starts from rank 0's parameters and
    optimizer state, gathers every rollout into the global trajectory, and
    runs the update of make_train_fn(mesh=...). So the run does not depend
    on W: W ranks compute what one process computes from the same seed and
    weights, up to the float order of the policy's forward over B / W rows
    against B (at W = 1, bit for bit). Only a writer rank evaluates and
    writes: the caller passes eval_envs, the savers, the model handler and
    profile_dir on writer ranks only. A writer's `reward_time` and
    `recomputes` are its own rollout's.

    `profile_dir` traces iteration 1 (the second, after the first's warm-up)
    with torch.profiler, the host and (on a card) the device, into
    `{profile_dir}/iteration-1.trace.json` (Chrome's trace format).

    A host reward runs in the env's step (the env's reward function is a
    `make_host_reward`) unless `host_loop_calculator` is given: then the
    training and evaluation rollouts step, as `host_loop_pipelined` says
    (the JAX package's flag), in the pipelined host loop over that batch
    calculator (True), less `host_distance_penalty` * |new position| (the
    solvation penalty, which the env's reward function applies in the
    in-step transport), in the env's step (False), or in the faster of the
    two ('auto': AutoTransportRollout measures both on the first warm
    iterations, and the evaluation follows its choice, pipelined until
    there is one; under a mesh every rank keeps the same).
    The port has no serial host loop: a step can always reach the host, so
    the in-step transport does the JAX serial loop's work in its order.
    `host_reward_timer` (a TimedBatchCalculator) adds `reward_time`, the
    seconds spent in the host reward during the training rollout, to the
    train info. The train and eval infos' `transport` names the rollout's
    transport (in_step or pipelined), and `recomputes` counts the pipelined
    transport's forwards computed again after a low-reward termination.

    eval_sample_k = 0 (default) evaluates greedily; K > 0 samples K episodes
    per eval formula and adds `return_best_mean`, the mean over formulas of
    each formula's best return.

    The opt stream's `iteration_time` is the rollout plus the update, host
    clock, synchronized."""
    if num_steps_per_iter % num_envs != 0:
        raise ValueError('num_steps_per_iter must be divisible by num_envs')
    steps_per_env = num_steps_per_iter // num_envs
    device = next(agent.parameters()).device

    if optimizer is None:
        optimizer = make_optimizer(config, agent)
    rollout_fn = _make_rollout(
        envs, agent, steps_per_env, False, host_loop_calculator,
        host_loop_pipelined, host_distance_penalty, mesh)
    train_fn = make_train_fn(agent, optimizer, config, num_steps_per_iter,
                             mesh=mesh)

    eval_rollout_fn = None
    if eval_envs is not None:
        total_eval_episodes, eval_steps = eval_rollout_size(
            num_eval_episodes, eval_sample_k, eval_envs.canvas_size)

        def make_eval(pipelined):
            return _make_rollout(eval_envs, agent, eval_steps,
                                 eval_sample_k == 0, host_loop_calculator,
                                 pipelined, host_distance_penalty)
        eval_rollout_fn = (_Following(rollout_fn, make_eval)
                           if isinstance(rollout_fn, AutoTransportRollout)
                           else make_eval(host_loop_pipelined))

    states, generator = start_rollouts(envs, num_envs, optimizer, seed, mesh)
    if eval_envs is not None:
        eval_generator = torch.Generator(device=device).manual_seed(
            eval_seed(seed))
        eval_states = eval_envs.init_states(num_eval_envs, eval_generator)

    total_num_steps = start_num_steps
    num_iterations = (max_num_steps - total_num_steps) // num_steps_per_iter
    logging.info('Starting PPO')

    for iteration in range(num_iterations):
        logging.info(f'Iteration: {iteration}/{num_iterations - 1}, '
                     f'steps: {total_num_steps}')
        profiler = None
        if profile_dir and iteration == 1:
            profiler = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU] + (
                    [torch.profiler.ProfilerActivity.CUDA]
                    if device.type == 'cuda' else []))
            profiler.start()

        # -- training rollout
        sync(device)
        t_iter = t0 = time.perf_counter()
        reward_t0 = (host_reward_timer.total_time
                     if host_reward_timer is not None else None)
        train_info = {'transport': rollout_fn.transport}
        states, traj = rollout_fn(agent, states, generator)
        if mesh is not None:
            traj = mesh.gather_trajectory(traj)
        returns, lengths = _episodes(traj, config.gamma)
        train_info.update(time=time.perf_counter() - t0,
                          **_episode_info(returns, lengths))
        if reward_t0 is not None:
            # wall time in the host reward; the pipelined transport overlaps
            # it with the device's work
            train_info['reward_time'] = host_reward_timer.total_time - reward_t0
        if getattr(rollout_fn, 'recomputes', None) is not None:
            train_info['recomputes'] = rollout_fn.recomputes
        logging.info(f'Training rollout: return={train_info["return_mean"]:.3f} '
                     f'({train_info["return_std"]:.1f}), episode '
                     f'length={train_info["episode_length_mean"]:.1f}')
        if info_saver:
            train_info['total_num_steps'] = total_num_steps
            train_info.update(buffer_stats(traj))
            info_saver.save(train_info, name='train')
        if rollout_saver and save_train_rollout:
            rollout_saver.save(traj.to_numpy(), num_steps=total_num_steps,
                               info='train')

        # -- optimize
        t0 = time.perf_counter()
        data = compute_ppo_data(traj, config.gamma, config.lam)
        opt_info = train_fn(data, generator)
        sync(device)
        opt_info['time'] = time.perf_counter() - t0
        opt_info['iteration_time'] = time.perf_counter() - t_iter
        logging.info(
            f'Optimization: policy loss={opt_info["policy_loss"]:.3f}, '
            f'vf loss={opt_info["vf_loss"]:.3f}, total loss='
            f'{opt_info["total_loss"]:.3f}, num steps='
            f'{opt_info["num_opt_steps"]}')
        if info_saver:
            opt_info['total_num_steps'] = total_num_steps
            info_saver.save(opt_info, name='opt')

        if profiler is not None:
            profiler.stop()
            os.makedirs(profile_dir, exist_ok=True)
            path = os.path.join(profile_dir, 'iteration-1.trace.json')
            profiler.export_chrome_trace(path)
            logging.info(f'Wrote profiler trace to {path}')

        total_num_steps += num_steps_per_iter

        # -- evaluation
        if eval_rollout_fn is not None and (
                iteration % eval_freq == 0 or iteration == num_iterations - 1):
            transport = eval_rollout_fn.transport
            eval_states, eval_traj = eval_rollout_fn(agent, eval_states,
                                                     eval_generator)
            e_returns, e_lengths = _episodes(eval_traj, config.gamma)
            if len(e_returns) < total_eval_episodes:
                raise RuntimeError(
                    f'eval rollout of {eval_steps} steps completed only '
                    f'{len(e_returns)} episodes: the canvas_size + 1 '
                    'episode-length bound was violated')
            e_returns = e_returns[:total_eval_episodes]
            eval_info = dict(_episode_info(e_returns,
                                           e_lengths[:total_eval_episodes]),
                             transport=transport)
            if eval_sample_k > 0:
                # episodes cycle the eval formulas in order, so episode i
                # belongs to formula i % num_eval_episodes
                per_formula = np.asarray(e_returns).reshape(
                    eval_sample_k, num_eval_episodes)
                eval_info['return_best_mean'] = float(
                    np.mean(per_formula.max(axis=0)))
            if getattr(eval_rollout_fn, 'recomputes', None) is not None:
                eval_info['recomputes'] = eval_rollout_fn.recomputes
            logging.info(f'Evaluation rollout: return='
                         f'{eval_info["return_mean"]:.3f} '
                         f'({eval_info["return_std"]:.1f})')
            if info_saver:
                eval_info['total_num_steps'] = total_num_steps
                eval_info.update(buffer_stats(eval_traj))
                info_saver.save(eval_info, name='eval')
            if rollout_saver and save_eval_rollout:
                rollout_saver.save(eval_traj.to_numpy(),
                                   num_steps=total_num_steps, info='eval')

        # -- checkpoint
        if model_handler and (iteration % save_freq == 0
                              or iteration == num_iterations - 1):
            model_handler.save(agent, optimizer, num_steps=total_num_steps)

    logging.info('Finished PPO')
    return agent, optimizer
