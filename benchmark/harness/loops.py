"""The two kinds of timed work a traffic mix names by its `loop`, each
driven from the seed through the program's own calls:

  train   whole PPO iterations as batch_ppo runs them, without evaluation,
          checkpoints or logging: the rollout, compute_ppo_data and the
          update, back to back. Set-up runs the first CHECK_ITERATIONS of
          them, which warm every shape; the reference follows their first
          optimizer steps from the seed's weights. The window's first
          iterations are kept too, with the program's state before them,
          and followed as far once the window has closed; the window runs
          until they are kept. Its rate is the env steps of every
          iteration begun in it over the time to the end of the last one.
  sample  sampled rollouts of the policy with no update, back to back. The
          window keeps a sample of its rollouts, drawn from the seed, for
          the reference to judge once it has closed.

Each loop knows the kernel calls and model FLOPs of its work, from the
benchmark's own count (count.py).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from harness import count, judge, weights
from harness.program import Program


def _clone(x):
    return {k: v.detach().clone() for k, v in x.items()}


class Loop:
    """What both loops share: the program, its weights, the agent's sizes
    and the device's synchronize."""

    def __init__(self, prog: Program, config: dict, traffic: dict, seed: int,
                 device: torch.device):
        from reference import covariant
        self.prog, self.config, self.traffic = prog, config, traffic
        self.seed, self.device = seed, device
        self.agent_sizes = covariant.settings(config)
        shapes = {k: v.shape for k, v in prog.agent.named_parameters()}
        self.weights = weights.make(shapes, seed, device)
        prog.agent.load_state_dict(self.weights)
        self.gen = torch.Generator(device=device).manual_seed(
            weights.stream(seed, 2))
        self.states = prog.env.init_states(prog.num_envs, self.gen)

    def release(self):
        """Drop the program's objects before the reference runs."""
        self.prog = None

    def sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def rollout_calls(self) -> List[count.Call]:
        """The kernel calls of one rollout: a sampled forward a step and the
        greedy forward of its bootstrap value."""
        s, n = self.agent_sizes, self.prog.num_envs
        return (count.kernel_calls(s, n, False, 'sample') * self.prog.steps
                + count.kernel_calls(s, n, False, 'greedy'))

    def rollout_flops(self) -> float:
        return (self.prog.steps + 1) * count.flops(
            self.agent_sizes, self.prog.num_envs, False)['model']


CHECK_ITERATIONS = 3    # PPO iterations that set-up runs and the judge sees


class Follow:
    """Keeps what the reference needs to follow the program's next
    judge.FOLLOWED optimizer steps: the program's parameters and optimizer
    state before them, the iterations they fall in, each step's loss (the
    mean of its epoch's minibatch losses), the first gradient as the
    optimizer got it (from its first moment after one step) and the
    parameters after the last. While it follows, it wraps the optimizer's
    step; `close` unwraps it."""

    def __init__(self, prog: Program):
        opt = prog.optimizer
        self.prog, self.taken, self.records, self.losses = prog, 0, [], []
        self.start = _clone(dict(prog.agent.named_parameters()))
        self.adam = dict(count=opt.count, mu=_clone(opt.mu), nu=_clone(opt.nu))
        self.first_grad, self.after = {}, None
        self.was = vars(opt).get('step')

        def step_and_keep(grads, step=opt.step):
            step(grads)
            self.taken += 1
            if self.taken <= judge.FOLLOWED:
                self.losses.append(torch.stack(prog.losses).mean())
            prog.losses.clear()
            if self.taken == 1:
                self.first_grad = {k: (opt.mu[k] - opt.b1 * m0) / (1 - opt.b1)
                                   for k, m0 in self.adam['mu'].items()}
            if self.taken == judge.FOLLOWED:
                self.after = _clone(dict(prog.agent.named_parameters()))
        opt.step = step_and_keep

    @property
    def done(self) -> bool:
        return self.taken >= judge.FOLLOWED

    def keep(self, traj, info, end):
        self.records.append(dict(traj=traj, info=info, end=end))

    def close(self):
        if self.prog is not None:
            if self.was is None:
                del self.prog.optimizer.step
            else:
                self.prog.optimizer.step = self.was
            self.prog = None


class TrainLoop(Loop):

    def setup(self):
        self.checked = Follow(self.prog)
        for _ in range(CHECK_ITERATIONS):
            self.checked.keep(*self.iteration())
        self.checked.close()
        self.sync()
        self.followed = Follow(self.prog)

    def iteration(self):
        """One PPO iteration: (trajectory, update info, the observation the
        rollout ended at); the host clock's rollout and update seconds."""
        p = self.prog
        p.losses.clear()
        t0 = time.perf_counter()
        self.states, traj = p.rollout(p.agent, self.states, self.gen)
        self.sync()
        t1 = time.perf_counter()
        data = p.compute_ppo_data(traj, p.ppo.gamma, p.ppo.lam)
        info = p.train(data, self.gen)
        self.sync()
        self.spans = (t1 - t0, time.perf_counter() - t1)
        end = self.states.observation()
        return traj, info, end

    def _minibatches(self):
        """(rows of a minibatch, minibatches an epoch), as make_train_fn
        cuts the samples."""
        mb = min(self.prog.ppo.mini_batch_size, self.prog.samples)
        return mb, -(-self.prog.samples // mb)

    def _flops(self, passes: int) -> float:
        mb, batches = self._minibatches()
        return self.rollout_flops() + passes * batches * count.flops(
            self.agent_sizes, mb, True)['model']

    def window(self, seconds: float) -> Dict[str, object]:
        stats = dict(rollout_s=[], update_s=[], grad_passes=[], steps=0,
                     model_flops=0.0)
        t0 = time.perf_counter()
        while self.followed.prog is not None or time.perf_counter() - t0 < seconds:
            traj, info, end = self.iteration()
            if self.followed.prog is not None:
                self.followed.keep(traj, info, end)
                if self.followed.done:
                    self.followed.close()
            stats['rollout_s'].append(self.spans[0])
            stats['update_s'].append(self.spans[1])
            stats['grad_passes'].append(info['num_grad_passes'])
            stats['steps'] += self.prog.samples
            stats['model_flops'] += self._flops(info['num_grad_passes'])
        stats['seconds'] = time.perf_counter() - t0
        self.followed.close()
        return stats

    def traced_work(self):
        """One iteration; (env steps, the kernel calls it made)."""
        _traj, info, _end = self.iteration()
        mb, batches = self._minibatches()
        calls = self.rollout_calls() + count.kernel_calls(
            self.agent_sizes, mb, True, 'given') * (
                info['num_grad_passes'] * batches)
        return self.prog.samples, calls

    def judge(self, limits: Dict[str, float]) -> judge.Verdict:
        return judge.train(self.config, self.weights, self.checked,
                           self.followed, limits)


class SampleLoop(Loop):

    def setup(self):
        p = self.prog
        self.states, _traj = p.rollout(p.agent, self.states, self.gen)
        self.sync()
        rng = np.random.default_rng(weights.stream(self.seed, 3))
        # the window's first rollout and one of its next three
        self.keep = {0, int(rng.integers(1, 4))}
        self.kept = []

    def window(self, seconds: float) -> Dict[str, object]:
        p = self.prog
        stats = dict(steps=0, calls=0, model_flops=0.0)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.states, traj = p.rollout(p.agent, self.states, self.gen)
            if stats['calls'] in self.keep:
                self.kept.append(dict(traj=traj, end=self.states.observation()))
            self.sync()
            stats['calls'] += 1
            stats['steps'] += p.num_envs * p.steps
            stats['model_flops'] += self.rollout_flops()
        stats['seconds'] = time.perf_counter() - t0
        return stats

    def traced_work(self):
        p = self.prog
        self.states, _traj = p.rollout(p.agent, self.states, self.gen)
        return p.num_envs * p.steps, self.rollout_calls()

    def judge(self, limits: Dict[str, float]) -> judge.Verdict:
        return judge.sample(self.config, self.weights, self.kept, limits)


LOOPS = dict(train=TrainLoop, sample=SampleLoop)
