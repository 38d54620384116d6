"""Faults planted in the program, and the control in lower precision, for
the benchmark's own checks (calibrate.py and tests/): each is a
`plant(program, loop)` that run.run_cell applies once the program is
built. None of them runs in the benchmark's own runs.

  tf32        the control: the program's float32 matrix products in TF32
              (its own switch), the configuration stating TF32 off
  reward_bf16 the control of the env's step: the reference's Lennard-Jones
              reward computed in bfloat16, put in the program's place
  unchanged   a step that returns its state unchanged: the optimizer's
              step (train) or the env's step (sample)
  half_batch  the update's loss over half of each minibatch, the mean
              taken over the rest
  answer      one reward a step altered where the env produces it
"""
from __future__ import annotations

import torch


def tf32(prog, loop):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def reward_bf16(prog, loop):
    from reference import env as ref_env
    prog.env.reward_fn = lambda *a: ref_env.lennard_jones(*a, dtype=torch.bfloat16)


def unchanged(prog, loop):
    if loop.traffic['loop'] == 'train':
        prog.optimizer.step = lambda grads: None
        return
    step = prog.env.step

    def still(states, element, position):
        out = step(states, element, position)
        out.state, out.observation = states, states.observation()
        return out
    prog.env.step = still


def half_batch(prog, loop):
    from molgym_tpu_torch.rl import ppo
    make = ppo.make_loss_fn

    def half(agent, config):
        loss_fn = make(agent, config)

        def first_half(obs, act, old_logp, adv, ret, weights, norm=None):
            w = weights.clone()
            w[len(w) // 2:] = 0
            return loss_fn(obs, act, old_logp, adv, ret, w, w.sum().clamp(min=1))
        return first_half
    prog.build_train(half)


def answer(prog, loop):
    step = prog.env.step

    def altered(states, element, position):
        out = step(states, element, position)
        out.reward = out.reward.clone()
        out.reward[0] += 0.1
        return out
    prog.env.step = altered


PLANTS = dict(tf32=tf32, reward_bf16=reward_bf16, unchanged=unchanged,
              half_batch=half_batch, answer=answer)
