"""The comparison that decides `correct`: what the timed path produced,
judged by the plain reference (reference/), which works everything out
again from the benchmark's weights and the program's observations and
actions (the rollout's answers, as a served model's tokens are).

Numbers compared, each against the cell's limit (limits/<cell>.json):
  logp_gap        the largest |log-prob of the program's action, program -
                  reference| over the judged steps (encoder with its CG
                  kernels, the four heads); in a training cell, over the
                  first rollout, the one at the benchmark's weights
  value_gap       the same for the critic's value, the bootstrap included
  env_gap         the largest gap of a reward or a placed atom's position
                  between the program's step and the reference's, over
                  every judged step
  env_mismatches  judged steps whose end, canvas or bag differ from the
                  reference's, or whose reset is no fresh episode of the
                  configuration (exact: limit 0); steps within 1e-5 of a
                  threshold are left out of this count, where rounding
                  may decide either way
Training cells add, over the FOLLOWED (3) optimizer steps that the
reference follows twice: from the benchmark's weights over set-up's
first steps, and from the program's parameters and optimizer state at the
window's start over the window's first steps (the numbers are the larger
of the two):
  loss_gap        the largest relative gap of a step's loss (the loss the
                  program computed for the gradient it stepped with)
  grad_gap        the first gradient as the optimizer got it (from its
                  first moment after one step), by the worst leaf: the gap
                  of the leaf's norms over the larger of the reference's
                  norm and the median leaf's
  change_gap      the parameters' change over the three steps, as the
                  fourth finds them, the same way but by the median leaf,
                  leaving out leaves whose reference gradient is under a
                  thousandth of the median leaf's (they move by round-off
                  alone). Adam steps an element whose gradient is near
                  rounding by about its learning rate either way, so on
                  some seeds one leaf's change reads as far off as the
                  control's; the median leaf does not.
The policy's numbers cover the first rollout of each, the one at the
parameters the reference starts from. Not compared, for the look at the
tails (the Verdict's `seen`): each of these numbers of each start apart,
the median leaf's gradient gap and the worst leaf's change gap.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from reference import covariant, env as ref_env, ppo as ref_ppo

EVAL_ROWS = 2240
GRAD_ROWS = 560
AMBIGUOUS = 1e-5
STILL = 1e-3
FOLLOWED = 3       # optimizer steps the reference follows


@dataclasses.dataclass
class Verdict:
    numbers: Dict[str, float]
    limits: Dict[str, float]
    judged: int
    wrong: int
    seen: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(self.numbers[k] <= self.limits[k] for k in self.limits)


def _flat(obs) -> Dict[str, torch.Tensor]:
    return {k: getattr(obs, k).reshape((-1, ) + getattr(obs, k).shape[2:])
            for k in ('elements', 'positions', 'bag')}


def _fields(obs) -> Dict[str, torch.Tensor]:
    return {k: getattr(obs, k) for k in ('elements', 'positions', 'bag')}


def check_env(es: dict, traj, end, reward_dtype=torch.float32) -> dict:
    """The reference's step of every judged transition against the
    program's, and the program's resets."""
    T, B = traj.rewards.shape
    obs, nxt = _flat(traj.obs), _flat(traj.next_obs)
    ref = ref_env.transition(es, obs['elements'], obs['positions'], obs['bag'],
                             traj.actions.reshape(T * B, -1), reward_dtype)
    reward_gap = (traj.rewards.reshape(-1) - ref['reward']).abs()
    pos_gap = (nxt['positions'] - ref['positions']).abs().amax((-1, -2))
    sure = ref['margin'] >= AMBIGUOUS
    differ = ((ref['done'] != traj.terminals.reshape(-1))
              | (ref['elements'] != nxt['elements']).any(-1)
              | (ref['bag'] != nxt['bag']).any(-1)) & sure
    # what follows each step: its next state, or a fresh episode where it
    # ended; the rollout starts from fresh episodes
    follows = [_fields(traj.obs)[k][1:] for k in ('elements', 'positions', 'bag')]
    follows = [torch.cat([f, _fields(end)[k][None]]) for f, k in
               zip(follows, ('elements', 'positions', 'bag'))]
    after = [_fields(traj.next_obs)[k] for k in ('elements', 'positions', 'bag')]
    same = ((follows[0] == after[0]).all(-1) & (follows[1] == after[1]).all(-1).all(-1)
            & (follows[2] == after[2]).all(-1))
    fresh = ref_env.reset_ok(es, *(f.reshape((T * B, ) + f.shape[2:])
                                   for f in follows)).reshape(T, B)
    carried = torch.where(traj.terminals, fresh, same).reshape(-1)
    starts = ref_env.reset_ok(es, *(_fields(traj.obs)[k][0]
                                    for k in ('elements', 'positions', 'bag')))
    bad = differ | ~carried
    bad[:B] |= ~starts
    return dict(env_gap=float(torch.maximum(reward_gap, pos_gap).max()),
                env_mismatches=int(bad.sum()), reward=ref['reward'],
                done=ref['done'], rows_env=torch.maximum(reward_gap, pos_gap),
                bad=bad)


def check_policy(params, s: dict, traj, end) -> dict:
    """The reference's log-probs and values of the program's actions at its
    observations, and its value of the rollout's last observation."""
    T, B = traj.rewards.shape
    acts = traj.actions.reshape(T * B, -1)
    logp, _ent, v = covariant.evaluate_blocks(params, s, _flat(traj.obs), acts,
                                              EVAL_ROWS)
    still = torch.zeros((B, acts.shape[1]), device=acts.device)
    _l, _e, boot = covariant.evaluate_blocks(params, s, _fields(end), still,
                                             EVAL_ROWS)
    logp_gap = (traj.logps.reshape(-1) - logp).abs()
    value_gap = (traj.values.reshape(-1) - v).abs()
    return dict(logp_gap=float(logp_gap.max()),
                value_gap=float(torch.cat([value_gap, (traj.bootstrap_value
                                                       - boot).abs()]).max()),
                logp=logp, value=v, bootstrap=boot, rows_logp=logp_gap,
                rows_value=value_gap)


def _reference_mode():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rows_wrong(pol, env: dict, limits: Dict[str, float]) -> int:
    """Judged steps beyond a limit: the env's, and the policy's where
    `pol` is given."""
    wrong = env['bad'] | (env['rows_env'] > limits['env_gap'])
    if pol is not None:
        wrong |= pol['rows_logp'] > limits['logp_gap']
        wrong |= pol['rows_value'] > limits['value_gap']
    return int(wrong.sum())


def _merge(into: Dict[str, float], got: dict):
    """Keep the largest gap of each number (the sum of mismatches)."""
    for k, v in got.items():
        if k == 'env_mismatches':
            into[k] = into.get(k, 0) + v
        elif k.endswith('gap'):
            into[k] = max(into.get(k, 0.0), v)


def sample(config: dict, params, kept: List[dict], limits) -> Verdict:
    _reference_mode()
    s, es = covariant.settings(config), ref_env.settings(config)
    numbers: Dict[str, float] = {}
    judged = wrong = 0
    for rec in kept:
        pol = check_policy(params, s, rec['traj'], rec['end'])
        env = check_env(es, rec['traj'], rec['end'])
        _merge(numbers, pol)
        _merge(numbers, env)
        judged += rec['traj'].rewards.numel()
        wrong += _rows_wrong(pol, env, limits)
    return Verdict(numbers, limits, judged, wrong)


def leaf_gaps(program: Dict[str, torch.Tensor],
              reference: Dict[str, torch.Tensor], leaves) -> List[float]:
    """Each leaf's |norm(program) - norm(reference)| over the larger of its
    reference norm and the median leaf's."""
    p = {k: float(program[k].norm()) for k in leaves}
    r = {k: float(reference[k].norm()) for k in leaves}
    median = _median(list(r.values()))
    return [abs(p[k] - r[k]) / max(r[k], median) for k in leaves]


def _median(values: List[float]) -> float:
    return float(torch.tensor(values).median())


def _follow(s: dict, es: dict, ps: dict, start, adam, kept,
            limits: Dict[str, float]) -> dict:
    """The reference's run beside one Follow of the program (loops.py)
    from `start` with `adam`: every kept iteration's env steps judged, the
    first rollout's policy judged at `start`, and the update followed for
    FOLLOWED optimizer steps. The numbers, the env's rows judged and wrong,
    and the leaf gaps that are not compared."""
    ref = dict(start)
    numbers: Dict[str, float] = {}
    judged = wrong = steps = 0
    g1 = ref_after = None
    losses = []
    for i, rec in enumerate(kept.records):
        traj, info, end = rec['traj'], rec['info'], rec['end']
        T, B = traj.rewards.shape
        env = check_env(es, traj, end)
        _merge(numbers, env)
        judged += T * B
        if steps >= FOLLOWED:
            wrong += _rows_wrong(None, env, limits)
            continue
        pol = check_policy(ref, s, traj, end)
        if i == 0:
            _merge(numbers, pol)
        wrong += _rows_wrong(pol if i == 0 else None, env, limits)
        adv, ret = ref_ppo.gae(env['reward'].reshape(T, B),
                               pol['value'].reshape(T, B),
                               env['done'].reshape(T, B), pol['bootstrap'],
                               ps['gamma'], ps['lam'])
        for _epoch in range(info['num_opt_steps']):
            if steps >= FOLLOWED:
                break
            got, grads = ref_ppo.loss_and_grad(
                ref, s, ps, _flat(traj.obs), traj.actions.reshape(T * B, -1),
                pol['logp'], adv, ret, GRAD_ROWS)
            losses.append(got['total_loss'])
            if g1 is None:
                g1 = adam.clipped(grads)
            ref = adam.step(ref, grads)
            steps += 1
            if steps == FOLLOWED:
                ref_after = ref
    if len(kept.losses) != len(losses) or steps < FOLLOWED:
        numbers['loss_gap'] = float('inf')
    else:
        numbers['loss_gap'] = max(abs(float(p) - r) / abs(r)
                                  for p, r in zip(kept.losses, losses))
    if g1 is None or not kept.first_grad or ref_after is None or kept.after is None:
        numbers.update(grad_gap=float('inf'), change_gap=float('inf'))
        return dict(numbers=numbers, judged=judged, wrong=wrong, seen={})
    leaves = list(start)
    grads = leaf_gaps(kept.first_grad, g1, leaves)
    norms = {k: float(g1[k].norm()) for k in leaves}
    median = _median(list(norms.values()))
    moving = [k for k in leaves if norms[k] >= STILL * median]
    change = leaf_gaps({k: kept.after[k] - start[k] for k in moving},
                       {k: ref_after[k] - start[k] for k in moving}, moving)
    numbers.update(grad_gap=max(grads), change_gap=_median(change))
    return dict(numbers=numbers, judged=judged, wrong=wrong,
                seen=dict(grad_gap_median_leaf=_median(grads),
                          change_gap_worst_leaf=max(change)))


def train(config: dict, params, checked, followed, limits) -> Verdict:
    """The reference follows the program twice (loops.Follow): from the
    benchmark's weights with a fresh optimizer over set-up's iterations,
    and from the program's own parameters and optimizer state at the
    window's start over the window's first iterations. Every kept
    iteration's env steps are judged."""
    _reference_mode()
    s, es, ps = (covariant.settings(config), ref_env.settings(config),
                 ref_ppo.settings(config))
    runs = {}
    for name, kept, start, state in (
            ('setup', checked, params, None),
            ('window', followed, followed.start, followed.adam)):
        start = {k: v.detach() for k, v in start.items()}
        adam = ref_ppo.Adam(start, ps['lr'], ps['max_norm'], state)
        runs[name] = _follow(s, es, ps, start, adam, kept, limits)
    numbers: Dict[str, float] = {}
    seen: Dict[str, float] = {}
    for name, run in runs.items():
        _merge(numbers, run['numbers'])
        seen.update({f'{name}.{k}': v for k, v in {**run['numbers'],
                                                    **run['seen']}.items()})
    judged = sum(r['judged'] for r in runs.values())
    wrong = sum(r['wrong'] for r in runs.values())
    wrong += sum(numbers[k] > limits[k] for k in ('loss_gap', 'grad_gap',
                                                  'change_gap'))
    return Verdict(numbers, limits, judged, wrong, seen)
