"""Where a rollout step's time goes on the card.

    python -m molgym_tpu_torch.profile_rollout [--num_envs 140] [--steps 14]
                                               [--config sf6|stochastic]

Runs the SF6 covariant rollout of chip_smoke.py, or its stochastic-bag
rollout (bags of 4-8 atoms sampled around C2H6O, canvas 10, maxl 3, 2 CG
levels), with random weights from a seed, and prints JSON lines
(chip_smoke.py's phase 11 calls phase_ms and profile_rollout for the
internal agent's rollout):
  * phases: host-clock ms of one policy forward (`act`), one env step and
    one auto-reset at the rollout's shapes, each ended by a synchronize;
  * profile: over one whole rollout under torch.profiler, the wall time, the
    summed device time of all kernels, the device's idle share, the kernel
    launches per rollout step, and the kernels with the most device time.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

SF6_AGENT = dict(zs=(0, 9, 16), canvas_size=7, network_width=128, maxl=4,
                 num_cg_levels=3, num_channels_hidden=10,
                 num_channels_per_element=4, num_gaussians=3, bag_scale=5,
                 min_max_distance=(1.10, 2.10), beta=-10.0)
STOCH_AGENT = dict(zs=(0, 1, 6, 8), canvas_size=10, network_width=128, maxl=3,
                   num_cg_levels=2, num_channels_hidden=10,
                   num_channels_per_element=4, num_gaussians=3, bag_scale=6,
                   min_max_distance=(0.9, 1.8), beta=-10.0)


def _host_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def device_us(evt) -> float:
    for name in ('self_device_time_total', 'self_cuda_time_total'):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def phase_ms(env, agent, num_envs, gen) -> dict:
    """Host-clock ms of one policy forward (sampled and greedy), one env
    step and one auto-reset at num_envs envs, each ended by a
    synchronize."""
    states = env.init_states(num_envs, gen)
    obs = states.observation()
    with torch.no_grad():
        out = agent.act(obs, gen)
        result = env.step(states, out.element, out.position)
        return dict(
            act_ms=_host_ms(lambda: agent.act(obs, gen)),
            act_greedy_ms=_host_ms(lambda: agent.act(obs, gen, True)),
            env_step_ms=_host_ms(lambda: env.step(states, out.element,
                                                  out.position)),
            reset_if_terminal_ms=_host_ms(
                lambda: env.reset_if_terminal(result.state, result.done,
                                              gen)))


def profile_rollout(rollout, env, agent, num_envs, steps, gen) -> dict:
    """One whole `steps`-step rollout under torch.profiler: wall ms, the
    device's busy ms and idle share, kernel launches per step, and the
    kernels with the most device time."""
    states = env.init_states(num_envs, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout(agent, states, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): host ops also carry
    # their kernels' device time and would count it twice
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith('CUDA') and device_us(e) > 0]
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    return {'steps': steps, 'wall_ms_profiled': wall_ms,
            'device_busy_ms': device_ms,
            'device_idle_share': 1.0 - device_ms / wall_ms,
            'kernel_launches_per_step': sum(e.count for e in kernels) / steps,
            'top_kernels': [dict(name=e.key[:90], device_ms=device_us(e) / 1e3,
                                 count=e.count) for e in top]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--num_envs', type=int, default=140)
    parser.add_argument('--steps', type=int, default=14)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--config', choices=['sf6', 'stochastic'],
                        default='sf6')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('profile_rollout: no CUDA device is visible')

    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.envs.environment import MolecularEnv
    from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
    from molgym_tpu_torch.formula import string_to_formula
    from molgym_tpu_torch.rl.rollout import make_rollout_fn
    from molgym_tpu_torch.spaces import ObservationSpace

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    torch.manual_seed(args.seed)
    stochastic = args.config == 'stochastic'
    agent_kwargs = STOCH_AGENT if stochastic else SF6_AGENT
    space = ObservationSpace(canvas_size=agent_kwargs['canvas_size'],
                             zs=list(agent_kwargs['zs']))
    bag = space.bag_from_formula(
        string_to_formula('C2H6O' if stochastic else 'SF6'))
    env = MolecularEnv(make_lennard_jones_reward(), space, bag[None],
                       stochastic_size_range=(4, 9) if stochastic else None,
                       device=dev)
    agent = CovariantAC(**agent_kwargs, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rollout = make_rollout_fn(env, agent, args.steps)
    rollout(agent, env.init_states(args.num_envs, gen), gen)   # warm-up

    head = {'card': card, 'config': args.config, 'num_envs': args.num_envs}
    print(json.dumps(dict(head, phases=phase_ms(env, agent, args.num_envs,
                                                gen))))
    print(json.dumps(dict(head, **profile_rollout(
        rollout, env, agent, args.num_envs, args.steps, gen))))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
