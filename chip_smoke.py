"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build the port's CUDA kernels from molgym_tpu_torch/csrc, all nvcc
     processes at once;
  3. hold each kernel against its plain PyTorch version on the card at the
     SF6 shapes of the main path (fused CG aggregate at levels 0 and 1-2,
     B = 140 and B = 9; tri-fold CG square at tau = 10 and 12), and time the
     kernel, the plain version and one library call computing the same
     contraction (torch.einsum on complex tensors, a yardstick the port never
     calls);
  4. the main path: a 140-env x 14-step rollout of the SF6 covariant agent
     (bench.py's configuration, random weights from a seed) with the
     Lennard-Jones reward, through make_rollout_fn; the kernels' launch
     counts are zeroed just before it and read just after;
  5. the rollout's outputs: finite rewards, log-probs and values, every
     episode ended within SF6's 7 atoms, and the agent on the card agrees
     with the same agent on the CPU (plain versions) on the rollout's data.

The line before the last two is {"kernels": [...]}, then the card's name and
power limit, and the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
NUM_ENVS = 140
NUM_STEPS = 14
KERNEL_TOL = 1e-4   # f32, another summation order: relative to max |ref|
MODEL_TOL = 1e-3    # logp / v of the whole agent, card vs CPU
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_FLOP_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
SF6_AGENT = dict(zs=(0, 9, 16), canvas_size=7, network_width=128, maxl=4,
                 num_cg_levels=3, num_channels_hidden=10,
                 num_channels_per_element=4, num_gaussians=3, bag_scale=5,
                 min_max_distance=(1.10, 2.10), beta=-10.0)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def time_ms(fn, reps=30, replays=5):
    """Mean device time of one call: `reps` calls captured in a CUDA graph,
    replayed between CUDA events. Replay leaves out the host's time to issue
    each call, which at these sizes is longer than the kernels themselves and
    would otherwise be measured as gaps between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='relaxed'):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def max_err(outs, refs):
    abs_err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) for r in refs)
    return abs_err, abs_err / max(scale, 1e-30)


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check_aggregate(dev, B, atom_n_ells):
    from molgym_tpu_torch.ops import cg, fused_agg
    maxl, N, tau = 4, 7, 10
    n_ells = maxl + 1
    m1, m2 = n_ells ** 2, atom_n_ells ** 2
    gen = torch.Generator(device=dev).manual_seed(SEED + B + atom_n_ells)
    sph = torch.randn((B, N, N, m1, 2), generator=gen, device=dev)
    rad = torch.randn((B, N, N, tau, n_ells), generator=gen, device=dev)
    q_r = torch.randn((B, N, tau, m2), generator=gen, device=dev)
    q_i = torch.randn((B, N, tau, m2), generator=gen, device=dev)
    table3, _sl = cg._fused_cg_table(n_ells, atom_n_ells, maxl)
    g = cg.fused_cg_table_grouped(n_ells, atom_n_ells, maxl)
    grouped = None if g is None else (g[0], g[1])
    args = (sph, rad, q_r, q_i, table3)

    out = fused_agg.cg_aggregate_edge_fused_ri(*args, grouped=grouped)
    torch.cuda.synchronize()
    ref = fused_agg.cg_aggregate_edge_fused_ri_plain(*args, grouped=grouped)
    abs_err, rel_err = max_err(out, ref)
    if not rel_err <= KERNEL_TOL:
        raise AssertionError(f'aggregate B={B} M2={m2}: rel err {rel_err}')
    res = dict(shape=f'B={B} N={N} tau={tau} M1={m1} M2={m2} K={out[0].shape[-1]}'
               f' {"grouped" if grouped else "dense"}',
               max_abs_err=abs_err, max_rel_err=rel_err)
    if B != 140:
        return res
    res['ms'] = time_ms(lambda: fused_agg.cg_aggregate_edge_fused_ri(
        *args, grouped=grouped))
    res['plain_ms'] = time_ms(lambda: fused_agg.cg_aggregate_edge_fused_ri_plain(
        *args, grouped=grouped))
    # library yardstick: the contraction as ONE complex einsum against the
    # dense table (edge rep built outside the timed call, K left unpermuted)
    e = (rad[..., fused_agg._l_of_m(n_ells, dev)][..., None] *
         sph[:, :, :, None, :, :])
    e_c = torch.complex(e[..., 0], e[..., 1]).contiguous()
    q_c = torch.complex(q_r, q_i)
    c_c = torch.from_numpy(table3).to(dev).to(torch.complex64)
    res['library_ms'] = time_ms(
        lambda: torch.einsum('bijtm,bjtn,mnk->bitk', e_c, q_c, c_c))
    tabs = fused_agg._kernel_tables('aggregate', table3, grouped, None, dev)
    nnz = tabs['coef'].numel()
    n_flops = (B * N * N * tau * m1 * 2 +            # e = rad * Y
               B * N * tau * m1 * m2 * N * 8 +       # z, complex MAC
               B * N * tau * nnz * 4)                # sparse contraction
    res['bound_ms'], res['bound_by'] = bound_ms(
        nbytes(sph, rad, q_r, q_i, *out, tabs['colptr'], tabs['pair'],
               tabs['coef']), n_flops)
    return res


def check_square(dev, tau):
    from molgym_tpu_torch.ops import cg, fused_agg
    maxl, B, N = 4, 140, 7
    n_ells = maxl + 1
    m = n_ells ** 2
    gen = torch.Generator(device=dev).manual_seed(SEED + tau)
    a_r = torch.randn((B, N, tau, m), generator=gen, device=dev)
    a_i = torch.randn((B, N, tau, m), generator=gen, device=dev)
    table3, _sl = cg._fused_cg_table(n_ells, n_ells, maxl)
    pairs, groups, perm, _si = cg.fused_cg_table_tri(n_ells, maxl)
    tri = (pairs, groups)
    out = fused_agg.cg_square_fused_ri(a_r, a_i, table3, tri=tri)
    torch.cuda.synchronize()
    ref = fused_agg.cg_square_fused_ri_plain(a_r, a_i, table3, tri=tri)
    abs_err, rel_err = max_err(out, ref)
    if not rel_err <= KERNEL_TOL:
        raise AssertionError(f'square tau={tau}: rel err {rel_err}')
    res = dict(shape=f'B={B} N={N} tau={tau} M={m} P={len(pairs)} '
               f'K={out[0].shape[-1]} tri', max_abs_err=abs_err,
               max_rel_err=rel_err)
    res['ms'] = time_ms(lambda: fused_agg.cg_square_fused_ri(a_r, a_i, table3,
                                                              tri=tri))
    res['plain_ms'] = time_ms(lambda: fused_agg.cg_square_fused_ri_plain(
        a_r, a_i, table3, tri=tri))
    a_c = torch.complex(a_r, a_i)
    c_c = torch.from_numpy(table3).to(dev).to(torch.complex64)
    res['library_ms'] = time_ms(
        lambda: torch.einsum('...m,...n,mnk->...k', a_c, a_c, c_c))
    tabs = fused_agg._kernel_tables('square', table3, None, tri, dev)
    rows = B * N * tau
    n_flops = rows * (len(pairs) * 6 + tabs['coef'].numel() * 4)
    res['bound_ms'], res['bound_by'] = bound_ms(
        nbytes(a_r, a_i, *out, tabs['colptr'], tabs['pair'], tabs['coef'],
               tabs['pair_m'], tabs['pair_n']), n_flops)
    return res


def run_main_path(dev):
    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.envs.environment import MolecularEnv
    from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
    from molgym_tpu_torch.formula import string_to_formula
    from molgym_tpu_torch.ops import fused_agg
    from molgym_tpu_torch.rl.rollout import make_rollout_fn
    from molgym_tpu_torch.spaces import ObservationSpace

    torch.manual_seed(SEED)
    space = ObservationSpace(canvas_size=7, zs=list(SF6_AGENT['zs']))
    bag = space.bag_from_formula(string_to_formula('SF6'))
    env = MolecularEnv(make_lennard_jones_reward(), space, bag[None],
                       device=dev)
    agent = CovariantAC(**SF6_AGENT, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # warm-up: builds the tables and allocator pools outside the timed run
    make_rollout_fn(env, agent, 2)(agent, env.init_states(NUM_ENVS), gen)
    torch.cuda.synchronize()

    rollout = make_rollout_fn(env, agent, NUM_STEPS)
    states = env.init_states(NUM_ENVS)
    torch.cuda.synchronize()
    fused_agg.reset_launch_counts()
    t0 = time.perf_counter()
    states, traj = rollout(agent, states, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(fused_agg.launch_counts)

    expected = agent.encoder.num_cg_levels * (NUM_STEPS + 1)
    for name, n in counts.items():
        if n != expected:
            raise AssertionError(f'{name}: {n} launches on the main path, '
                                 f'expected {expected}')
    for name in ('rewards', 'logps', 'values', 'actions', 'bootstrap_value'):
        if not torch.isfinite(getattr(traj, name)).all():
            raise AssertionError(f'non-finite {name}')
    # SF6 has 7 atoms: a step either places one or ends the episode, so
    # every episode ends within 7 steps with at most 7 atoms on the canvas
    term = traj.terminals.cpu().numpy()
    n_next = (traj.next_obs.elements != 0).sum(-1).cpu().numpy()
    if (n_next > 7).any():
        raise AssertionError('a canvas holds more than 7 atoms')
    for b in range(NUM_ENVS):
        ends = np.flatnonzero(term[:, b])
        if not len(ends) or ends[0] > 6 or (np.diff(ends) > 7).any():
            raise AssertionError(f'env {b}: episode longer than 7 steps')

    # the agent on the card against itself on the CPU (plain versions), on
    # the rollout's observations and actions
    cpu_agent = CovariantAC(**SF6_AGENT, device='cpu')
    cpu_agent.load_state_dict(agent.state_dict())
    idx = slice(0, 16)
    obs = traj.obs.map(lambda x: x[3, idx])
    actions = traj.actions[3, idx]
    with torch.no_grad():
        g_logp, _g_ent, g_v = agent.evaluate(obs, actions)
        c_logp, _c_ent, c_v = cpu_agent.evaluate(obs.map(lambda x: x.cpu()),
                                                 actions.cpu())
    model_err = max(float((g_logp.cpu() - c_logp).abs().max()),
                    float((g_v.cpu() - c_v).abs().max()))
    if not model_err <= MODEL_TOL:
        raise AssertionError(f'card vs CPU agent: max |d logp|, |d v| = '
                             f'{model_err}')
    return dict(seconds=seconds, counts=counts, model_err=model_err,
                episodes=int(term.sum()),
                mean_reward=float(traj.rewards.mean()),
                ms_per_step=seconds * 1e3 / NUM_STEPS,
                env_steps_per_s=NUM_ENVS * NUM_STEPS / seconds)


def main() -> int:
    if not torch.cuda.is_available():
        log('chip_smoke: no CUDA device is visible')
        return 2
    from molgym_tpu_torch import cuda_build

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log('card:', card)
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    built = cuda_build.build()
    log(f'kernels built in {time.perf_counter() - t0:.1f} s')
    for name, info in built.items():
        log(f'  {name}: {info["seconds"]:.1f} s')
        for line in info['ptxas']:
            log('    ' + line)

    agg = {(B, n): check_aggregate(dev, B, n) for B in (140, 9) for n in (1, 5)}
    sq = {tau: check_square(dev, tau) for tau in (10, 12)}
    for k, v in list(agg.items()) + list(sq.items()):
        log('parity', k, json.dumps(v))

    main_path = run_main_path(dev)
    log('main path:', json.dumps(main_path))
    log(f'rollout {NUM_ENVS} envs x {NUM_STEPS} steps: '
        f'{main_path["ms_per_step"]:.3f} ms/step, '
        f'{main_path["env_steps_per_s"]:.1f} env-steps/s on {card}')

    def entry(name, source, replaces, main, others):
        return dict(name=name, route='cuda', source=source, replaces=replaces,
                    launches=main_path['counts'][name],
                    max_abs_err=max(r['max_abs_err'] for r in others),
                    ms=main['ms'], plain_ms=main['plain_ms'],
                    bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                    library_ms=main['library_ms'], at=main['shape'],
                    checked=[r['shape'] for r in others])

    kernels = [
        entry('cg_aggregate_edge_fused_ri',
              'molgym_tpu_torch/csrc/cg_aggregate.cu',
              'molgym_tpu/ops/pallas_agg.py:334', agg[(140, 5)],
              list(agg.values())),
        entry('cg_square_fused_ri', 'molgym_tpu_torch/csrc/cg_square.cu',
              'molgym_tpu/ops/pallas_agg.py:91', sq[10], list(sq.values())),
    ]
    print(json.dumps({'main_path': main_path, 'aggregate_level0': agg[(140, 1)],
                      'square_tau12': sq[12]}))
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
