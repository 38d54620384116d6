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
     with the same agent on the CPU (plain versions) on the rollout's data;
  6. the two backward kernels against their plain backward versions at the
     same shapes, timed against the plain versions and the backward of the
     library yardstick (torch.autograd.grad of the complex einsum);
  7. bench.py's loss on a minibatch of 140 at SF6 width: every parameter's
     gradient on the card within 1e-3 of that leaf's max |g| on the CPU,
     none missing; the median ms of one fwd+bwd, and its launches and the
     device's idle share under torch.profiler;
  8. the training path: 3 PPO iterations of the canonical SF6 run
     (README.md's command with the device LJ reward) through
     tools.driver.run_experiment into a temporary directory, with the launch
     counts zeroed just before and read just after: finite losses, a step in
     every update, changed weights, a checkpoint that loads back equal, and
     launch counts equal to what the iterations imply.

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


def time_ms(fn, reps=30, replays=5, stream=None):
    """Mean device time of one call: `reps` calls captured in a CUDA graph,
    replayed between CUDA events. Replay leaves out the host's time to issue
    each call, which at these sizes is longer than the kernels themselves and
    would otherwise be measured as gaps between launches. `fn` is warmed up
    and captured on `stream` (a new side stream by default)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode='relaxed'):
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


def _library_grad_ms(fn, leaves, grads):
    """Device ms of torch.autograd.grad of `fn(*leaves)` (the library
    yardstick's backward), the forward run once outside the timed call.
    Autograd runs each backward op on its forward op's stream, so the
    forward runs on the stream the backward is captured on."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn(*leaves)
        grads = grads.clone()
    return time_ms(lambda: torch.autograd.grad(out, leaves, grads,
                                               retain_graph=True),
                   stream=side)


def check_aggregate_bwd(dev, B, atom_n_ells):
    """The aggregate's backward kernel against its plain backward."""
    from molgym_tpu_torch.ops import cg, fused_agg
    maxl, N, tau = 4, 7, 10
    n_ells = maxl + 1
    m1, m2 = n_ells ** 2, atom_n_ells ** 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 7 * B + atom_n_ells)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    sph, rad = randn(B, N, N, m1, 2), randn(B, N, N, tau, n_ells)
    q_r, q_i = randn(B, N, tau, m2), randn(B, N, tau, m2)
    table3, _sl = cg._fused_cg_table(n_ells, atom_n_ells, maxl)
    g = cg.fused_cg_table_grouped(n_ells, atom_n_ells, maxl)
    grouped = None if g is None else (g[0], g[1])
    tabs = fused_agg._kernel_tables('aggregate', table3, grouped, None, dev)
    k = tabs['k']
    g_r, g_i = randn(B, N, tau, k), randn(B, N, tau, k)
    args = (sph, rad, q_r, q_i, g_r, g_i, table3, grouped)

    out = fused_agg._aggregate_bwd_kernel(*args)
    torch.cuda.synchronize()
    ref = fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(*args)
    abs_err, rel_err = max_err(out, ref)
    if not rel_err <= KERNEL_TOL:
        raise AssertionError(f'aggregate bwd B={B} M2={m2}: rel err {rel_err}')
    res = dict(shape=f'B={B} N={N} tau={tau} M1={m1} M2={m2} K={k}'
               f' {"grouped" if grouped else "dense"}',
               max_abs_err=abs_err, max_rel_err=rel_err)
    if B != 140:
        return res
    res['ms'] = time_ms(lambda: fused_agg._aggregate_bwd_kernel(*args))
    res['plain_ms'] = time_ms(
        lambda: fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(*args))
    # library yardstick: autograd of the forward's complex einsum
    e = (rad[..., fused_agg._l_of_m(n_ells, dev)][..., None] *
         sph[:, :, :, None, :, :])
    e_c = torch.complex(e[..., 0], e[..., 1]).contiguous().requires_grad_()
    q_c = torch.complex(q_r, q_i).requires_grad_()
    c_c = torch.from_numpy(table3).to(dev).to(torch.complex64)
    res['library_ms'] = _library_grad_ms(
        lambda a, b: torch.einsum('bijtm,bjtn,mnk->bitk', a, b, c_c),
        (e_c, q_c), torch.complex(g_r, g_i))
    nnz = tabs['coef_t'].numel()
    n_flops = (B * N * tau * nnz * 4 +                 # dz, sparse rows
               B * N * N * tau * m1 * 2 +              # e = rad * Y
               B * N * N * tau * m1 * m2 * 8 * 2 +     # de and dq, complex MAC
               B * N * N * tau * m1 * 4)               # Re(de conj(Y))
    res['bound_ms'], res['bound_by'] = bound_ms(
        nbytes(sph, rad, q_r, q_i, g_r, g_i, *out, tabs['rowptr'],
               tabs['col'], tabs['coef_t']), n_flops)
    return res


def check_square_bwd(dev, tau):
    """The square's backward kernel against its plain backward (tri pairs,
    the main path's table mode)."""
    from molgym_tpu_torch.ops import cg, fused_agg
    maxl, B, N = 4, 140, 7
    n_ells = maxl + 1
    m = n_ells ** 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 3 * tau)
    table3, _sl = cg._fused_cg_table(n_ells, n_ells, maxl)
    pairs, groups, _perm, _si = cg.fused_cg_table_tri(n_ells, maxl)
    tri = (pairs, groups)
    tabs = fused_agg._kernel_tables('square', table3, None, tri, dev)
    k = tabs['k']
    a_r, a_i = (torch.randn((B, N, tau, m), generator=gen, device=dev)
                for _ in range(2))
    g_r, g_i = (torch.randn((B, N, tau, k), generator=gen, device=dev)
                for _ in range(2))
    args = (a_r, a_i, g_r, g_i, table3, None, tri)
    out = fused_agg._square_bwd_kernel(*args)
    torch.cuda.synchronize()
    ref = fused_agg.cg_square_fused_ri_bwd_plain(*args)
    abs_err, rel_err = max_err(out, ref)
    if not rel_err <= KERNEL_TOL:
        raise AssertionError(f'square bwd tau={tau}: rel err {rel_err}')
    res = dict(shape=f'B={B} N={N} tau={tau} M={m} P={len(pairs)} K={k} tri',
               max_abs_err=abs_err, max_rel_err=rel_err)
    res['ms'] = time_ms(lambda: fused_agg._square_bwd_kernel(*args))
    res['plain_ms'] = time_ms(lambda: fused_agg.cg_square_fused_ri_bwd_plain(
        *args))
    a_c = torch.complex(a_r, a_i).requires_grad_()
    c_c = torch.from_numpy(table3).to(dev).to(torch.complex64)
    res['library_ms'] = _library_grad_ms(
        lambda a: torch.einsum('...m,...n,mnk->...k', a, a, c_c), (a_c, ),
        torch.complex(g_r, g_i))
    rows = B * N * tau
    n_flops = rows * (tabs['coef_t'].numel() * 4 + 2 * len(pairs) * 8)
    res['bound_ms'], res['bound_by'] = bound_ms(
        nbytes(a_r, a_i, g_r, g_i, *out, tabs['rowptr'], tabs['col'],
               tabs['coef_t'], tabs['mptr'], tabs['inc_pair'],
               tabs['inc_other']), n_flops)
    return res


def _bench_batch(seed, batch=140):
    """Random SF6 canvases, the bench.py recipe (1-7 atoms of F/S, 1-5 F and
    one S in the bag)."""
    rng = np.random.RandomState(seed)
    n_atoms = rng.randint(1, 8, size=batch)
    elements = np.zeros((batch, 7), np.int64)
    positions = np.zeros((batch, 7, 3), np.float32)
    bag = np.zeros((batch, 3), np.int64)
    for b in range(batch):
        elements[b, :n_atoms[b]] = rng.randint(1, 3, size=n_atoms[b])
        positions[b, :n_atoms[b]] = rng.randn(n_atoms[b], 3) * 1.2
        bag[b, 1] = rng.randint(1, 6)
        bag[b, 2] = 1
    return elements, positions, bag


def check_agent_grads(dev):
    """bench.py's loss on a minibatch of 140 at SF6 width: every gradient on
    the card (through the four kernels) against the same agent's on the CPU
    (plain versions), then the time of one fwd+bwd and, under
    torch.profiler, its launches and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.profile_rollout import device_us
    from molgym_tpu_torch.spaces import Observation

    torch.manual_seed(SEED)
    agents = {'cuda': CovariantAC(**SF6_AGENT, device=dev)}
    agents['cpu'] = CovariantAC(**SF6_AGENT, device='cpu')
    agents['cpu'].load_state_dict(agents['cuda'].state_dict())
    arrays = _bench_batch(SEED)
    obs = {name: Observation(*(torch.from_numpy(x).to(d) for x in arrays))
           for name, d in (('cuda', dev), ('cpu', 'cpu'))}
    with torch.no_grad():
        actions = agents['cuda'].act(
            obs['cuda'], torch.Generator(device=dev).manual_seed(SEED)
        ).action_flat
    acts = {'cuda': actions, 'cpu': actions.cpu()}

    def fwd_bwd(name):
        agent = agents[name]
        logp, ent, v = agent.evaluate(obs[name], acts[name])
        loss = logp.mean() + 0.5 * (v ** 2).mean() + 0.01 * ent.mean()
        agent.zero_grad(set_to_none=True)
        loss.backward()
        return {k: p.grad for k, p in agent.named_parameters()}

    grads = {name: fwd_bwd(name) for name in ('cuda', 'cpu')}
    missing = [k for k, g in grads['cuda'].items() if g is None]
    if missing:
        raise AssertionError(f'no gradient on the card for {missing}')
    # a leaf whose true gradient is zero holds only rounding noise (the
    # focus head's last bias: a softmax does not see a shift of its
    # logits), so no leaf is scaled below 1e-3 of the largest leaf's max |g|
    floor = 1e-3 * max(float(g.abs().max()) for g in grads['cpu'].values())
    worst = 0.0
    for k, g in grads['cpu'].items():
        scale = max(float(g.abs().max()), floor)
        ratio = float((grads['cuda'][k].cpu() - g).abs().max()) / scale
        worst = max(worst, ratio)
        if not ratio <= MODEL_TOL:
            raise AssertionError(f'gradient of {k}: card vs CPU differ by '
                                 f'{ratio} of the leaf\'s max |g|')

    times = []
    for _ in range(3):
        fwd_bwd('cuda')
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd_bwd('cuda')
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd_bwd('cuda')
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith('CUDA') and device_us(e) > 0]
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    median = float(np.median(times))

    # the other part of a gradient pass's epoch: one optimizer step
    from molgym_tpu_torch.rl.ppo import PPOConfig, make_optimizer
    optimizer = make_optimizer(PPOConfig(), agents['cuda'])
    step_times = []
    for i in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimizer.step(grads['cuda'])
        torch.cuda.synchronize()
        if i >= 3:
            step_times.append((time.perf_counter() - t0) * 1e3)
    return dict(num_params=len(grads['cpu']), max_grad_err_share=worst,
                fwd_bwd_ms_median=median,
                fwd_bwd_ms_min=min(times), fwd_bwd_ms_max=max(times),
                profiled_wall_ms=wall_ms, device_busy_ms=device_ms,
                device_idle_share_profiled=1.0 - device_ms / wall_ms,
                device_idle_share_vs_median=1.0 - device_ms / median,
                launches_per_fwd_bwd=sum(e.count for e in kernels),
                optimizer_step_ms_median=float(np.median(step_times)))


CANONICAL = ['--name=sf6', '--formulas=SF6', '--canvas_size=7',
             '--symbols=X,S,F', '--bag_scale=5', '--model=covariant',
             '--beta=-10', '--min_mean_distance=1.10',
             '--max_mean_distance=2.10', '--num_envs=10',
             '--num_steps_per_iter=140', '--mini_batch_size=140',
             '--reward=device_lj', '--num_steps=420', '--log_level=WARNING']


def run_training(dev):
    """The canonical SF6 run (README.md's command, device reward) for 3 PPO
    iterations through run_experiment, from a checkpoint of random weights
    written first, so that the initial weights are known; the launch counts
    are zeroed just before and read just after."""
    import tempfile

    from molgym_tpu_torch.ops import fused_agg
    from molgym_tpu_torch.tools import util
    from molgym_tpu_torch.tools.arg_parser import build_default_argparser
    from molgym_tpu_torch.tools.driver import (run_experiment, standard_envs,
                                               symbols_to_zs)
    from molgym_tpu_torch.tools.model_io import ModelIO
    from molgym_tpu_torch.tools.model_util import build_model
    from molgym_tpu_torch.spaces import ObservationSpace

    with tempfile.TemporaryDirectory() as tmp:
        config = vars(build_default_argparser().parse_args(
            CANONICAL + [f'--{d}_dir={tmp}/{d}' for d in
                         ('log', 'model', 'data', 'results')] +
            ['--load_latest']))
        util.create_directories([config['model_dir']])
        tag = util.get_tag(config)
        space = ObservationSpace(config['canvas_size'],
                                 symbols_to_zs(config['symbols']))
        torch.manual_seed(SEED + 1)
        init = build_model(config, space, device=dev)
        ModelIO(config['model_dir'], tag).save(init, num_steps=0)
        before = {k: v.clone() for k, v in init.state_dict().items()}

        torch.cuda.synchronize()
        fused_agg.reset_launch_counts()
        t0 = time.perf_counter()
        agent, optimizer = run_experiment(config, env_builder=standard_envs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(fused_agg.launch_counts)

        def lines(name):
            path = f'{config["results_dir"]}/{tag}_{name}.txt'
            with open(path) as f:
                return [json.loads(line) for line in f]
        opt, train, evals = lines('opt'), lines('train'), lines('eval')
        if len(opt) != 3 or len(train) != 3:
            raise AssertionError(f'{len(opt)} updates, {len(train)} rollouts')
        for rec in opt + train + evals:
            bad = [k for k, v in rec.items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f'non-finite {bad} in {rec}')
        if min(r['num_opt_steps'] for r in opt) < 1:
            raise AssertionError(f'an update took no step: {opt}')
        after = agent.state_dict()
        if all(torch.equal(before[k], v) for k, v in after.items()):
            raise AssertionError('training changed no parameter')

        state, steps = ModelIO(config['model_dir'], tag).load_latest(dev)
        if steps != 420 or state['optimizer']['count'] != optimizer.count:
            raise AssertionError(f'checkpoint at {steps} steps, count '
                                 f'{state["optimizer"]["count"]}')
        for k, v in after.items():
            if not torch.equal(state['model'][k], v):
                raise AssertionError(f'checkpoint differs in {k}')
        for key in ('mu', 'nu'):
            for k, v in state['optimizer'][key].items():
                if not torch.equal(v, getattr(optimizer, key)[k]):
                    raise AssertionError(f'checkpoint {key} differs in {k}')

    # launches: 3 CG levels per policy forward; a rollout of 14 steps per
    # env makes 15 forwards (the bootstrap), an eval rollout 8 + 1; every
    # gradient pass makes one forward and one backward per level
    levels = agent.encoder.num_cg_levels
    passes = sum(r['num_grad_passes'] for r in opt)
    fwd = levels * (len(train) * 15 + len(evals) * 9 + passes)
    expected = {'cg_aggregate_edge_fused_ri': fwd, 'cg_square_fused_ri': fwd,
                'cg_aggregate_edge_fused_ri_bwd': levels * passes,
                'cg_square_fused_ri_bwd': levels * passes}
    if counts != expected:
        raise AssertionError(f'launches {counts}, expected {expected}')
    return dict(seconds=seconds, counts=counts, grad_passes=passes,
                opt_steps=[r['num_opt_steps'] for r in opt],
                rollout_ms=[r['time'] * 1e3 for r in train],
                update_ms=[r['time'] * 1e3 for r in opt],
                iteration_ms=[r['iteration_time'] * 1e3 for r in opt],
                total_loss=[r['total_loss'] for r in opt],
                approx_kl=[r['approx_kl'] for r in opt],
                return_mean=[r['return_mean'] for r in train],
                eval_return_mean=[r['return_mean'] for r in evals])


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

    # the rollout runs forwards only: no backward kernel may launch
    expected = agent.encoder.num_cg_levels * (NUM_STEPS + 1)
    for name, n in counts.items():
        if n != (0 if name.endswith('_bwd') else expected):
            raise AssertionError(f'{name}: {n} launches on the rollout')
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
    agg_bwd = {(B, n): check_aggregate_bwd(dev, B, n)
               for B in (140, 9) for n in (1, 5)}
    sq_bwd = {tau: check_square_bwd(dev, tau) for tau in (10, 12)}
    for k, v in (list(agg.items()) + list(sq.items()) +
                 list(agg_bwd.items()) + list(sq_bwd.items())):
        log('parity', k, json.dumps(v))

    main_path = run_main_path(dev)
    log('main path:', json.dumps(main_path))
    log(f'rollout {NUM_ENVS} envs x {NUM_STEPS} steps: '
        f'{main_path["ms_per_step"]:.3f} ms/step, '
        f'{main_path["env_steps_per_s"]:.1f} env-steps/s on {card}')

    agent_grads = check_agent_grads(dev)
    log('agent gradients:', json.dumps(agent_grads))
    log(f'fwd+bwd of the SF6 agent, minibatch 140: '
        f'{agent_grads["fwd_bwd_ms_median"]:.3f} ms (median of 20) on {card}')

    training = run_training(dev)
    log('training:', json.dumps(training))

    def entry(name, source, replaces, main, others):
        return dict(name=name, route='cuda', source=source, replaces=replaces,
                    launches=training['counts'][name],
                    max_abs_err=max(r['max_abs_err'] for r in others),
                    ms=main['ms'], plain_ms=main['plain_ms'],
                    bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                    library_ms=main['library_ms'], at=main['shape'],
                    checked=[r['shape'] for r in others],
                    rollout_launches=main_path['counts'].get(name, 0))

    kernels = [
        entry('cg_aggregate_edge_fused_ri',
              'molgym_tpu_torch/csrc/cg_aggregate.cu',
              'molgym_tpu/ops/pallas_agg.py:334', agg[(140, 5)],
              list(agg.values())),
        entry('cg_square_fused_ri', 'molgym_tpu_torch/csrc/cg_square.cu',
              'molgym_tpu/ops/pallas_agg.py:91', sq[10], list(sq.values())),
        entry('cg_aggregate_edge_fused_ri_bwd',
              'molgym_tpu_torch/csrc/cg_aggregate_bwd.cu',
              'molgym_tpu/ops/pallas_agg.py:392', agg_bwd[(140, 5)],
              list(agg_bwd.values())),
        entry('cg_square_fused_ri_bwd',
              'molgym_tpu_torch/csrc/cg_square_bwd.cu',
              'molgym_tpu/ops/pallas_agg.py:132', sq_bwd[10],
              list(sq_bwd.values())),
    ]
    print(json.dumps({'main_path': main_path, 'aggregate_level0': agg[(140, 1)],
                      'square_tau12': sq[12],
                      'aggregate_bwd_level0': agg_bwd[(140, 1)],
                      'square_bwd_tau12': sq_bwd[12],
                      'agent_grads': agent_grads, 'training': training}))
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
