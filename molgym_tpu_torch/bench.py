"""The port's counterpart of the JAX system's bench.py: the actor-critic's
fwd+bwd per PPO minibatch on the canonical SF6 covariant configuration
(X, F, S; canvas 7; width 128; maxl 4; 3 CG levels; hidden 10; 4 channels
an element; 3 gaussians; bag scale 5; distances 1.10-2.10; beta -10;
minibatch 140), and bench.py's extras, measured on one CUDA card.

    python3 -m molgym_tpu_torch.bench [--iters 30] [--reps 5]

Prints one JSON record {"metric", "value", "unit", "vs_baseline", "extra"}
on stdout as soon as the headline is measured, and again after every
extra: the last line of stdout is the full record. Logs go to stderr.
Without a CUDA card it exits with code 2 and prints nothing on stdout;
there is no CPU path for the timings. Nothing is skipped and no failure
is caught: a failing extra fails the run.

The loss is bench.py's, mean(logp) + 0.5 mean(v^2) + 0.01 mean(ent) over
`evaluate`, and its gradient is torch.autograd.grad of it with respect to
every parameter. The batch is bench.py's recipe (`make_batch`,
RandomState seed 0); the seed actions come from the agent's own sampled
`act` on a SEED_BATCH = 10 batch on the CPU, from parameters drawn with
torch.manual_seed(0), and are tiled with the observations to 140 or 2240.
Before a gradient configuration is timed, its gradients on the card are
held against the same agent's on the CPU (plain versions): each leaf
within MODEL_TOL (bf16 encoder: BF16_MODEL_TOL) of its max |g| at B = 140,
every gradient finite at B = 2240.

value   mean ms of one fwd+bwd at B = 140 (f32, TF32 off): 1 warm-up call,
        then --iters calls back to back and one synchronize (bench.py's
        time_grad).
vs_baseline  null: bench.py's denominator is a CPU reading of its own
        host (see NO_COUNTERPART).
extra   bench.py's names:
        headline_compile_s   seconds of the first call, the build of every
                             kernel (cuda_build.build, all nvcc processes
                             at once; nothing when built) included
        cache_warm, cache_dir, cache_entries_at_start
                             whether molgym_tpu_torch/_build held every
                             kernel's library at start, its path, its files
        ms_headline_rerun    the headline's protocol a second time
        mfu_est_pct, mfu_est_pct_batch_2240, mfu_est_pct_bf16_2240
                             FLOPs of one fwd+bwd (count_flops) / its time
                             / the H100's published dense peak for the
                             encoder's dtype (PEAK_FLOP_PER_S)
        ms_batch_2240        f32 at B = 2240 (10 calls)
        ms_bf16, ms_bf16_2240  the bf16 encoder at 140 and 2240
        ms_internal_agent    the SchNet (internal) agent at 140, not tiled
        env_steps_per_sec_pm6, env_steps_per_sec_eht (pipelined),
        env_steps_per_sec_eht_serial (in step)
                             SF6, 10 envs x 14 steps, the best of --reps
        load_avg_1m, bench_started_unix, skipped (always empty)
        added for the port:
        fwd_bwd_ms_p50, fwd_bwd_ms_p90, fwd_bwd_samples
                             100 calls at B = 140, each ended by a
                             synchronize
        device_busy_ms, launches_per_fwd_bwd
                             the kernels' summed time and launches of one
                             call under torch.profiler
        device_idle_share    1 - device_busy_ms / fwd_bwd_ms_p50
        profiled_wall_ms, device_idle_share_profiled
                             the profiled call's wall time and idle share
                             (the profiler's own cost included)
        peak_memory_bytes    max_memory_allocated over one call
        flops_per_fwd_bwd, peak_flop_per_s, flop_count_note
        env_steps_per_sec_pm6_serial  PM6 in step, the pair of the above
        auto_transport_pm6, auto_transport_eht
                             the transport --host_reward_mode=auto keeps
                             (pipelined or in_step, the JAX serial loop's
                             counterpart) at SF6, 10 envs x 14 steps,
                             calling the selector until it has chosen
        auto_transport_probe_ms  its two timed probes' ms, by reward
        env_steps_reps       every rep of each transport: ms, the host
                             reward's share, the library's pool counts
        gates                each configuration's card-against-CPU reading
        device, nproc, settings, no_counterpart

FLOPs (count_flops), over one fwd+bwd on the CPU through the plain
versions at B = 140: the CG contractions' operations as their kernels do
them, from the tables' nonzeros (product_ops, square_ops, aggregate_ops,
which chip_smoke.py's bounds also use), and
torch.utils.flop_counter.FlopCounterMode's count of every other matrix
product (mm, bmm and the einsums that lower to them). No other elementwise
work is counted. bench.py counts XLA's HLO of its einsum lowering, which
contracts against dense CG tables, so its mfu estimates and these count
different work. At 2240 the count is 16 times that at 140: the batch is 16
tiles of the same rows.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

METRIC = 'sf6_covariant_fwdbwd_ms_per_minibatch'
BATCH = 140  # the canonical SF6 minibatch
CANVAS = 7
ZS = (0, 9, 16)  # X, F, S
MAXL = 4
NUM_LEVELS = 3
HIDDEN = 10
CPE = 4  # channels per element
WIDTH = 128
SEED = 0
SEED_BATCH = 10  # divides 140 and 2240
BIG_BATCH = 2240
ITERS, ITERS_2240, SAMPLES, REPS = 30, 10, 100, 5
HOST_ENVS, HOST_STEPS = 10, 14  # experiments/sf6_eht and sf6_pm6

MODEL_TOL = 1e-3   # each gradient, card vs CPU, of its leaf's max |g|
# the bf16 encoder (bf16 rounds at other places in cuBLAS and in the CPU's
# matmuls)
BF16_MODEL_TOL = 0.03
# the H100 SXM's published dense peaks: f32 outside the tensor cores, bf16
# on them
PEAK_FLOP_PER_S = {'float32': 67e12, 'bfloat16': 989e12}
FLOP_COUNT_NOTE = (
    'one fwd+bwd at B = 140, counted on the CPU through the plain versions: '
    'the CG kernels\' operations from their tables\' nonzeros (the counts '
    'of chip_smoke.py\'s bounds) plus FlopCounterMode\'s other matrix '
    'products (mm, bmm, einsum); no other elementwise work; 16x at B = 2240')

# bench.py's names that have no counterpart in the port, and why
NO_COUNTERPART = {
    'ms_einsum_agg': 'the port has one aggregate route; --agg_backend other '
                     'than auto is refused (tools/arg_parser.py)',
    'vs_baseline': 'its denominator is a CPU reading of the TPU host; kept '
                   'as null',
    'baseline_pin_ms': 'a pinned CPU reading of the TPU host, not of the port',
    'baseline_live_ms': 'times PyTorch\'s CPU kernels, not the port',
}
# every counterpart with a number, finite and positive in a full record
COUNTERPARTS = (
    'ms_headline_rerun', 'mfu_est_pct', 'mfu_est_pct_batch_2240',
    'mfu_est_pct_bf16_2240', 'ms_batch_2240', 'ms_bf16', 'ms_bf16_2240',
    'ms_internal_agent', 'env_steps_per_sec_pm6',
    'env_steps_per_sec_pm6_serial', 'env_steps_per_sec_eht',
    'env_steps_per_sec_eht_serial')
EXTRA_NAMES = COUNTERPARTS + (
    'bench_started_unix', 'cache_dir', 'cache_entries_at_start', 'cache_warm',
    'headline_compile_s', 'load_avg_1m', 'skipped', 'fwd_bwd_ms_p50',
    'fwd_bwd_ms_p90', 'fwd_bwd_samples', 'device_busy_ms',
    'device_idle_share', 'profiled_wall_ms', 'device_idle_share_profiled',
    'launches_per_fwd_bwd', 'peak_memory_bytes', 'flops_per_fwd_bwd',
    'peak_flop_per_s', 'flop_count_note', 'env_steps_reps', 'gates', 'device', 'nproc',
    'settings', 'no_counterpart', 'auto_transport_pm6', 'auto_transport_eht',
    'auto_transport_probe_ms')
# the transports the selector may keep (auto_transport_*)
TRANSPORTS = ('pipelined', 'in_step')
AUTO_MAX_CALLS = 8   # bench.py's bench_auto_transport


def log(*args):
    print(*args, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the batch, the agents and the loss
# ---------------------------------------------------------------------------

def make_batch(rng_seed: int = SEED, batch: Optional[int] = None,
               canvas: Optional[int] = None, num_zs: Optional[int] = None):
    """bench.py's random canvases: 1 to `canvas` atoms of elements 1..,
    1-5 of element 1 and one of element 2 in the bag (a further element's
    count 0-2). int32 elements and bag, float32 positions."""
    batch = BATCH if batch is None else batch
    canvas = CANVAS if canvas is None else canvas
    num_zs = len(ZS) if num_zs is None else num_zs
    rng = np.random.RandomState(rng_seed)
    n_atoms = rng.randint(1, canvas + 1, size=batch)
    elements = np.zeros((batch, canvas), np.int32)
    positions = np.zeros((batch, canvas, 3), np.float32)
    bag = np.zeros((batch, num_zs), np.int32)
    for b in range(batch):
        elements[b, :n_atoms[b]] = rng.randint(1, num_zs, size=n_atoms[b])
        positions[b, :n_atoms[b]] = rng.randn(n_atoms[b], 3) * 1.2
        bag[b, 1] = rng.randint(1, 6)
        bag[b, 2] = 1
        if num_zs > 3:
            bag[b, 3:] = rng.randint(0, 3, size=num_zs - 3)
    return elements, positions, bag


def observation(arrays, device):
    """The port's Observation of make_batch's arrays on `device`."""
    from molgym_tpu_torch.spaces import Observation
    elements, positions, bag = arrays
    return Observation(
        elements=torch.from_numpy(elements.astype(np.int64)).to(device),
        positions=torch.from_numpy(positions).to(device),
        bag=torch.from_numpy(bag.astype(np.int64)).to(device))


def make_agent(encoder_dtype: Optional[str] = None, device='cuda'):
    from molgym_tpu_torch.agents.covariant import CovariantAC
    return CovariantAC(zs=ZS, canvas_size=CANVAS, network_width=WIDTH,
                       maxl=MAXL, num_cg_levels=NUM_LEVELS,
                       num_channels_hidden=HIDDEN,
                       num_channels_per_element=CPE, num_gaussians=3,
                       bag_scale=5, min_max_distance=(1.10, 2.10), beta=-10.0,
                       encoder_dtype=encoder_dtype, device=device)


def make_internal_agent(device='cuda'):
    from molgym_tpu_torch.agents.schnet import make_schnet_agent
    return make_schnet_agent(num_zs=len(ZS), canvas_size=CANVAS,
                             network_width=WIDTH,
                             min_max_distance=(1.10, 2.10), n_interactions=3,
                             device=device)


def bench_loss(logp, ent, v):
    """bench.py's PPO-shaped scalar: policy, value and entropy terms."""
    return logp.mean() + 0.5 * (v ** 2).mean() + 0.01 * ent.mean()


def make_grad_fn(agent, obs, actions) -> Callable:
    """fn() -> (loss, gradients): the loss on (obs, actions) and its
    gradient with respect to each parameter of `agent`, in the order of
    fn.names (None where a parameter does not reach the loss). Nothing
    accumulates between calls."""
    names, params = zip(*agent.named_parameters())

    def fn():
        loss = bench_loss(*agent.evaluate(obs, actions))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), grads

    fn.names = names
    return fn


_SEED_CACHE: Dict[str, tuple] = {}


def seed_batch(kind: Optional[str] = None):
    """(state_dict, elements, positions, bag, actions) made on the CPU and
    cached per kind (None or 'float32', 'bfloat16': the covariant agent
    with that encoder, on a SEED_BATCH batch; 'internal': the SchNet agent
    on a BATCH batch, as bench.py's build_internal_grad_fn): parameters
    drawn after torch.manual_seed(SEED), actions from the agent's sampled
    `act` with a generator seeded SEED. Every kind draws its parameters
    from the same seed, so the bf16 agent has the f32 agent's."""
    kind = kind or 'float32'
    if kind not in _SEED_CACHE:
        torch.manual_seed(SEED)
        if kind == 'internal':
            agent = make_internal_agent('cpu')
            arrays = make_batch()
        else:
            agent = make_agent(None if kind == 'float32' else kind, 'cpu')
            arrays = make_batch(batch=SEED_BATCH)
        with torch.no_grad():
            acts = agent.act(observation(arrays, 'cpu'),
                             torch.Generator().manual_seed(SEED)).action_flat
        _SEED_CACHE[kind] = (agent.state_dict(), *arrays, acts.numpy())
    return _SEED_CACHE[kind]


def tiled(arrays, actions, batch, device):
    """(obs, actions) of `batch` rows: the seed rows repeated, observations
    and actions together."""
    rows = len(actions)
    if batch % rows:
        raise ValueError(f'batch {batch} is not a multiple of {rows}')
    reps = batch // rows
    elements, positions, bag = arrays
    obs = observation((np.tile(elements, (reps, 1)),
                       np.tile(positions, (reps, 1, 1)),
                       np.tile(bag, (reps, 1))), device)
    return obs, torch.from_numpy(np.tile(actions, (reps, 1))).to(device)


def build_grad_fn(batch: int = BATCH, encoder_dtype: Optional[str] = None,
                  device='cuda') -> Callable:
    """The covariant agent's fwd+bwd at `batch` on `device` (bench.py's
    build_grad_fn)."""
    state, *arrays, acts = seed_batch(encoder_dtype)
    agent = make_agent(encoder_dtype, device)
    agent.load_state_dict(state)
    return make_grad_fn(agent, *tiled(arrays, acts, batch, device))


def build_internal_grad_fn(device='cuda') -> Callable:
    """The SchNet agent's fwd+bwd at BATCH on `device`, not tiled (bench.py's
    build_internal_grad_fn)."""
    state, *arrays, acts = seed_batch('internal')
    agent = make_internal_agent(device)
    agent.load_state_dict(state)
    return make_grad_fn(agent, observation(arrays, device),
                        torch.from_numpy(acts).to(device))


# ---------------------------------------------------------------------------
# the gate: gradients on the card against the CPU's
# ---------------------------------------------------------------------------

def grad_errs(grads: dict, ref: dict) -> dict:
    """{leaf: max |g - ref| over the leaf's max |ref|}, a leaf below 1e-3
    of the largest leaf's max |ref| held against 1e-3 of that (its true
    gradient may be zero: a softmax does not see a shift of its logits)."""
    floor = 1e-3 * max(float(g.abs().max()) for g in ref.values())
    return {k: float((grads[k].to(g.device) - g).abs().max())
            / max(float(g.abs().max()), floor) for k, g in ref.items()}


def check_grads(what: str, grads: dict, ref: dict, tol: float) -> float:
    """Raises unless every leaf of `ref` has a gradient in `grads` within
    `tol` (grad_errs); returns the worst share."""
    missing = sorted(k for k in ref if grads.get(k) is None)
    if missing:
        raise AssertionError(f'{what}: no gradient for {missing}')
    errs = grad_errs(grads, ref)
    worst = max(errs, key=errs.get)
    if not errs[worst] <= tol:
        raise AssertionError(f'{what}: gradient of {worst}: card vs CPU '
                             f'differ by {errs[worst]} of the leaf\'s max |g|')
    return errs[worst]


def product_ops(rows: int, tabs: dict, backward: bool = False) -> int:
    """Operations of the CG product's kernel over `rows` rows (tabs:
    fused_cg.kernel_tables): forward, a complex product (6) and a complex
    multiply-add by a real coefficient (4) for each nonzero; backward, 4 for
    each nonzero (dz) and 8 for each live pair in da and 8 in db."""
    if backward:
        return rows * (tabs['nnz'] * 4 + tabs['n_live'] * 16)
    return rows * tabs['nnz'] * 10


def square_ops(rows: int, tabs: dict, backward: bool = False) -> int:
    """Operations of the CG square's kernel over `rows` rows (tabs:
    fused_agg._kernel_tables('square', ...)): forward, 6 for each pair some
    column reads and 4 for each nonzero; backward, 4 for each nonzero and 8
    for each of the two terms of every live pair."""
    if backward:
        return rows * (tabs['nnz'] * 4 + tabs['n_live'] * 16)
    return rows * (tabs['slot_mn'].numel() * 6 + tabs['nnz'] * 4)


def aggregate_ops(B: int, N: int, tau: int, m1: int, m2: int, tabs: dict,
                  backward: bool = False) -> int:
    """Operations of the edge aggregate's kernel (tabs:
    fused_agg._kernel_tables('aggregate', ...)): forward, the edge rep
    e = rad * Y (2 an element), z's complex multiply-adds over the
    neighbours (8 each) and 4 for each nonzero and row of the contraction;
    backward, dz's sparse rows (4 a nonzero), e again, d e and d q (8 each)
    and Re(d e conj Y) (4 an element)."""
    edges = B * N * N * tau * m1            # elements of the edge rep
    sparse = B * N * tau * tabs['nnz'] * 4
    if backward:
        return sparse + edges * 2 + edges * m2 * 16 + edges * 4
    return edges * 2 + edges * m2 * 8 + sparse


def count_flops(fn) -> Tuple[tuple, dict]:
    """fn()'s result and its FLOPs, counted on the CPU through the plain
    versions: the CG contractions' operations as their kernels do them,
    from their tables' nonzeros (product_ops, square_ops, aggregate_ops,
    forward and backward), and FlopCounterMode's count of every other
    matrix product. While fn runs, each CG call takes its plain forward and
    its plain backward formula (the kernels' backward), and what
    FlopCounterMode counts inside them is taken out of its count."""
    import inspect

    from torch.autograd.function import once_differentiable
    from torch.utils.flop_counter import FlopCounterMode

    from molgym_tpu_torch.ops import fused_agg, fused_cg

    counter = FlopCounterMode(display=False)
    cg = dict(ops=0, counted=0)

    def measured(call, ops):
        before = counter.get_total_flops()
        out = call()
        cg['counted'] += counter.get_total_flops() - before
        cg['ops'] += ops
        return out

    def counted(fwd, bwd, n_tensors, ops):
        """fwd, with bwd as its backward; ops(*args, backward) the
        operations of a call. The first n_tensors arguments are tensors, the
        gradient of the last len(bwd's result) of them."""
        class Counted(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *args):
                ctx.save_for_backward(*args[:n_tensors])
                ctx.rest = args[n_tensors:]
                return measured(lambda: fwd(*args), ops(*args, False))

            @staticmethod
            @once_differentiable
            def backward(ctx, *grads):
                saved = ctx.saved_tensors
                d = measured(lambda: bwd(*saved, *grads, *ctx.rest),
                             ops(*saved, *ctx.rest, True))
                return ((None, ) * (n_tensors - len(d)) + tuple(d)
                        + (None, ) * len(ctx.rest))

        signature = inspect.signature(fwd)

        def call(*args, **kwargs):
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            return Counted.apply(*bound.args)
        return call

    def product(a_r, a_i, b_r, b_i, table3, backward):
        return product_ops(a_r.numel() // a_r.shape[-1],
                           fused_cg.kernel_tables(table3, 'cpu'), backward)

    def square(a_r, a_i, table3, grouped, tri, backward):
        return square_ops(a_r.numel() // a_r.shape[-1],
                          fused_agg._kernel_tables('square', table3, grouped,
                                                   tri, 'cpu'), backward)

    def aggregate(sph_packed, rad_feats, atom_r, atom_i, table3, grouped,
                  backward):
        B, N, _, tau, _l = rad_feats.shape
        return aggregate_ops(B, N, tau, sph_packed.shape[-2],
                             atom_r.shape[-1],
                             fused_agg._kernel_tables('aggregate', table3,
                                                      grouped, None, 'cpu'),
                             backward)

    plain = (fused_cg.cg_contract_ri_plain, fused_agg.cg_square_fused_ri_plain,
             fused_agg.cg_aggregate_edge_fused_ri_plain)
    fused_cg.cg_contract_ri_plain = counted(
        plain[0], fused_cg.cg_contract_ri_bwd_plain, 4, product)
    fused_agg.cg_square_fused_ri_plain = counted(
        plain[1], fused_agg.cg_square_fused_ri_bwd_plain, 2, square)
    fused_agg.cg_aggregate_edge_fused_ri_plain = counted(
        plain[2], fused_agg.cg_aggregate_edge_fused_ri_bwd_plain, 4,
        aggregate)
    try:
        with counter:
            result = fn()
    finally:
        (fused_cg.cg_contract_ri_plain, fused_agg.cg_square_fused_ri_plain,
         fused_agg.cg_aggregate_edge_fused_ri_plain) = plain
    other = int(counter.get_total_flops()) - cg['counted']
    return result, dict(total=other + cg['ops'], cg_kernels=cg['ops'],
                        other_matrix_products=other)


def check_finite(what: str, names, result) -> dict:
    """Raises unless the loss and every gradient of `result` = (loss,
    gradients in the order of `names`) are there and finite."""
    loss, grads = result
    bad = [n for n, g in zip(names, grads)
           if g is None or not bool(torch.isfinite(g).all())]
    if bad or not math.isfinite(float(loss)):
        raise AssertionError(f'{what}: non-finite or missing gradients {bad}, '
                             f'loss {float(loss)}')
    return dict(finite=True, leaves=len(grads), loss_card=float(loss))


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------

def time_grad(fn, iters: int) -> float:
    """bench.py's time_grad: 1 warm-up call, `iters` calls back to back,
    one synchronize; the mean ms."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3 / iters


def sample_ms(fn, samples: int) -> list:
    """The ms of `samples` calls, each ended by a synchronize."""
    times = []
    for _ in range(samples):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return times


def sample_grad(fn, samples: int) -> dict:
    """sample_ms's p50, p90 and count."""
    times = sample_ms(fn, samples)
    return dict(fwd_bwd_ms_p50=float(np.percentile(times, 50)),
                fwd_bwd_ms_p90=float(np.percentile(times, 90)),
                fwd_bwd_samples=len(times))


# torch.profiler (PyTorch 2.11 on an H100) now and then drops the first
# device records of a profiling window, more late in a process (4 to 39 of
# a fwd+bwd's 2,696 launches); a window starts with PAD_LAUNCHES spin
# kernels, which take the loss and are left out of every count
PAD_LAUNCHES = 256
PAD_KERNEL = 'spin_kernel'


def pad_profiler() -> None:
    """PAD_LAUNCHES spin kernels (PAD_KERNEL), then a synchronize: the
    first thing of a profiling window on the card."""
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def profile_grad(fn) -> dict:
    """One call under torch.profiler: its wall ms, the device's busy ms (its
    kernels' summed time), idle share of the wall time and kernel launches.
    Raises where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    from molgym_tpu_torch.profile_rollout import device_us

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pad_profiler()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith('CUDA') and device_us(e) > 0
               and PAD_KERNEL not in e.key]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    if not busy_ms > 0:
        raise RuntimeError('torch.profiler saw no device time')
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                launches_per_fwd_bwd=sum(e.count for e in kernels))


def peak_memory(fn) -> int:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return int(torch.cuda.max_memory_allocated())


# ---------------------------------------------------------------------------
# host-reward rollouts
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def run_transport(rollout, agent, env, calc, num_envs: int, seed: int,
                  device):
    """One rollout of `num_envs` envs through `rollout` (a transport of
    rl/rollout.py) from a generator seeded `seed`; `calc` is the env's
    TimedBatchCalculator. Returns its readings (ms; the host reward's ms,
    calls and share; the forwards computed again; the library's energy
    evaluations and batches) and (states, trajectory, generator state)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    states = env.init_states(num_envs, gen)
    time0, calls0 = calc.total_time, calc.total_calls
    evals0, batches0 = calc.pool_stats()
    _sync(device)
    start = time.perf_counter()
    states, traj = rollout(agent, states, gen)
    _sync(device)
    ms = (time.perf_counter() - start) * 1e3
    evals, batches = calc.pool_stats()
    reward_ms = (calc.total_time - time0) * 1e3
    res = dict(ms=ms, reward_ms=reward_ms, reward_share=reward_ms / ms,
               reward_calls=calc.total_calls - calls0,
               recomputes=getattr(rollout, 'recomputes', 0),
               pool_evaluations=evals - evals0,
               pool_batches=batches - batches0)
    return res, (states, traj, gen.get_state())


def check_same_rollout(what: str, run, ref) -> None:
    """Raises unless two transports' (states, trajectory, generator state)
    are the same bits: every field of the trajectories, the final canvases
    and the generator's final state."""
    (states, traj, gen_state), (ref_states, ref_traj, ref_gen) = run, ref
    same = [torch.equal(getattr(traj, f), getattr(ref_traj, f)) for f in (
        'rewards', 'terminals', 'actions', 'logps', 'values',
        'bootstrap_value')]
    same += [torch.equal(getattr(getattr(traj, o), f),
                         getattr(getattr(ref_traj, o), f))
             for o in ('obs', 'next_obs') for f in ('elements', 'positions',
                                                    'bag')]
    same += [torch.equal(states.elements, ref_states.elements),
             torch.equal(gen_state, ref_gen)]
    if not all(same):
        raise AssertionError(f'{what}: the pipelined transport gave another '
                             f'trajectory than the in-step one ({same})')


def host_setup(method: int, device, agent_kwargs: Optional[dict] = None,
               formula: str = 'SF6'):
    """(env, agent, calc) of a host-reward rollout: one
    TimedBatchCalculator of the host reward `method`
    (calculators/native.py), the env over `formula` whose reward function
    calls it in the step, and the covariant agent of `agent_kwargs`
    (default bench.py's SF6 agent) with parameters drawn after
    torch.manual_seed(SEED)."""
    from molgym_tpu_torch.calculators.native import NativeBatchCalculator
    from molgym_tpu_torch.calculators.reward_host import (
        TimedBatchCalculator, make_host_reward)
    from molgym_tpu_torch.envs.environment import MolecularEnv
    from molgym_tpu_torch.formula import string_to_formula
    from molgym_tpu_torch.spaces import ObservationSpace

    if agent_kwargs is None:
        canvas, zs = CANVAS, ZS
    else:
        canvas, zs = agent_kwargs['canvas_size'], agent_kwargs['zs']
    space = ObservationSpace(canvas_size=canvas, zs=list(zs))
    bag = space.bag_from_formula(string_to_formula(formula))
    calc = TimedBatchCalculator(NativeBatchCalculator(method))
    env = MolecularEnv(make_host_reward(calc), space, bag[None], device=device)
    torch.manual_seed(SEED)
    if agent_kwargs is None:
        agent = make_agent(device=device)
    else:
        from molgym_tpu_torch.agents.covariant import CovariantAC
        agent = CovariantAC(**agent_kwargs, device=device)
    return env, agent, calc


def auto_transport(method: int, device='cuda',
                   agent_kwargs: Optional[dict] = None, formula: str = 'SF6',
                   num_envs: int = HOST_ENVS,
                   num_steps: int = HOST_STEPS) -> dict:
    """The transport that --host_reward_mode=auto keeps for the host reward
    `method` (bench.py's bench_auto_transport): the selector
    (rl/rollout.py's make_auto_host_rollout_fn) over host_setup's env and
    agent, called from the same initial states with a generator seeded
    anew each call until it has chosen, at most AUTO_MAX_CALLS times.
    Returns its choice, the ms of its two timed probes, and its calls."""
    from molgym_tpu_torch.rl import rollout as rl

    env, agent, calc = host_setup(method, device, agent_kwargs, formula)
    rollout = rl.make_auto_host_rollout_fn(env, agent, calc, num_steps)
    states = env.init_states(num_envs, torch.Generator(
        device=device).manual_seed(SEED))
    calls = 0
    while rollout.choice is None and calls < AUTO_MAX_CALLS:
        rollout(agent, states, torch.Generator(device=device).manual_seed(
            SEED + 1 + calls))
        calls += 1
    return dict(choice=rollout.choice, calls=calls,
                probe_ms={n: t * 1e3 for n, t in rollout.times.items()})


def host_env_steps(method: int, reps: int = REPS, device='cuda',
                   agent_kwargs: Optional[dict] = None, formula: str = 'SF6',
                   num_envs: int = HOST_ENVS,
                   num_steps: int = HOST_STEPS) -> dict:
    """Env-steps/s of a training rollout with the host reward `method`
    (calculators/native.py) through the pipelined and the in-step
    ('serial') transport, over host_setup's env, agent and calculator.
    First both transports from one generator state (SEED), which must give
    the same trajectory (check_same_rollout; the in-step run meets the
    energies the pipelined one computed); then `reps` rounds of both, the order alternating, each
    rollout from a seed of its own, so that no rollout meets another's
    geometries. Returns each transport's best env-steps/s and its readings."""
    from molgym_tpu_torch.rl import rollout as rl

    env, agent, calc = host_setup(method, device, agent_kwargs, formula)
    rollouts = {'pipelined': rl.make_pipelined_host_rollout_fn(
                    env, agent, calc, num_steps),
                'serial': rl.make_rollout_fn(env, agent, num_steps)}
    first = {name: run_transport(fn, agent, env, calc, num_envs, SEED, device)
             for name, fn in rollouts.items()}
    check_same_rollout(f'method {method}', first['pipelined'][1],
                       first['serial'][1])
    readings = {name: [] for name in rollouts}
    for rep in range(reps):
        order = list(rollouts) if rep % 2 == 0 else list(rollouts)[::-1]
        for name in order:
            seed = SEED + 1 + 2 * rep + list(rollouts).index(name)
            res, _ = run_transport(rollouts[name], agent, env, calc, num_envs,
                                   seed, device)
            res.update(seed=seed,
                       env_steps_per_s=num_envs * num_steps * 1e3 / res['ms'])
            readings[name].append(res)
    best = {name: max(r['env_steps_per_s'] for r in rs)
            for name, rs in readings.items()}
    return dict(best=best, readings=readings, same_trajectory=True,
                first=first['pipelined'][0], first_serial=first['serial'][0])


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

def card_line() -> str:
    """`name, power limit` of the first card, as nvidia-smi gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check_record(record: dict) -> None:
    """Raises unless a full record has every counterpart finite and
    positive, the headline's value too, and no other name than
    EXTRA_NAMES."""
    extra = record['extra']
    unknown = sorted(set(extra) - set(EXTRA_NAMES))
    missing = sorted(set(EXTRA_NAMES) - set(extra))
    if unknown or missing:
        raise AssertionError(f'record: names {unknown} not declared, '
                             f'{missing} missing')
    values = {'value': record['value'],
              **{name: extra[name] for name in COUNTERPARTS}}
    bad = {k: v for k, v in values.items()
           if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0)}
    if bad or record['metric'] != METRIC or record['unit'] != 'ms':
        raise AssertionError(f'record: {bad}, {record["metric"]}, '
                             f'{record["unit"]}')
    if sorted(extra['no_counterpart']) != sorted(NO_COUNTERPART):
        raise AssertionError(f'record: no_counterpart {extra["no_counterpart"]}')
    choices = [extra[f'auto_transport_{name}'] for name in ('pm6', 'eht')]
    if not all(c in TRANSPORTS for c in choices):
        raise AssertionError(f'record: auto_transport {choices}')


def run(iters: int = ITERS, iters_2240: int = ITERS_2240,
        samples: int = SAMPLES, reps: int = REPS,
        emit: Callable[[dict], None] = lambda record: None) -> dict:
    """The whole bench on the card; `emit(record)` after the headline and
    after every extra. Returns the full record (check_record holds it)."""
    from molgym_tpu_torch import cuda_build
    from molgym_tpu_torch.calculators.native import METHOD_EHT, METHOD_PM6

    started = time.time()
    dev = torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    build_dir = cuda_build.BUILD_DIR
    entries = len(list(build_dir.iterdir())) if build_dir.is_dir() else 0
    warm = all(cuda_build.library_path(n).exists()
               for n in cuda_build.KERNEL_SOURCES)
    extra: dict = {}
    record = dict(metric=METRIC, value=None, unit='ms', vs_baseline=None,
                  extra=extra)

    def put(**values):
        for name in values:
            if name not in EXTRA_NAMES:
                raise KeyError(f'{name} is not a name of the record')
        extra.update(values)

    def done(what):
        log(f'bench: {what} at {time.time() - started:.1f} s')
        emit(record)

    put(bench_started_unix=int(started), cache_dir=str(build_dir),
        cache_entries_at_start=entries, cache_warm=warm, skipped=[],
        device=dict(name=torch.cuda.get_device_name(0),
                    count=torch.cuda.device_count(),
                    power_limit=card.split(',')[-1].strip(),
                    nvidia_smi=card),
        nproc=os.cpu_count(),
        settings=dict(iters=iters, iters_2240=iters_2240, samples=samples,
                      reps=reps),
        no_counterpart=dict(NO_COUNTERPART), gates={},
        flops_per_fwd_bwd={}, peak_flop_per_s=dict(PEAK_FLOP_PER_S),
        flop_count_note=FLOP_COUNT_NOTE, env_steps_reps={},
        auto_transport_probe_ms={})

    def first_call(fn):
        result = fn()
        torch.cuda.synchronize()
        return result

    def gated(what, result, cpu_fn, tol):
        """`result` = (loss, gradients), the first call on the card, held
        against cpu_fn's on the CPU (check_grads); the gate's readings and
        the CPU pass's FLOPs (count_flops) recorded, the FLOPs returned."""
        (cpu_loss, cpu_grads), flops = count_flops(cpu_fn)
        loss, grads = result
        worst = check_grads(what, dict(zip(cpu_fn.names, grads)),
                            dict(zip(cpu_fn.names, cpu_grads)), tol)
        extra['gates'][what] = dict(
            max_grad_err_share=worst, tol=tol, leaves=len(cpu_grads),
            loss_card=float(loss), loss_cpu=float(cpu_loss))
        extra['flops_per_fwd_bwd'][what] = flops
        return flops['total']

    # the headline: the kernels' build and the first call, the gate, then
    # bench.py's protocol
    fn = build_grad_fn(BATCH, None, dev)
    start = time.perf_counter()
    cuda_build.build()
    result = first_call(fn)
    compile_s = time.perf_counter() - start
    flops = gated('float32_140', result, build_grad_fn(BATCH, None, 'cpu'),
                  MODEL_TOL)
    ms = time_grad(fn, iters)
    record['value'] = ms
    put(headline_compile_s=compile_s, load_avg_1m=os.getloadavg()[0])
    log(f'bench: {ms:.3f} ms a fwd+bwd at B = {BATCH} on {card}')
    done('headline')

    put(ms_headline_rerun=time_grad(fn, iters))
    stats = sample_grad(fn, samples)
    prof = profile_grad(fn)
    put(**stats, device_busy_ms=prof['device_busy_ms'],
        device_idle_share=(1.0 - prof['device_busy_ms']
                           / stats['fwd_bwd_ms_p50']),
        profiled_wall_ms=prof['wall_ms'],
        device_idle_share_profiled=prof['device_idle_share'],
        launches_per_fwd_bwd=prof['launches_per_fwd_bwd'])
    put(peak_memory_bytes=peak_memory(fn))
    done('headline statistics')
    put(mfu_est_pct=flops / (ms / 1e3) / PEAK_FLOP_PER_S['float32'] * 100)
    done('mfu_est_pct')

    def host(name, method):
        res = host_env_steps(method, reps, dev)
        extra['gates'][f'transports_{name}'] = dict(
            same_trajectory=res['same_trajectory'])
        extra['env_steps_reps'][name] = dict(
            res['readings'], first=res['first'],
            first_serial=res['first_serial'])
        put(**{f'env_steps_per_sec_{name}': res['best']['pipelined'],
               f'env_steps_per_sec_{name}_serial': res['best']['serial']})
        done(f'{name} env-steps/s')
        auto = auto_transport(method, dev)
        put(**{f'auto_transport_{name}': auto['choice']})
        extra['auto_transport_probe_ms'][name] = auto['probe_ms']
        log(f'bench: auto transport for {name}: {auto["choice"]} '
            f'({auto["probe_ms"]})')
        done(f'auto_transport_{name}')
    host('pm6', METHOD_PM6)

    tiles = BIG_BATCH // BATCH

    def big(what, encoder_dtype):
        """B = 2240: every gradient finite, then timed."""
        fn = build_grad_fn(BIG_BATCH, encoder_dtype, dev)
        extra['gates'][what] = check_finite(what, fn.names, first_call(fn))
        return time_grad(fn, iters_2240)

    fn = build_grad_fn(BATCH, 'bfloat16', dev)
    flops16 = gated('bfloat16_140', first_call(fn),
                    build_grad_fn(BATCH, 'bfloat16', 'cpu'), BF16_MODEL_TOL)
    put(ms_bf16=time_grad(fn, iters))
    done('ms_bf16')
    put(ms_bf16_2240=big('bfloat16_2240', 'bfloat16'))
    put(mfu_est_pct_bf16_2240=tiles * flops16 / (extra['ms_bf16_2240'] / 1e3)
        / PEAK_FLOP_PER_S['bfloat16'] * 100)
    done('ms_bf16_2240')

    host('eht', METHOD_EHT)

    fn = build_internal_grad_fn(dev)
    gated('internal_140', first_call(fn), build_internal_grad_fn('cpu'),
          MODEL_TOL)
    put(ms_internal_agent=time_grad(fn, iters))
    done('ms_internal_agent')

    put(ms_batch_2240=big('float32_2240', None))
    put(mfu_est_pct_batch_2240=tiles * flops / (extra['ms_batch_2240'] / 1e3)
        / PEAK_FLOP_PER_S['float32'] * 100)
    done('ms_batch_2240')
    check_record(record)
    return record


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='fwd+bwd and env-steps/s of the port on one CUDA card')
    parser.add_argument('--iters', type=int, default=ITERS,
                        help='timed calls of the headline and of each 140 '
                             'extra')
    parser.add_argument('--reps', type=int, default=REPS,
                        help='rollouts of each host transport')
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        log('bench: no CUDA device is visible; the bench times the card only')
        return 2
    run(args.iters, reps=args.reps,
        emit=lambda record: print(json.dumps(record), flush=True))
    return 0


if __name__ == '__main__':
    sys.exit(main())
