"""Where the SF6 covariant fwd+bwd's time goes on one CUDA card: the port's
counterpart of the JAX system's experiments/perf/profile_minibatch.py.

    python3 -m molgym_tpu_torch.profile_minibatch [--sweep] [--trace]
                                                  [--batch 140]
                                                  [--dtype f32|bf16]

The fwd+bwd is bench.py's (molgym_tpu_torch/bench.py: its agent,
`bench_loss`, `make_grad_fn`, `time_grad`, `count_flops`), on the JAX
script's batch: `make_batch(batch)` with RandomState seed 0, distinct rows
at every B (not the bench's seed rows tiled). The parameters are drawn on
the CPU after torch.manual_seed(0) (the bf16 encoder's are the f32
agent's); the actions are the agent's sampled `act` on that batch, run on
the card from a generator seeded 0 (the timings do not depend on them).
Before anything is timed, the gradient at B = 140 on the card is held
against the same agent's on the CPU (plain versions; bench.check_grads,
MODEL_TOL, bf16 BF16_MODEL_TOL), and that CPU pass gives the FLOP count,
which is linear in the rows (the rows are padded to the canvas): B / 140
times the count at 140.

Modes, each printing the JAX script's lines on stdout and then one JSON
line; every run starts with a line naming the card (name, power limit,
count):
  --sweep  f32 at B = 140, 560 and 2240: ms (time_grad, ITERS calls),
           FLOPs, GFLOP/s, MFU% against bench.PEAK_FLOP_PER_S and ms per
           140 rows (sweep_row);
  --trace  at --batch and --dtype: one warm-up call, then TRACE_ITERS calls
           under torch.profiler (CPU and CUDA): the TOP device kernels with
           the most time (us a step, % of the device total, launches a step
           as count // iters, the name cut to NAME_CHARS), the device ms, the
           wall ms and the idle share a step, and the rollup by the operator
           that launched each kernel (the aten op or autograd.Function that
           is the CPU parent of the CUDA runtime call sharing the kernel's
           correlation id): device us, launches and that operator's self
           CPU us a step. The JSON line holds every kernel. The rollup is
           the counterpart of the JAX script's by HLO opcode; a kernel tied
           to no operator is grouped by its name's prefix;
  neither  one point at --batch and --dtype: ms, FLOPs and the MFU estimate.

No counterpart: --agg, --cg and --square (the port has no backend
switches: the device picks the route, and no switch sends the card's path
through the plain versions); enable_compile_cache (XLA's compile cache);
B = 4480, which the JAX script leaves out too. Without a CUDA card it exits
with code 2 and prints nothing on stdout: there is no CPU path for the
timings. No failure is caught.
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import sys
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch

from molgym_tpu_torch import bench

SEED = 0
BATCH = bench.BATCH
SWEEP = (140, 560, 2240)
ITERS = 30        # the JAX script's timed()
TRACE_ITERS = 20  # its run_trace()
TOP = 40
NAME_CHARS = 110
DTYPES = {'f32': None, 'bf16': 'bfloat16'}

# the CUDA kernel (its __global__ name) behind each launch counter of
# ops/kernel_common.py that a covariant fwd+bwd reaches
PORT_KERNELS = {
    'cg_aggregate_edge_fused_ri': 'cg_aggregate_edge_kernel',
    'cg_aggregate_edge_fused_ri_bwd': 'cg_aggregate_bwd_kernel',
    'cg_square_fused_ri': 'cg_square_kernel',
    'cg_square_fused_ri_bwd': 'cg_square_bwd_kernel',
    'cg_contract_ri': 'cg_product_kernel',
    'cg_contract_ri_bwd': 'cg_product_bwd_kernel',
    'masked_softmax': 'head_fwd_kernel',
    'masked_softmax_bwd': 'head_bwd_kernel',
}


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# the batch and the grad program
# ---------------------------------------------------------------------------

def make_batch(batch: int, rng_seed: int = SEED):
    """The JAX script's make_batch: `batch` distinct random canvases."""
    return bench.make_batch(rng_seed, batch)


def build_grad_fn(batch: int, encoder_dtype: Optional[str] = None,
                  device='cuda'):
    """(fn, cpu_fn): the fwd+bwd of bench.py's loss at `batch` on `device`
    (make_grad_fn), and the same agent, batch and actions on the CPU."""
    torch.manual_seed(SEED)
    cpu_agent = bench.make_agent(encoder_dtype, 'cpu')
    agent = bench.make_agent(encoder_dtype, device)
    agent.load_state_dict(cpu_agent.state_dict())
    arrays = make_batch(batch)
    obs = bench.observation(arrays, device)
    with torch.no_grad():
        actions = agent.act(obs, torch.Generator(device=device).manual_seed(
            SEED)).action_flat
    cpu_fn = bench.make_grad_fn(cpu_agent, bench.observation(arrays, 'cpu'),
                                actions.cpu())
    return bench.make_grad_fn(agent, obs, actions), cpu_fn


_GATES: Dict[str, dict] = {}


def gate(dtype: str = 'f32', device='cuda') -> dict:
    """The gradient at B = 140 on the card against the CPU's (once a dtype
    a process): bench.check_grads' worst share and tolerance, and the CPU
    pass's FLOPs (bench.count_flops)."""
    if dtype not in _GATES:
        fn, cpu_fn = build_grad_fn(BATCH, DTYPES[dtype], device)
        loss, grads = fn()
        (cpu_loss, cpu_grads), flops = bench.count_flops(cpu_fn)
        tol = bench.MODEL_TOL if dtype == 'f32' else bench.BF16_MODEL_TOL
        worst = bench.check_grads(f'{dtype} at {BATCH}',
                                  dict(zip(fn.names, grads)),
                                  dict(zip(cpu_fn.names, cpu_grads)), tol)
        _GATES[dtype] = dict(max_grad_err_share=worst, tol=tol,
                             loss_card=float(loss), loss_cpu=float(cpu_loss),
                             flops_140=flops)
    return _GATES[dtype]


def flops_at(dtype: str, batch: int) -> dict:
    """count_flops' breakdown at `batch`: B / 140 times the gate's."""
    return {k: v * batch / BATCH for k, v in gate(dtype)['flops_140'].items()}


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def sweep_row(batch: int, ms: float, flops: float, peak: float) -> dict:
    """The JAX script's row: GFLOP/s, MFU% against `peak` and ms per 140
    rows (experiments/perf/profile_minibatch.py:163-166)."""
    return dict(batch=batch, ms=ms, flops=flops,
                gflop_per_s=flops / (ms / 1e3) / 1e9,
                mfu_pct=flops / (ms / 1e3) / peak * 100,
                ms_per_140_rows=ms / (batch / 140))


def run_sweep(iters: int = ITERS) -> List[dict]:
    log(f'device: {torch.cuda.get_device_name(0)}, dtype=f32')
    gate('f32')
    log(f'{"batch":>6} {"ms":>8} {"flops":>12} {"GFLOP/s":>10} '
        f'{"MFU%":>7} {"ms/140rows":>11}')
    rows = []
    for batch in SWEEP:
        fn, _cpu_fn = build_grad_fn(batch)
        row = sweep_row(batch, bench.time_grad(fn, iters),
                        flops_at('f32', batch)['total'],
                        bench.PEAK_FLOP_PER_S['float32'])
        log(f'{batch:>6} {row["ms"]:>8.2f} {row["flops"]:>12.3e} '
            f'{row["gflop_per_s"]:>10.1f} {row["mfu_pct"]:>7.3f} '
            f'{row["ms_per_140_rows"]:>11.3f}')
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

class KernelRecord(NamedTuple):
    """Device time and launches of one kernel name under one operator (None
    where the profiler's events tie the kernel to no operator)."""
    name: str
    device_us: float
    count: int
    op: Optional[str]


def _is_cuda(evt) -> bool:
    return str(evt.device_type).endswith('CUDA')


def trace_records(events: Iterable):
    """Plain records of torch.profiler's events (prof.events()): the
    KernelRecords of every device event with device time (kernels, copies,
    memsets) but bench.pad_profiler's, each under the operator that
    launched it, else None; {that
    operator: the self CPU us of its calls that launched a kernel}; the
    self CPU us of every CPU event; and the counts of events seen. A device
    event shares its correlation id with the CUDA runtime call on the host
    that launched it (cudaLaunchKernel, cudaMemcpyAsync, ...), and that
    call's CPU parent is the launching aten op or autograd.Function."""
    from molgym_tpu_torch.profile_rollout import device_us

    events = list(events)
    pads = {e.id for e in events if _is_cuda(e) and bench.PAD_KERNEL in e.name}
    host = [e for e in events if not _is_cuda(e) and e.id not in pads
            and not getattr(e, 'is_async', False)]
    runtime = {e.id: e for e in host if e.name.startswith('cu')}
    time_, count = collections.Counter(), collections.Counter()
    launching = {}
    device_events = 0
    for e in events:
        if not (_is_cuda(e) and device_us(e) > 0) or e.id in pads:
            continue
        device_events += 1
        call = runtime.get(e.id)
        op = None if call is None else call.cpu_parent
        key = (e.name, None if op is None else op.name)
        time_[key] += device_us(e)
        count[key] += 1
        if op is not None:
            launching[id(op)] = op
    kernels = [KernelRecord(name, time_[(name, op)], count[(name, op)], op)
               for name, op in time_]
    op_cpu_us = collections.Counter()
    for op in launching.values():
        op_cpu_us[op.name] += op.self_cpu_time_total
    counts = dict(cpu_events=len(host), runtime_calls=len(runtime),
                  device_events=device_events)
    return (kernels, dict(op_cpu_us),
            sum(e.self_cpu_time_total for e in host), counts)


def name_prefix(name: str) -> str:
    """A kernel's name without `void `, its template arguments and its
    parameters: the rollup's group where no operator launched it."""
    name = name[5:] if name.startswith('void ') else name
    name = name.replace('(anonymous namespace)::', '')
    for stop in '<(':
        name = name.split(stop)[0]
    return name.strip()


def summarize_trace(kernels: List[KernelRecord], op_cpu_us: Dict[str, float],
                    all_cpu_us: float, iters: int, wall_ms: float) -> dict:
    """The trace's numbers a step from plain records: every kernel name
    (us, % of the device total, launches as count // iters) by device
    time, the rollup by launching operator (a kernel with none under
    'kernel: ' + its name prefix) with its device us, launches and the
    operator's self CPU us, and the device ms, the wall ms, the idle share,
    the launches and the self CPU ms of every CPU event (all_cpu_us) a
    step."""
    total = sum(k.device_us for k in kernels)
    launches = sum(k.count for k in kernels)
    by_name_us, by_name_n = collections.Counter(), collections.Counter()
    group_us, group_n = collections.Counter(), collections.Counter()
    for k in kernels:
        by_name_us[k.name] += k.device_us
        by_name_n[k.name] += k.count
        group = k.op if k.op is not None else 'kernel: ' + name_prefix(k.name)
        group_us[group] += k.device_us
        group_n[group] += k.count
    rows = [dict(name=name[:NAME_CHARS], us_per_step=us / iters,
                 pct=100 * us / total, launches_per_step=by_name_n[name] // iters)
            for name, us in by_name_us.most_common()]
    rollup = [dict(group=group, us_per_step=us / iters, pct=100 * us / total,
                   launches_per_step=group_n[group] / iters,
                   cpu_us_per_step=op_cpu_us.get(group, 0.0) / iters)
              for group, us in group_us.most_common()]
    linked = sum(k.count for k in kernels if k.op is not None)
    device_ms = total / iters / 1e3
    wall_ms_step = wall_ms / iters
    return dict(iters=iters, device_ms_per_step=device_ms,
               wall_ms_per_step=wall_ms_step,
               idle_share=1.0 - device_ms / wall_ms_step,
               launches_per_step=launches / iters,
               linked_share=linked / launches,
               grouped_by=('operator' if linked == launches else
                           'operator, else kernel name prefix' if linked
                           else 'kernel name prefix'),
               launching_ops_cpu_ms_per_step=sum(op_cpu_us.values())
               / iters / 1e3,
               cpu_self_ms_per_step=all_cpu_us / iters / 1e3,
               kernels=rows, rollup=rollup)


def port_kernel_launches(summary: dict) -> Dict[str, float]:
    """Launches a step of each of PORT_KERNELS' counters in a summary's
    kernel list (every row whose name holds the counter's kernel)."""
    return {counter: sum(r['launches_per_step'] for r in summary['kernels']
                         if re.search(rf'\b{symbol}\b', r['name']))
            for counter, symbol in PORT_KERNELS.items()}


def run_trace(batch: int = BATCH, dtype: str = 'f32',
              iters: int = TRACE_ITERS) -> dict:
    from torch.profiler import ProfilerActivity, profile

    gate(dtype)
    fn, _cpu_fn = build_grad_fn(batch, DTYPES[dtype])
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bench.pad_profiler()
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels, op_cpu_us, all_cpu_us, counts = trace_records(prof.events())
    if not kernels:
        raise RuntimeError('torch.profiler saw no device time')
    summary = summarize_trace(kernels, op_cpu_us, all_cpu_us, iters, wall_ms)
    summary.update(batch=batch, dtype=dtype, events=counts)
    for line in trace_lines(summary):
        log(line)
    return summary


def trace_lines(summary: dict) -> List[str]:
    """The JAX script's lines of a trace summary."""
    iters = summary['iters']
    lines = [f'total device op time: {summary["device_ms_per_step"]:.3f} ms '
             f'per step (x{iters} steps traced); wall '
             f'{summary["wall_ms_per_step"]:.3f} ms, idle share '
             f'{summary["idle_share"]:.3f}, '
             f'{summary["launches_per_step"]:g} launches per step',
             f'{"us/step":>9} {"pct":>6} {"calls":>6}  op']
    lines += [f'{r["us_per_step"]:>9.1f} {r["pct"]:>5.1f}% '
              f'{r["launches_per_step"]:>6}  {r["name"]}'
              for r in summary['kernels'][:TOP]]
    lines.append(f'\ncategory rollup (by {summary["grouped_by"]}; the '
                 'operators\' self CPU us a step beside):')
    lines.append(f'{"us/step":>9} {"pct":>6} {"calls":>8} {"cpu us":>9}  '
                 'operator')
    lines += [f'{r["us_per_step"]:>9.1f} {r["pct"]:>5.1f}% '
              f'{r["launches_per_step"]:>8g} {r["cpu_us_per_step"]:>9.1f}  '
              f'{r["group"]}' for r in summary['rollup']]
    return lines


# ---------------------------------------------------------------------------
# one point, and the command
# ---------------------------------------------------------------------------

def run_point(batch: int = BATCH, dtype: str = 'f32',
              iters: int = ITERS) -> dict:
    gate(dtype)
    fn, _cpu_fn = build_grad_fn(batch, DTYPES[dtype])
    ms = bench.time_grad(fn, iters)
    flops = flops_at(dtype, batch)
    peak = bench.PEAK_FLOP_PER_S['float32' if dtype == 'f32' else 'bfloat16']
    mfu = flops['total'] / (ms / 1e3) / peak * 100
    log(f'batch {batch}: {ms:.2f} ms')
    log(f'flops={flops["total"]:.3e}, MFU≈{mfu:.3f}% {flops}')
    return dict(batch=batch, dtype=dtype, ms=ms, flops=flops, mfu_pct=mfu)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='where the SF6 covariant fwd+bwd\'s time goes on one '
                    'CUDA card')
    parser.add_argument('--sweep', action='store_true',
                        help=f'f32 at B = {", ".join(map(str, SWEEP))}')
    parser.add_argument('--trace', action='store_true',
                        help=f'{TRACE_ITERS} calls under torch.profiler')
    parser.add_argument('--batch', type=int, default=BATCH)
    parser.add_argument('--dtype', choices=list(DTYPES), default='f32',
                        help='encoder compute dtype')
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        print('profile_minibatch: no CUDA device is visible; it profiles the '
              'card only', file=sys.stderr, flush=True)
        return 2
    from molgym_tpu_torch import cuda_build
    cuda_build.build()   # every kernel's nvcc at once, before the first call
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.card_line()
    head = dict(card=card, count=torch.cuda.device_count())
    log(f'card: {card}, count {head["count"]}')

    def emit(mode, **values):
        log(json.dumps(dict(head, mode=mode, gate=_GATES, **values)))

    if args.sweep:
        emit('sweep', dtype='f32', rows=run_sweep())
    if args.trace:
        emit('trace', **run_trace(args.batch, args.dtype))
    if not (args.sweep or args.trace):
        emit('point', **run_point(args.batch, args.dtype))
    return 0


if __name__ == '__main__':
    sys.exit(main())
