"""The benchmark of molgym_tpu_torch, the PyTorch and CUDA port: one cell of
BENCHMARK.json on the card, timed, judged against the plain reference, and
reported as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Set-up builds the port's objects for the
cell's configuration and traffic, makes the weights on the card from the
seed, and runs the traffic's first work, which warms every shape (and, in
a checkout where they are not built yet, builds the kernels into
molgym_tpu_torch/_build). The window then runs the traffic's work back to
back for --seconds. With --trace 1 one more piece of the work runs under
torch.profiler after the window, and the line carries the cell's per-layer
metrics instead of its end-to-end ones. Once the window has closed and the
peak memory is read, the reference judges what the timed path produced.

The last line of standard output is the result; the numbers compared,
each beside its limit, are the last lines of standard error. Without a
card, or with fewer cards than the cell asks for, it exits with code 3 and
prints no result; a process that has loaded JAX or the JAX package exits
with code 4; a checkout without the port (molgym_tpu_torch beside
benchmark/) with code 5 or an ImportError.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

import torch  # noqa: E402

from harness import cell as cells  # noqa: E402
from harness import loops, trace  # noqa: E402
from harness.program import Program  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'molgym_tpu')
GIB = 2 ** 30


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package in this process, compared by
    their whole top-level name."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, device: torch.device, plant=None,
             bench_dir: Path = BENCH_DIR, started: float = STARTED):
    """One run of a cell: (its result as a dict, the JSON line's keys;
    notes for standard error: the steps judged and the phases' seconds). `plant(program, loop)`, where
    given, breaks the program after it is built (harness/faults.py)."""
    c = cells.load(root, workload, bench_dir)
    phases = [('imports', time.perf_counter())]
    prog = Program(c.config, c.traffic, device)
    phases.append(('program', time.perf_counter()))
    loop = loops.LOOPS[c.traffic['loop']](prog, c.config, c.traffic, seed, device)
    if plant is not None:
        plant(prog, loop)
    phases.append(('weights_and_states', time.perf_counter()))
    loop.setup()
    phases.append(('first_work', time.perf_counter()))
    setup_s = time.perf_counter() - started
    cuda = device.type == 'cuda'
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_window = time.perf_counter()
    stats = loop.window(seconds)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx = dict(window=stats, loop=loop, trace=None, traced_steps=0,
               traced_calls=[])
    if traced:
        tr, (steps, calls) = trace.profile(loop.traced_work, loop.sync)
        ctx.update(trace=tr, traced_steps=steps, traced_calls=calls)
    loop.release()
    del prog
    t_judge = time.perf_counter()
    verdict = loop.judge(c.limits)
    marks = [started] + [t for _n, t in phases]
    timing = dict(setup_s=setup_s,
                  setup_phases_s={n: b - a for (n, _t), a, b in
                                  zip(phases, marks, marks[1:])},
                  window_s=stats['seconds'],
                  trace_s=t_judge - t_window - stats['seconds'],
                  judge_s=time.perf_counter() - t_judge)
    if 'grad_passes' in stats:
        timing.update(iterations=len(stats['grad_passes']),
                      grad_passes=stats['grad_passes'],
                      rollout_s=[round(x, 4) for x in stats['rollout_s']],
                      update_s=[round(x, 4) for x in stats['update_s']])

    e2e = {c.traffic['rate_metric']: stats['steps'] / stats['seconds'],
           'peak_mem_gib': window_peak / GIB, 'setup_s': setup_s}
    if traced:
        metrics = {}
        for m in c.per_layer:
            value = cells.reader(m['name'], bench_dir)(ctx)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        metrics = {m['name']: {'value': e2e[m['name']], 'unit': m['unit']}
                   for m in c.end_to_end}
    out = dict(correct=verdict.correct, attempted=stats['steps'],
               failed=verdict.wrong, metrics=metrics,
               device=dict(platform='gpu' if cuda else device.type,
                           kind=(torch.cuda.get_device_name(device) if cuda
                                 else 'cpu'),
                           count=1,
                           memory_peak_bytes=max(setup_peak, window_peak)
                           if cuda else 0))
    if traced:
        tr = ctx['trace']
        out['device'].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out['breakdown'] = dict(device_ops=tr.device_ops(),
                                idle_gaps=tr.idle_gaps())
    out['compared'] = {k: {'value': v, 'limit': verdict.limits[k]}
                       for k, v in verdict.numbers.items()}
    notes = dict(judged_steps=verdict.judged, seen=verdict.seen, timing=timing)
    return out, notes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    root = Path.cwd()
    chips = {w['name']: w['chips'] for w in json.loads(
        (root / 'BENCHMARK.json').read_text())['workloads']}[args.workload]
    import molgym_tpu_torch
    if Path(molgym_tpu_torch.__file__).resolve().parents[1] != root.resolve():
        print(f'run.py: the program is not in this checkout ({root}): it '
              f'would import {molgym_tpu_torch.__file__}', file=sys.stderr)
        return 5
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'run.py: the cell needs {chips} CUDA card(s); this process sees '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 3
    out, notes = run_cell(root, args.workload, args.seed, args.seconds,
                          bool(args.trace), torch.device('cuda'))
    found = loaded_forbidden()
    if found:
        print(f'run.py: this process loaded {found}: the benchmark measures '
              'the PyTorch port alone', file=sys.stderr)
        return 4
    print('notes ' + json.dumps(notes), file=sys.stderr)
    for k, v in out['compared'].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    os.environ.setdefault('USE_FLAX', '0')
    raise SystemExit(main())
