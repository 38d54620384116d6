"""Times the fused CG aggregate's forward and backward kernels on one CUDA
card, at the shapes of both configurations (SF6: maxl 4, N = 7; stochastic
bags: maxl 3, N = 10), level 0 (M2 = 1, dense table) and the upper levels,
at the update's batch (140), the rollout's (10) and an evaluation's (1).

    PYTHONPATH=<tree> python3 molgym_tpu_torch/bench_aggregate.py [--label x]
        [--readings 3]

It imports `molgym_tpu_torch` from PYTHONPATH, so two trees (two commits
unpacked side by side) can be timed in turns, one after the other, on one card:
the script uses only what both have, the public forward wrapper and
`fused_agg._aggregate_bwd_kernel`, and takes the timer from the file beside
itself, so both trees are timed by the same code. Each kernel is first held
against its plain version (1e-4 relative). `fwd_ms` / `bwd_ms` are device ms
per call by CUDA-graph replay (timing.time_ms); `fwd_host_us` / `bwd_host_us`
are the host's microseconds to issue one call of the wrapper (table lookup,
the choice of tiles, allocation of the outputs and the launch), which replay
leaves out: HOST_CALLS calls in a row with an empty queue, the clock read
before the card is waited for. `--readings` of each. One JSON object per line
on stdout.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HOST_CALLS = 200

SHAPES = [  # name, maxl, atom_n_ells, N
    ('sf6_level0', 4, 1, 7), ('sf6_levels12', 4, 5, 7),
    ('stoch_level0', 3, 1, 10), ('stoch_level1', 3, 4, 10)]
TAU = 10
KERNEL_TOL = 1e-4


def _inputs(dev, B, maxl, atom_n_ells, N, with_grads):
    from molgym_tpu_torch.ops import cg, fused_agg
    n_ells = maxl + 1
    m1, m2 = n_ells ** 2, atom_n_ells ** 2
    gen = torch.Generator(device=dev).manual_seed(B + 10 * atom_n_ells + N)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    ops = (randn(B, N, N, m1, 2), randn(B, N, N, TAU, n_ells),
           randn(B, N, TAU, m2), randn(B, N, TAU, m2))
    table3, _sl = cg._fused_cg_table(n_ells, atom_n_ells, maxl)
    g = cg.fused_cg_table_grouped(n_ells, atom_n_ells, maxl)
    grouped = None if g is None else (g[0], g[1])
    grads = ()
    if with_grads:
        k = fused_agg._kernel_tables('aggregate', table3, grouped, None,
                                     dev)['k']
        grads = (randn(B, N, TAU, k), randn(B, N, TAU, k))
    return ops, grads, table3, grouped


def _rel_err(outs, refs):
    err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    return err / max(float(r.abs().max()) for r in refs)


def _own_timer():
    spec = importlib.util.spec_from_file_location(
        'bench_aggregate_timing', Path(__file__).with_name('timing.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.time_ms


def _host_us(fn):
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / HOST_CALLS * 1e6


def main(argv=None) -> int:
    from molgym_tpu_torch.ops import fused_agg
    time_ms = _own_timer()

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--label', default='tree')
    parser.add_argument('--readings', type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('bench_aggregate: no CUDA device is visible', file=sys.stderr)
        return 2
    dev = torch.device('cuda')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(label=args.label, card=card)), flush=True)

    for name, maxl, n, N in SHAPES:
        for B in (140, 10, 1):
            ops, grads, table3, grouped = _inputs(dev, B, maxl, n, N, True)
            out = fused_agg.cg_aggregate_edge_fused_ri(*ops, table3,
                                                       grouped=grouped)
            torch.cuda.synchronize()
            ref = fused_agg.cg_aggregate_edge_fused_ri_plain(
                *ops, table3, grouped=grouped)
            row = dict(label=args.label, shape=name, B=B,
                       fwd_rel_err=_rel_err(out, ref))
            row['fwd_ms'] = [time_ms(
                lambda: fused_agg.cg_aggregate_edge_fused_ri(
                    *ops, table3, grouped=grouped))
                for _ in range(args.readings)]
            row['fwd_host_us'] = [_host_us(
                lambda: fused_agg.cg_aggregate_edge_fused_ri(
                    *ops, table3, grouped=grouped))
                for _ in range(args.readings)]
            bwd_args = (*ops, *grads, table3, grouped)
            got = fused_agg._aggregate_bwd_kernel(*bwd_args)
            again = fused_agg._aggregate_bwd_kernel(*bwd_args)
            torch.cuda.synchronize()
            ref = fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(*bwd_args)
            row['bwd_rel_err'] = _rel_err(got, ref)
            row['bwd_same_bits'] = all(torch.equal(a, b)
                                       for a, b in zip(got, again))
            row['bwd_ms'] = [time_ms(
                lambda: fused_agg._aggregate_bwd_kernel(*bwd_args))
                for _ in range(args.readings)]
            row['bwd_host_us'] = [_host_us(
                lambda: fused_agg._aggregate_bwd_kernel(*bwd_args))
                for _ in range(args.readings)]
            print(json.dumps(row), flush=True)
            if not (row['fwd_rel_err'] <= KERNEL_TOL
                    and row['bwd_rel_err'] <= KERNEL_TOL
                    and row['bwd_same_bits']):
                print(f'bench_aggregate: {name} B={B} disagrees with the '
                      'plain version', file=sys.stderr)
                return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
