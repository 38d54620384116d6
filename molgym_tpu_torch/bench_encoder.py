"""Times the port's CG kernels on one CUDA card: the fused CG aggregate's
forward and backward and the tri-fold CG square's forward and backward, at
the shapes of both configurations (SF6: maxl 4, N = 7; stochastic bags:
maxl 3, N = 10), and the policy mixer's packed CG product, forward and
backward.

    PYTHONPATH=<tree> python3 molgym_tpu_torch/bench_encoder.py [--label x]
        [--readings 3] [--kernels aggregate,square,product]

The aggregate is timed at level 0 (M2 = 1, dense table) and the upper
levels, forward and backward at the update's batch (140), the rollout's (10)
and an evaluation's (1). The square is timed at the channel counts of every
level (SF6: tau 10 and 12; stochastic: tau 10 and 16), its forward at
B = 140, 10 and 1 and its backward at B = 140, the only batch a path sends
it. The product is timed at the mixer's two tables of each configuration
(SF6: (M1, M2) = (1, 25) and (25, 25); stochastic: (1, 16) and (16, 16)),
its forward at 4 channels of B = 140, 10 and 1 (560, 40 and 4 rows) and
its backward at 560 rows.

It imports `molgym_tpu_torch` from PYTHONPATH, so two trees (two commits
unpacked side by side) can be timed in turns, one after the other, on one
card: the script uses only what both have, the public forward wrappers and
their plain versions, `fused_agg._aggregate_bwd_kernel`,
`fused_agg._square_bwd_kernel` and `fused_cg._bwd_kernel`, and takes the
timer from the file beside itself, so both trees are timed by the same
code. Each kernel is first held against its plain version (1e-4 relative)
and each backward against a second run of itself (the same bits).
`fwd_ms` / `bwd_ms` are device ms per call by CUDA-graph replay
(timing.time_ms); `fwd_host_us` / `bwd_host_us` are the host's microseconds
to issue one call of the wrapper (table lookup, the plan, allocation of the
outputs and the launch), which replay leaves out: HOST_CALLS calls in a row
with an empty queue, the clock read before the card is waited for.
`--readings` of each. One JSON object per line on stdout.
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
KERNEL_TOL = 1e-4

AGGREGATE_SHAPES = [  # name, maxl, atom_n_ells, N
    ('sf6_level0', 4, 1, 7), ('sf6_levels12', 4, 5, 7),
    ('stoch_level0', 3, 1, 10), ('stoch_level1', 3, 4, 10)]
AGGREGATE_TAU = 10
SQUARE_SHAPES = [  # name, maxl, N, tau
    ('sf6_tau10', 4, 7, 10), ('sf6_tau12', 4, 7, 12),
    ('stoch_tau10', 3, 10, 10), ('stoch_tau16', 3, 10, 16)]
PRODUCT_SHAPES = [  # name, n_ells1, n_ells2, maxl
    ('sf6_1x25', 1, 5, 4), ('sf6_25x25', 5, 5, 4),
    ('stoch_1x16', 1, 4, 3), ('stoch_16x16', 4, 4, 3)]
PRODUCT_TAU = 4
KERNELS = ('aggregate', 'square', 'product')


def _aggregate_inputs(dev, B, maxl, atom_n_ells, N):
    from molgym_tpu_torch.ops import cg, fused_agg
    n_ells = maxl + 1
    m1, m2 = n_ells ** 2, atom_n_ells ** 2
    tau = AGGREGATE_TAU
    gen = torch.Generator(device=dev).manual_seed(B + 10 * atom_n_ells + N)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    ops = (randn(B, N, N, m1, 2), randn(B, N, N, tau, n_ells),
           randn(B, N, tau, m2), randn(B, N, tau, m2))
    table3, _sl = cg._fused_cg_table(n_ells, atom_n_ells, maxl)
    g = cg.fused_cg_table_grouped(n_ells, atom_n_ells, maxl)
    grouped = None if g is None else (g[0], g[1])
    k = fused_agg._kernel_tables('aggregate', table3, grouped, None,
                                 dev)['k']
    grads = (randn(B, N, tau, k), randn(B, N, tau, k))
    return ops, grads, table3, grouped


def _square_inputs(dev, B, maxl, N, tau):
    from molgym_tpu_torch.ops import cg
    n_ells = maxl + 1
    gen = torch.Generator(device=dev).manual_seed(B + N + tau)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    table3, _sl = cg._fused_cg_table(n_ells, n_ells, maxl)
    pairs, groups, _perm, _si = cg.fused_cg_table_tri(n_ells, maxl)
    k = sum(t.shape[1] for _a, _b, t in groups)
    return ((randn(B, N, tau, n_ells ** 2), randn(B, N, tau, n_ells ** 2)),
            (randn(B, N, tau, k), randn(B, N, tau, k)), table3,
            (pairs, groups))


def _product_inputs(dev, B, n1, n2, maxl):
    from molgym_tpu_torch.ops import cg
    gen = torch.Generator(device=dev).manual_seed(B + 10 * n1 + n2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    table3, _sl = cg._fused_cg_table(n1, n2, maxl)
    lead = (B, PRODUCT_TAU)
    ops = (randn(*lead, n1 * n1), randn(*lead, n1 * n1),
           randn(*lead, n2 * n2), randn(*lead, n2 * n2))
    k = table3.shape[2]
    return ops, (randn(*lead, k), randn(*lead, k)), table3


def _rel_err(outs, refs):
    err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    return err / max(float(r.abs().max()) for r in refs)


def _own_timer():
    spec = importlib.util.spec_from_file_location(
        'bench_encoder_timing', Path(__file__).with_name('timing.py'))
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


def _measure(row, prefix, fn, plain, readings, time_ms, twice=False):
    """Hold `fn` against `plain` (and, for a backward, against a second run
    of itself), then add its device ms and host us to `row`; False if it
    disagrees."""
    got = fn()
    again = fn() if twice else got
    torch.cuda.synchronize()
    row[f'{prefix}_rel_err'] = _rel_err(got, plain())
    ok = row[f'{prefix}_rel_err'] <= KERNEL_TOL
    if twice:
        row[f'{prefix}_same_bits'] = all(torch.equal(a, b)
                                         for a, b in zip(got, again))
        ok = ok and row[f'{prefix}_same_bits']
    row[f'{prefix}_ms'] = [time_ms(fn) for _ in range(readings)]
    row[f'{prefix}_host_us'] = [_host_us(fn) for _ in range(readings)]
    return ok


def main(argv=None) -> int:
    from molgym_tpu_torch.ops import fused_agg, fused_cg
    time_ms = _own_timer()

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--label', default='tree')
    parser.add_argument('--readings', type=int, default=3)
    parser.add_argument('--kernels', default=','.join(KERNELS),
                        help=f'comma-separated: {", ".join(KERNELS)}')
    args = parser.parse_args(argv)
    kernels = set(args.kernels.split(','))
    if not kernels <= set(KERNELS):
        parser.error(f'--kernels: unknown {sorted(kernels)}')
    if not torch.cuda.is_available():
        print('bench_encoder: no CUDA device is visible', file=sys.stderr)
        return 2
    dev = torch.device('cuda')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(label=args.label, card=card)), flush=True)

    cases = []
    if 'aggregate' in kernels:
        for name, maxl, n, N in AGGREGATE_SHAPES:
            for B in (140, 10, 1):
                ops, grads, table3, grouped = _aggregate_inputs(dev, B, maxl,
                                                                n, N)
                bwd_args = (*ops, *grads, table3, grouped)
                cases.append((
                    'aggregate', name, B,
                    lambda ops=ops, t=table3, g=grouped:
                        fused_agg.cg_aggregate_edge_fused_ri(*ops, t,
                                                             grouped=g),
                    lambda ops=ops, t=table3, g=grouped:
                        fused_agg.cg_aggregate_edge_fused_ri_plain(
                            *ops, t, grouped=g),
                    lambda a=bwd_args: fused_agg._aggregate_bwd_kernel(*a),
                    lambda a=bwd_args:
                        fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(*a)))
    if 'square' in kernels:
        for name, maxl, N, tau in SQUARE_SHAPES:
            for B in (140, 10, 1):
                a, grads, table3, tri = _square_inputs(dev, B, maxl, N, tau)
                bwd_args = (*a, *grads, table3, None, tri)
                cases.append((
                    'square', name, B,
                    lambda a=a, t=table3, tri=tri:
                        fused_agg.cg_square_fused_ri(*a, t, tri=tri),
                    lambda a=a, t=table3, tri=tri:
                        fused_agg.cg_square_fused_ri_plain(*a, t, tri=tri),
                    # the backward runs at the update's batch only
                    (lambda a=bwd_args: fused_agg._square_bwd_kernel(*a))
                    if B == 140 else None,
                    lambda a=bwd_args:
                        fused_agg.cg_square_fused_ri_bwd_plain(*a)))
    if 'product' in kernels:
        for name, n1, n2, maxl in PRODUCT_SHAPES:
            for B in (140, 10, 1):
                ops, grads, table3 = _product_inputs(dev, B, n1, n2, maxl)
                bwd_args = (*ops, *grads, table3)
                cases.append((
                    'product', name, B,
                    lambda ops=ops, t=table3: fused_cg.cg_contract_ri(*ops, t),
                    lambda ops=ops, t=table3:
                        fused_cg.cg_contract_ri_plain(*ops, t),
                    # the backward runs at the update's batch only
                    (lambda a=bwd_args: fused_cg._bwd_kernel(*a))
                    if B == 140 else None,
                    lambda a=bwd_args: fused_cg.cg_contract_ri_bwd_plain(*a)))

    for kernel, name, B, fwd, fwd_plain, bwd, bwd_plain in cases:
        row = dict(label=args.label, kernel=kernel, shape=name, B=B)
        ok = _measure(row, 'fwd', fwd, fwd_plain, args.readings, time_ms)
        if bwd is not None:
            ok = _measure(row, 'bwd', bwd, bwd_plain, args.readings, time_ms,
                          twice=True) and ok
        print(json.dumps(row), flush=True)
        if not ok:
            print(f'bench_encoder: {kernel} {name} B={B} disagrees with the '
                  'plain version or with itself', file=sys.stderr)
            return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
