"""The benchmark's own count of the covariant agent's work: operations and
bytes of each call of the program's kernels, and the FLOPs of a forward
and of a fwd+bwd, from the shapes and the dense CG tables' nonzeros
(reference/so3.py), so that a reading does not move when a kernel changes
how it does the work.

Kernel operations follow the contraction each kernel computes:
  aggregate  out[b,i,t,k] = sum_{m,n} C[m,n,k] sum_j rad[b,i,j,t,l(m)]
                                    Y[b,i,j,m] q[b,j,t,n]
             forward: the edge rep (2 an element), the complex
             multiply-adds over neighbours (8 each), 4 a nonzero and row;
             backward: 4 a nonzero and row for dz, the edge rep again,
             d e and d q (8 each), Re(d e conj Y) (4 an element)
  square     out[..., k] = sum_{m<=n} (C[m,n,k] + C[n,m,k]) a_m a_n
             forward: 6 for each pair some column reads, 4 a nonzero;
             backward: 4 a nonzero, 16 for each live pair
  product    out[..., k] = sum_{m,n} C[m,n,k] a_m b_n
             forward: 10 a nonzero; backward: 4 a nonzero, 16 a live pair
  head       the masked softmax with its index, log-prob and entropy:
             20 an entry when it samples, 10 otherwise; backward 10
Bytes: each operand and output once, and each table nonzero once (its
index and coefficient, 8 bytes), with no padding.

FLOPs of the model: the CG kernels' operations, every linear layer, the
selections of the focused atom and the critic's sum (products with a
one-hot or a mask), and the channel mixes at their nonzero work (a complex multiply-add, 8, for each
(pair, tau, tau_out, m) of an l). `as_run` counts the mixes as the program
computes them, one dense product against a block-structured weight, which
is what molgym_tpu_torch.bench.count_flops counts; the difference is
multiplications by the block weight's zeros.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from reference import so3

F32 = 4
PEAK_FLOP_PER_S = 67e12      # H100 SXM, f32 outside the tensor cores, 700 W
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3

# the program's kernels by the name of their CUDA function
KERNELS = ('cg_aggregate_edge_kernel', 'cg_aggregate_bwd_kernel',
           'cg_square_kernel', 'cg_square_bwd_kernel', 'cg_product_kernel',
           'cg_product_bwd_kernel', 'head_fwd_kernel', 'head_bwd_kernel')

Call = Tuple[str, float, float]      # (kernel, operations, bytes)


@lru_cache(maxsize=None)
def product_stats(n1: int, n2: int, maxl: int) -> dict:
    table, _sl = so3.product_table(n1, n2, maxl)
    live = (table != 0).any(-1)
    return dict(k=table.shape[2], m1=table.shape[0], m2=table.shape[1],
                nnz=int(np.count_nonzero(table)), live=int(live.sum()))


@lru_cache(maxsize=None)
def square_stats(n_ells: int, maxl: int) -> dict:
    """The square's table folded over m <= n: its nonzeros and the pairs
    that carry any."""
    table, _sl = so3.product_table(n_ells, n_ells, maxl)
    m = table.shape[0]
    iu, ju = np.triu_indices(m)
    folded = table[iu, ju] + np.where((iu != ju)[:, None], table[ju, iu], 0)
    used = (folded != 0).any(-1)
    return dict(k=table.shape[2], m=m, nnz=int(np.count_nonzero(folded)),
                live=int(used.sum()))


def encoder_shapes(s: dict):
    """(tau_in, tau_out, atom_ells) of each level."""
    out_tau = len(s['zs']) * s['cpe']
    taus = [s['hidden']] * (s['levels'] - 1) + [out_tau]
    tau_in, ells = s['hidden'], 1
    for tau_out in taus:
        yield tau_in, tau_out, ells
        tau_in, ells = tau_out, s['maxl'] + 1


def kernel_calls(s: dict, rows: int, backward: bool, head_mode: str = 'sample'
                 ) -> List[Call]:
    """Each kernel call of one forward of the policy over `rows`
    observations (and of its backward), with its operations and bytes.
    head_mode: 'sample', 'greedy' or 'given' (the actions evaluated)."""
    n, maxl = s['canvas'], s['maxl']
    n_ells = maxl + 1
    m = n_ells ** 2
    calls: List[Call] = []
    for tau_in, tau_out, ells in encoder_shapes(s):
        st = product_stats(n_ells, ells, maxl)
        edges = rows * n * n * tau_in * m
        sparse = rows * n * tau_in * st['nnz'] * 4
        ins = (rows * n * n * m * 2 + rows * n * n * tau_in * n_ells
               + 2 * rows * n * tau_in * ells ** 2) * F32
        out = 2 * rows * n * tau_in * st['k'] * F32
        table = 8 * st['nnz']
        calls.append(('cg_aggregate_edge_kernel',
                      edges * 2 + edges * ells ** 2 * 8 + sparse,
                      ins + out + table))
        sq = square_stats(n_ells, maxl)
        sq_rows = rows * n * tau_out
        sq_in, sq_out = 2 * sq_rows * m * F32, 2 * sq_rows * sq['k'] * F32
        sq_table = 8 * sq['nnz'] + 4 * sq['live']
        calls.append(('cg_square_kernel',
                      sq_rows * (sq['live'] * 6 + sq['nnz'] * 4),
                      sq_in + sq_out + sq_table))
        if backward:
            calls.append(('cg_aggregate_bwd_kernel',
                          sparse + edges * 2 + edges * ells ** 2 * 16 + edges * 4,
                          ins + out + (rows * n * n * tau_in * n_ells
                                       + 2 * rows * n * tau_in * ells ** 2) * F32
                          + table))
            calls.append(('cg_square_bwd_kernel',
                          sq_rows * (sq['nnz'] * 4 + sq['live'] * 16),
                          2 * sq_in + sq_out + sq_table))
    heads = [(rows, n), (rows, len(s['zs']))]          # focus, element
    per_entry = 20 if head_mode == 'sample' else 10
    for r, width in heads:
        extra = {'sample': r * width * F32, 'given': r * 8, 'greedy': 0}[head_mode]
        calls.append(('head_fwd_kernel', r * width * per_entry,
                      r * width * (F32 + 1) + extra + r * width * F32 + 16 * r))
        if backward:
            calls.append(('head_bwd_kernel', r * width * 10,
                          r * width * F32 * 2 + r * (8 + 2 * F32)))
    cpe = s['cpe']
    p_rows = rows * cpe
    for n1, n2 in ((1, n_ells), (n_ells, n_ells)):     # the distance mixer
        st = product_stats(n1, n2, maxl)
        ins = 2 * p_rows * (st['m1'] + st['m2']) * F32
        out = 2 * p_rows * st['k'] * F32
        calls.append(('cg_product_kernel', p_rows * st['nnz'] * 10,
                      ins + out + 8 * st['nnz']))
        if backward:
            calls.append(('cg_product_bwd_kernel',
                          p_rows * (st['nnz'] * 4 + st['live'] * 16),
                          2 * ins + out + 8 * st['nnz']))
    return calls


def least_seconds(calls: List[Call]) -> float:
    """The least time the card could take for the calls: each call bounded
    by its operations at the f32 peak or its bytes at the memory's."""
    return sum(max(ops / PEAK_FLOP_PER_S, b / PEAK_BYTES_PER_S)
               for _k, ops, b in calls)


def _mix_sources(s: dict, tau_in: int, tau_out: int, ells: int, first_n1: int):
    """(tau, slices, K) of the sources of the two mixes of a level, or of
    the distance mixer: the product's mix (its table of l < first_n1 with
    l < ells), then the mix of that, its square and the input rep."""
    maxl = s['maxl']
    n_ells = maxl + 1
    _t, ag_sl = so3.product_table(first_n1, ells, maxl)
    _t, sq_sl = so3.product_table(n_ells, n_ells, maxl)

    def width(slices):
        return sum(p * (2 * l + 1) for l, (_o, p) in enumerate(slices))
    first = [(tau_in, ag_sl, width(ag_sl))]
    second = [(tau_out, so3.m_slices(n_ells, maxl), n_ells ** 2),
              (tau_out, sq_sl, width(sq_sl)),
              (tau_in, so3.m_slices(ells, maxl), ells ** 2)]
    return first, second


def _mix_flops(rows: int, sources, tau_out: int, m: int) -> Tuple[int, int]:
    """(model, as run) forward FLOPs of one channel mix over `rows`."""
    model = as_run = 0
    for tau, slices, k in sources:
        for l, (_o, pairs) in enumerate(slices):
            model += rows * pairs * tau * tau_out * (2 * l + 1) * 8
        as_run += 2 * 2 * rows * tau * k * 2 * m * tau_out
    return model, as_run


def _linear(rows: int, d_in: int, d_out: int) -> int:
    return 2 * rows * d_in * d_out


def flops(s: dict, rows: int, backward: bool) -> Dict[str, float]:
    """FLOPs of one forward (and backward) of the policy over `rows`:
    `model` and `as_run` (see the module docstring), and their parts."""
    n, maxl, cpe, width = s['canvas'], s['maxl'], s['cpe'], 128
    n_ells = maxl + 1
    m = n_ells ** 2
    num_zs = len(s['zs'])
    cg = sum(ops for k, ops, _b in kernel_calls(s, rows, backward)
             if not k.startswith('head'))
    # linear layers: (rows, d_in, d_out, does the input carry a gradient)
    lin = [(rows * n, num_zs * 4, s['hidden'], False)]
    mix_model = mix_run = 0
    for tau_in, tau_out, ells in encoder_shapes(s):
        lin += [(rows * n * n, 16, tau_in, False)] * n_ells
        first, second = _mix_sources(s, tau_in, tau_out, ells, n_ells)
        for src, t_out in ((first, tau_out), (second, tau_out)):
            a, b = _mix_flops(rows * n, src, t_out, m)
            mix_model, mix_run = mix_model + a, mix_run + b
    first, second = _mix_sources(s, cpe, cpe, n_ells, 1)
    for src in (first, second):
        a, b = _mix_flops(rows, src, cpe, m)
        mix_model, mix_run = mix_model + a, mix_run + b
    inv = (maxl + 2) * num_zs * cpe * 2
    elem_inv = (maxl + 2) * cpe * 2
    lin += [(rows * n, inv, width, True), (rows * n, width, 1, True),        # focus
            (rows, inv, width, True), (rows, width, num_zs, True),          # element
            (rows, elem_inv, width, True),
            (rows, width, 2 * s['gaussians'], True),                        # distance
            (rows * n, inv, width, True), (rows * n, width, width, True),   # critic
            (rows, width, width, True), (rows, width, 1, True)]
    # the selections of the focused atom and the critic's sum over atoms
    pick = [2 * rows * n * (num_zs * cpe * m * 2), 2 * rows * n * inv,
            2 * rows * n * width]
    linear = sum(_linear(r, a, b) for r, a, b, _g in lin)
    other = sum(pick)
    position = 2 * rows * n * 3
    if backward:
        linear += sum(_linear(r, a, b) * (2 if g else 1) for r, a, b, g in lin)
        mix_model *= 3
        # the first level's input rep is real: no gradient reaches its
        # imaginary part, so that one product has no input-gradient product
        tau_out0 = next(encoder_shapes(s))[1]
        mix_run = mix_run * 3 - 2 * rows * n * s['hidden'] * 2 * m * tau_out0
        other *= 2
    return dict(model=cg + linear + mix_model + other,
                as_run=cg + linear + mix_run + other + position,
                cg=cg, linear=linear, mix_model=mix_model, mix_as_run=mix_run,
                selections=other)
