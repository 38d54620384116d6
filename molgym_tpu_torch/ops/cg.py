"""Clebsch-Gordan algebra: coefficient tables and plain tensor products
(counterpart of molgym_tpu/ops/cg.py).

Coefficients are computed exactly on the host (float64, Racah formula) and
packed into one combined block table per product. The table builders are the
port's own copies of the JAX package's numpy builders and give bit-equal
tables. There is no backend switch: the fused edge aggregate and the CG
square live in ops/fused_agg.py, the channel-wise product in
ops/fused_cg.py, and the device of the tensors decides between a kernel and
the plain version.

Packed reps keep all l blocks concatenated along one m axis
([..., tau, M], M = sum_l (2l+1)); complex parts travel as separate tensors
(`_ri` forms) or as a trailing (real, imag) axis of size 2.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from molgym_tpu_torch.ops.fused_cg import cg_contract_ri


@lru_cache(maxsize=None)
def _cg_coefficient(l1: int, m1: int, l2: int, m2: int, l: int, m: int) -> float:
    """<l1 m1 l2 m2 | l m> via the Racah closed form (exact, float64)."""
    if m1 + m2 != m or l < abs(l1 - l2) or l > l1 + l2:
        return 0.0
    if abs(m1) > l1 or abs(m2) > l2 or abs(m) > l:
        return 0.0
    f = math.factorial
    prefactor = math.sqrt(
        (2 * l + 1) * f(l + l1 - l2) * f(l - l1 + l2) * f(l1 + l2 - l) /
        f(l1 + l2 + l + 1))
    prefactor *= math.sqrt(
        f(l + m) * f(l - m) * f(l1 - m1) * f(l1 + m1) * f(l2 - m2) * f(l2 + m2))
    total = 0.0
    k_min = max(0, l2 - l - m1, l1 + m2 - l)
    k_max = min(l1 + l2 - l, l1 - m1, l2 + m2)
    for k in range(k_min, k_max + 1):
        denom = (f(k) * f(l1 + l2 - l - k) * f(l1 - m1 - k) * f(l2 + m2 - k) *
                 f(l - l2 + m1 + k) * f(l - l1 - m2 + k))
        total += ((-1.0) ** k) / denom
    return prefactor * total


@lru_cache(maxsize=None)
def cg_table(l1: int, l2: int, l: int) -> np.ndarray:
    """Dense table [2l1+1, 2l2+1, 2l+1] with m indices ascending from -l."""
    table = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l + 1), dtype=np.float64)
    for i1, m1 in enumerate(range(-l1, l1 + 1)):
        for i2, m2 in enumerate(range(-l2, l2 + 1)):
            m = m1 + m2
            if -l <= m <= l:
                table[i1, i2, m + l] = _cg_coefficient(l1, m1, l2, m2, l, m)
    return table


def _blocks(n_ells1: int, n_ells2: int, maxl: int):
    """(l, l1, l2) output blocks in K order: grouped by output l, (l1, l2)
    pairs in loop order."""
    out = []
    for l in range(maxl + 1):
        for l1 in range(n_ells1):
            for l2 in range(n_ells2):
                if abs(l1 - l2) <= l <= l1 + l2:
                    out.append((l, l1, l2))
    return out


@lru_cache(maxsize=None)
def _fused_cg_table(n_ells1: int, n_ells2: int, maxl: int):
    """Combined table [M1, M2, K] + per-l (offset, n_pairs) slices. K slots
    are grouped by output l; within an l, (l1, l2) pairs in loop order, each
    occupying 2l+1 consecutive slots."""
    m1_tot = sum(2 * l + 1 for l in range(n_ells1))
    m2_tot = sum(2 * l + 1 for l in range(n_ells2))
    off1 = np.cumsum([0] + [2 * l + 1 for l in range(n_ells1)])
    off2 = np.cumsum([0] + [2 * l + 1 for l in range(n_ells2)])
    blocks = _blocks(n_ells1, n_ells2, maxl)
    k_tot = sum(2 * l + 1 for (l, _l1, _l2) in blocks)

    table = np.zeros((m1_tot, m2_tot, k_tot), dtype=np.float32)
    slices = [[0, 0] for _ in range(maxl + 1)]
    k = 0
    for l in range(maxl + 1):
        slices[l][0] = k
        for (lo, l1, l2) in blocks:
            if lo != l:
                continue
            sub = cg_table(l1, l2, l).astype(np.float32)
            table[off1[l1]:off1[l1 + 1], off2[l2]:off2[l2 + 1],
                  k:k + 2 * l + 1] = sub
            slices[l][1] += 1
            k += 2 * l + 1
    return table, tuple((s[0], s[1]) for s in slices)


def _slices_idx(slices, inv, maxl):
    out = []
    for l in range(maxl + 1):
        off, pairs = slices[l]
        width = 2 * l + 1
        idx = tuple(int(inv[off + p * width + m])
                    for p in range(pairs) for m in range(width))
        out.append((idx, pairs))
    return tuple(out)


@lru_cache(maxsize=None)
def fused_cg_table_grouped(n_ells1: int, n_ells2: int, maxl: int):
    """l1-grouped compaction of the fused table (same contract as the JAX
    builder): None where grouping saves no 128-wide tile passes, else
    (tables per l1 [w1*M2, K_g], perm [K] grouped position -> original
    column, idx-form slices per output l)."""
    table, slices = _fused_cg_table(n_ells1, n_ells2, maxl)
    m1_tot, m2_tot, k_tot = table.shape
    off1 = np.cumsum([0] + [2 * l + 1 for l in range(n_ells1)])

    col_l1 = np.zeros(k_tot, np.int64)
    k = 0
    for (l, l1, _l2) in _blocks(n_ells1, n_ells2, maxl):
        col_l1[k:k + 2 * l + 1] = l1
        k += 2 * l + 1

    def ceil128(n):
        return -(-n // 128)

    groups = [np.flatnonzero(col_l1 == l1) for l1 in range(n_ells1)]
    dense_passes = ceil128(m1_tot * m2_tot) * ceil128(k_tot)
    grouped_passes = sum(
        ceil128((2 * l1 + 1) * m2_tot) * ceil128(len(g))
        for l1, g in enumerate(groups) if len(g))
    if grouped_passes >= dense_passes:
        return None

    flat = table.reshape(m1_tot * m2_tot, k_tot)
    tables = tuple(
        np.ascontiguousarray(
            flat[off1[l1] * m2_tot:off1[l1 + 1] * m2_tot, g], np.float32)
        for l1, g in enumerate(groups))
    perm = np.concatenate([g for g in groups if len(g)]).astype(np.int64)
    inv = np.empty(k_tot, np.int64)
    inv[perm] = np.arange(k_tot)
    return tables, perm, _slices_idx(slices, inv, maxl)


@lru_cache(maxsize=None)
def fused_cg_table_tri(n_ells: int, maxl: int):
    """Triangular fold of the square's table (self product a⊗a): only the
    M(M+1)/2 pairs m <= n, with C[m,n]+C[n,m] off the diagonal; columns
    grouped by lmin = min(l1, l2). Returns (pairs int32 [P, 2], groups per
    lmin of (row_a, row_b, table [P_g, K_g]), perm [K], idx-form slices)."""
    table, slices = _fused_cg_table(n_ells, n_ells, maxl)
    m_tot, _, k_tot = table.shape
    off1 = np.cumsum([0] + [2 * l + 1 for l in range(n_ells)])
    block = np.searchsorted(off1, np.arange(m_tot), side='right') - 1

    pairs = np.array([(m, n) for m in range(m_tot) for n in range(m, m_tot)],
                     np.int32)
    folded = table[pairs[:, 0], pairs[:, 1], :].copy()
    off_diag = pairs[:, 0] != pairs[:, 1]
    folded[off_diag] += table[pairs[off_diag, 1], pairs[off_diag, 0], :]

    col_lmin = np.zeros(k_tot, np.int64)
    k = 0
    for (l, l1, l2) in _blocks(n_ells, n_ells, maxl):
        col_lmin[k:k + 2 * l + 1] = min(l1, l2)
        k += 2 * l + 1

    row_block = block[pairs[:, 0]]
    groups = []
    for lmin in range(n_ells):
        rows = np.flatnonzero(row_block == lmin)
        a, b = (int(rows[0]), int(rows[-1]) + 1) if len(rows) else (0, 0)
        cols = np.flatnonzero(col_lmin == lmin)
        groups.append((a, b, np.ascontiguousarray(folded[a:b][:, cols],
                                                  np.float32)))
    perm = np.concatenate([np.flatnonzero(col_lmin == g)
                           for g in range(n_ells)]).astype(np.int64)
    inv = np.empty(k_tot, np.int64)
    inv[perm] = np.arange(k_tot)
    return pairs, tuple(groups), perm, _slices_idx(slices, inv, maxl)


@lru_cache(maxsize=None)
def _table_on(n_ells1: int, n_ells2: int, maxl: int,
              device: torch.device) -> torch.Tensor:
    """The fused table as a [M1*M2, K] tensor on `device`, built once."""
    table, _slices = _fused_cg_table(n_ells1, n_ells2, maxl)
    m1, m2, k = table.shape
    return torch.from_numpy(table.reshape(m1 * m2, k)).to(device)


def pack_so3(rep: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-l SO3Vec -> packed [..., tau, M, 2]."""
    return torch.cat(list(rep), dim=-2)


def unpack_so3(packed: torch.Tensor, n_ells: int) -> List[torch.Tensor]:
    """Packed [..., tau, M, 2] -> per-l list (pure slices)."""
    outs, off = [], 0
    for l in range(n_ells):
        outs.append(packed[..., off:off + 2 * l + 1, :])
        off += 2 * l + 1
    return outs


def m_slices(n_ells: int, maxl: int) -> Tuple[Tuple[int, int], ...]:
    """Slice table of an M-form packed rep: one 'pair' per l the rep
    carries, zero after."""
    out, off = [], 0
    for l in range(maxl + 1):
        if l < n_ells:
            out.append((off, 1))
            off += 2 * l + 1
        else:
            out.append((off, 0))
    return tuple(out)


def pack_so3_ri(rep: Sequence[torch.Tensor]):
    """Per-l SO3Vec -> packed (real, imag), each a contiguous [..., tau, M]:
    the parts are packed separately, so that neither is a strided view of a
    stacked tensor."""
    return (torch.cat([x[..., 0] for x in rep], dim=-1),
            torch.cat([x[..., 1] for x in rep], dim=-1))


def cg_product_packed_ri(a_r: torch.Tensor, a_i: torch.Tensor,
                         b_r: torch.Tensor, b_i: torch.Tensor,
                         n_ells1: int, n_ells2: int, maxl: int):
    """Channel-wise CG product of two packed reps, complex parts separate:
    ((out_r, out_i) [..., tau, K], slices). On the card this is the kernel
    of ops/fused_cg.py, which takes contiguous operands."""
    table, slices = _fused_cg_table(n_ells1, n_ells2, maxl)
    return cg_contract_ri(a_r, a_i, b_r, b_i, table), slices


def cg_product_packed(a: torch.Tensor, b: torch.Tensor, n_ells1: int,
                      n_ells2: int, maxl: int):
    """cg_product_packed_ri on stacked complex reps [..., tau, M, 2]:
    (packed_out [..., tau, K, 2], slices). The stacked parts are unstacked
    into contiguous tensors first (one copy each)."""
    (out_r, out_i), slices = cg_product_packed_ri(
        a[..., 0].contiguous(), a[..., 1].contiguous(),
        b[..., 0].contiguous(), b[..., 1].contiguous(), n_ells1, n_ells2, maxl)
    return torch.stack([out_r, out_i], dim=-1), slices


def cg_aggregate_packed(edge: torch.Tensor, atom: torch.Tensor,
                        n_ells_edge: int, n_ells_atom: int, maxl: int):
    """Neighbourhood-aggregating CG product on packed reps:
    edge [..., i, j, tau, M1, 2] x atom [..., j, tau, M2, 2]
    -> (out [..., i, tau, K, 2], slices); out_i = sum_j edge_ij (x)_CG atom_j."""
    _table, slices = _fused_cg_table(n_ells_edge, n_ells_atom, maxl)
    tab2 = _table_on(n_ells_edge, n_ells_atom, maxl, edge.device)
    er, ei = edge[..., 0], edge[..., 1]
    ar, ai = atom[..., 0], atom[..., 1]
    pattern = '...ijtm,...jtn->...itmn'
    zr = torch.einsum(pattern, er, ar) - torch.einsum(pattern, ei, ai)
    zi = torch.einsum(pattern, er, ai) + torch.einsum(pattern, ei, ar)
    shape = zr.shape[:-2] + (zr.shape[-2] * zr.shape[-1], )
    out = torch.stack([zr.reshape(shape) @ tab2, zi.reshape(shape) @ tab2],
                      dim=-1)
    return out, slices


# ---------------------------------------------------------------------------
# per-l API: SO3Vecs as lists of [..., tau_l, 2l+1, 2] tensors
# ---------------------------------------------------------------------------

def _pair_taus(t1: int, t2: int) -> int:
    if not (t1 == t2 or t1 == 1 or t2 == 1):
        raise ValueError('CG product needs matching or broadcastable taus, '
                         f'got {t1}, {t2}')
    return max(t1, t2)


def _broadcast_taus(rep1: Sequence[torch.Tensor],
                    rep2: Sequence[torch.Tensor]):
    """Both reps with every entry expanded to their common tau."""
    tau = _pair_taus(max(a.shape[-3] for a in rep1),
                     max(b.shape[-3] for b in rep2))

    def expand(rep):
        out = []
        for a in rep:
            t = a.shape[-3]
            if t != tau and t != 1:
                raise ValueError(f'per-l tau {t} vs {tau}')
            if t != tau:
                a = a.expand(a.shape[:-3] + (tau, ) + a.shape[-2:])
            out.append(a)
        return out

    return expand(rep1), expand(rep2)


def _pack_m(rep: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(rep), dim=-2)  # [..., tau, M, 2]


def _unpack_out(out_flat: torch.Tensor, slices,
                maxl: int) -> List[torch.Tensor]:
    """out_flat [..., tau, K, 2] -> per-l [..., n_pairs*tau, 2l+1, 2] with
    the loop implementation's pair-major tau order."""
    outs = []
    for l in range(maxl + 1):
        offset, n_pairs = slices[l]
        width = n_pairs * (2 * l + 1)
        part = out_flat[..., :, offset:offset + width, :]
        shape = part.shape
        tau = shape[-3]
        part = part.reshape(shape[:-2] + (n_pairs, 2 * l + 1, 2))
        part = part.movedim(-3, -4)      # [..., n_pairs, tau, 2l+1, 2]
        outs.append(part.reshape(shape[:-3] + (n_pairs * tau, 2 * l + 1, 2)))
    return outs


def cg_product(rep1: Sequence[torch.Tensor], rep2: Sequence[torch.Tensor],
               maxl: int) -> List[torch.Tensor]:
    """Channel-wise CG tensor product of two SO3Vecs. Output entry l
    concatenates, along tau, the (l1, l2) pairs with
    |l1-l2| <= l <= min(l1+l2, maxl). A tau of 1 is broadcast; packing
    copies it out, so no stride-0 view reaches the kernel."""
    rep1, rep2 = _broadcast_taus(rep1, rep2)
    out, slices = cg_product_packed(_pack_m(rep1), _pack_m(rep2),
                                    len(rep1), len(rep2), maxl)
    return _unpack_out(out, slices, maxl)


def cg_aggregate(edge_rep: Sequence[torch.Tensor],
                 atom_rep: Sequence[torch.Tensor],
                 maxl: int) -> List[torch.Tensor]:
    """Neighbourhood-aggregating CG product: out_i = sum_j edge_ij (x)_CG
    atom_j.

    edge_rep entry l2: [..., N, M, tau, 2*l2+1, 2]
    atom_rep entry l1: [..., M, tau, 2*l1+1, 2]
    output entry l:    [..., N, tau_out, 2*l+1, 2]
    """
    edge_rep, atom_rep = _broadcast_taus(edge_rep, atom_rep)
    out, slices = cg_aggregate_packed(_pack_m(edge_rep), _pack_m(atom_rep),
                                      len(edge_rep), len(atom_rep), maxl)
    return _unpack_out(out, slices, maxl)


def cg_output_taus(taus1: Sequence[int], taus2: Sequence[int],
                   maxl: int) -> Tuple[int, ...]:
    """Channel counts of the cg_product output."""
    out = [0] * (maxl + 1)
    for l1, t1 in enumerate(taus1):
        for l2, t2 in enumerate(taus2):
            tau = _pair_taus(t1, t2)
            for l in range(abs(l1 - l2), min(l1 + l2, maxl) + 1):
                out[l] += tau
    return tuple(out)


def _complex_contract(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor,
                      pattern: str) -> torch.Tensor:
    """einsum of stacked complex operands against a real CG table."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    rr = torch.einsum(pattern, ar, br, table)
    ii = torch.einsum(pattern, ai, bi, table)
    ri = torch.einsum(pattern, ar, bi, table)
    ir = torch.einsum(pattern, ai, br, table)
    return torch.stack([rr - ii, ri + ir], dim=-1)


def _loops(rep1, rep2, maxl: int, pattern: str) -> List[torch.Tensor]:
    """Per-(l1, l2, l) products of rep1[l1] with rep2[l2], in loop order."""
    out_parts: List[List[torch.Tensor]] = [[] for _ in range(maxl + 1)]
    for l1, a in enumerate(rep1):
        for l2, b in enumerate(rep2):
            tau = _pair_taus(a.shape[-3], b.shape[-3])
            a_t = a.expand(a.shape[:-3] + (tau, ) + a.shape[-2:])
            b_t = b.expand(b.shape[:-3] + (tau, ) + b.shape[-2:])
            for l in range(abs(l1 - l2), min(l1 + l2, maxl) + 1):
                table = torch.from_numpy(
                    cg_table(l1, l2, l).astype(np.float32)).to(a.device)
                out_parts[l].append(_complex_contract(a_t, b_t, table, pattern))
    return [torch.cat(parts, dim=-3) for parts in out_parts]


def _cg_product_loops(rep1: Sequence[torch.Tensor],
                      rep2: Sequence[torch.Tensor],
                      maxl: int) -> List[torch.Tensor]:
    """Per-(l1, l2, l) loop implementation of cg_product: the oracle the
    tests hold the packed path against."""
    return _loops(rep1, rep2, maxl, '...tm,...tn,mnk->...tk')


def _cg_aggregate_loops(edge_rep: Sequence[torch.Tensor],
                        atom_rep: Sequence[torch.Tensor],
                        maxl: int) -> List[torch.Tensor]:
    """Loop implementation of cg_aggregate: the tests' oracle."""
    return _loops(edge_rep, atom_rep, maxl, '...ijtm,...jtn,mnk->...itk')
