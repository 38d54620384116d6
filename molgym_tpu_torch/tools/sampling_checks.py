"""Whether an internal agent's sampled actions come from the distributions
that its `evaluate` scores them under, and whether two sets of draws come
from the same ones: goodness-of-fit tests on the host (numpy and scipy).

The draws are flat actions [M, 7] (InternalAC's layout: stop, focus,
element, distance, angle, dihedral, kappa), each row with the id of the
observation it was drawn at, and the distributions are
`InternalAC.head_distributions` at those actions (each sub-action's given
the ones before it):
  * focus: a chi-square over the canvas's slots, pooled over the
    observations;
  * element: a chi-square given the focus, pooled over (observation,
    focus);
  * distance, angle, dihedral, each standardised by its mean and standard
    deviation: a Kolmogorov-Smirnov test against N(0, 1) and a chi-square
    of the sum of squares (the scale; a KS test misses a standard deviation
    10% off at 10^4 draws);
  * kappa, given the continuous sub-actions: the rows binned by their
    probability of kappa = 1, a chi-square of each bin's count against its
    expected count.
Two sets of draws at the same observations are compared by the same
statistics' two-sample forms (contingency chi-squares, KS, the ratio of
the mean squares, each kappa bin's excess in one set against the other's).

`check_draws` and `compare_draws` return the p-value of each statistic by
name; a set of draws passes at P_MIN when every p-value is at or above it.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
from scipy import stats

P_MIN = 1e-3
CONTINUOUS = ('distance', 'angle', 'dihedral')
KAPPA_BINS = 10
# a category whose expected (one sample) or pooled (two samples) count is
# below this joins the group's remainder bin
MIN_COUNT = 5.0


def _merge_small(expected: np.ndarray, *counts: np.ndarray):
    """The categories of one group with `expected` >= MIN_COUNT, and the
    rest summed into one bin (dropped if its expectation is 0)."""
    big = expected >= MIN_COUNT
    out = [np.append(x[big], x[~big].sum()) for x in (expected, ) + counts]
    if out[0][-1] == 0:
        out = [x[:-1] for x in out]
    return out


def chi_square(groups: Iterable[Tuple[np.ndarray, np.ndarray]]
               ) -> Tuple[float, int, float]:
    """(statistic, degrees of freedom, p) of observed counts against their
    probabilities, summed over groups of (counts, probs); p = 0 where a
    category of probability 0 was drawn."""
    stat, df = 0.0, 0
    for counts, probs in groups:
        n = counts.sum()
        if n == 0:
            continue
        if np.any(counts[probs <= 0] > 0):
            return float('inf'), df, 0.0
        expected, observed = _merge_small(n * probs / probs.sum(), counts)
        if len(expected) < 2:
            continue
        stat += float(((observed - expected) ** 2 / expected).sum())
        df += len(expected) - 1
    return stat, df, float(stats.chi2.sf(stat, df)) if df else 1.0


def chi_square_two_sample(groups: Iterable[Tuple[np.ndarray, np.ndarray]]
                          ) -> Tuple[float, int, float]:
    """(statistic, df, p) of a contingency chi-square of two samples'
    counts over the same categories, summed over groups of (a, b)."""
    stat, df = 0.0, 0
    for a, b in groups:
        na, nb = a.sum(), b.sum()
        if na == 0 or nb == 0:
            continue
        pooled, a, b = _merge_small(a + b, a, b)
        if len(pooled) < 2:
            continue
        for counts, n in ((a, na), (b, nb)):
            expected = pooled * n / (na + nb)
            stat += float(((counts - expected) ** 2 / expected).sum())
        df += len(pooled) - 1
    return stat, df, float(stats.chi2.sf(stat, df)) if df else 1.0


def normal_tests(z: np.ndarray) -> Dict[str, float]:
    """p of a KS test of `z` against N(0, 1), and two-sided p of the sum of
    squares against chi-square(n)."""
    n = len(z)
    q = float(np.sum(np.square(z, dtype=np.float64)))
    tail = stats.chi2.sf(q, n) if q > n else stats.chi2.cdf(q, n)
    return dict(ks=float(stats.kstest(z, 'norm').pvalue),
                scale=float(min(1.0, 2 * tail)))


def normal_two_sample(za: np.ndarray, zb: np.ndarray) -> Dict[str, float]:
    """p of a two-sample KS test, and two-sided p of the ratio of the mean
    squares against F(na, nb)."""
    f = float(np.mean(np.square(za, dtype=np.float64))
              / np.mean(np.square(zb, dtype=np.float64)))
    tail = (stats.f.sf(f, len(za), len(zb)) if f > 1
            else stats.f.cdf(f, len(za), len(zb)))
    return dict(ks=float(stats.ks_2samp(za, zb).pvalue),
                scale=float(min(1.0, 2 * tail)))


def _kappa_bins(p: np.ndarray, edges: np.ndarray) -> np.ndarray:
    return np.clip(np.searchsorted(edges, p, side='right') - 1, 0,
                   len(edges) - 2)


def _bin_edges(p: np.ndarray) -> np.ndarray:
    edges = np.unique(np.quantile(p, np.linspace(0, 1, KAPPA_BINS + 1)))
    return edges if len(edges) > 1 else np.array([0.0, 1.0])


def _kappa_excess(k, p, bins, num_bins):
    """Per bin: (observed - expected count of kappa = 1, its variance)."""
    excess = np.bincount(bins, k - p, num_bins)
    var = np.bincount(bins, p * (1 - p), num_bins)
    return excess, var


def kappa_test(k: np.ndarray, p: np.ndarray) -> Tuple[float, int, float]:
    """(statistic, df, p): draws k in {0, 1} of Bernoulli(p), binned by p
    into KAPPA_BINS quantiles; each bin's excess count squared over its
    variance, summed."""
    edges = _bin_edges(p)
    bins = _kappa_bins(p, edges)
    excess, var = _kappa_excess(k, p, bins, len(edges) - 1)
    keep = var > 0
    stat = float(np.sum(excess[keep] ** 2 / var[keep]))
    df = int(keep.sum())
    return stat, df, float(stats.chi2.sf(stat, df)) if df else 1.0


def kappa_two_sample(ka, pa, kb, pb) -> Tuple[float, int, float]:
    """(statistic, df, p): two sets of Bernoulli draws, each with its own
    probabilities, binned alike by the pooled probabilities' quantiles; the
    difference of the bins' mean excesses over its variance, summed."""
    edges = _bin_edges(np.concatenate([pa, pb]))
    num = len(edges) - 1
    sums = []
    for k, p in ((ka, pa), (kb, pb)):
        bins = _kappa_bins(p, edges)
        excess, var = _kappa_excess(k, p, bins, num)
        rows = np.bincount(bins, minlength=num).astype(np.float64)
        sums.append((excess, var, rows))
    (ea, va, na), (eb, vb, nb) = sums
    keep = (na > 0) & (nb > 0) & (va + vb > 0)
    diff = ea[keep] / na[keep] - eb[keep] / nb[keep]
    var = va[keep] / na[keep] ** 2 + vb[keep] / nb[keep] ** 2
    stat = float(np.sum(diff ** 2 / var))
    df = int(keep.sum())
    return stat, df, float(stats.chi2.sf(stat, df)) if df else 1.0


def _as_numpy(dists) -> dict:
    return {name: np.asarray(getattr(dists, name), dtype=np.float64)
            for name in ('focus', 'element', 'means', 'stds', 'kappa')}


def standardized(actions: np.ndarray, dists) -> np.ndarray:
    """[M, 3]: the distance, angle and dihedral of each draw less its mean,
    over its standard deviation."""
    d = _as_numpy(dists)
    return (actions[:, 3:6] - d['means']) / d['stds'].reshape(1, 3)


def _focus_groups(actions, obs_ids, focus):
    num = focus.shape[1]
    for i in np.unique(obs_ids):
        rows = obs_ids == i
        counts = np.bincount(actions[rows, 1].astype(int), minlength=num)
        yield counts.astype(np.float64), focus[rows].mean(axis=0)


def _element_groups(actions, obs_ids, element):
    num = element.shape[1]
    focus = actions[:, 1].astype(int)
    for i in np.unique(obs_ids):
        for f in np.unique(focus[obs_ids == i]):
            rows = (obs_ids == i) & (focus == f)
            counts = np.bincount(actions[rows, 2].astype(int), minlength=num)
            yield counts.astype(np.float64), element[rows].mean(axis=0)


def check_draws(actions: np.ndarray, obs_ids: np.ndarray,
                dists) -> Dict[str, float]:
    """The p-value of each statistic (see the module docstring) of sampled
    `actions` [M, 7] drawn at the observations `obs_ids` [M], against
    `dists` (HeadDistributions at those actions, as arrays or tensors)."""
    actions = np.asarray(actions, dtype=np.float64)
    d = _as_numpy(dists)
    out = dict(focus=chi_square(_focus_groups(actions, obs_ids,
                                              d['focus']))[2],
               element=chi_square(_element_groups(actions, obs_ids,
                                                  d['element']))[2])
    z = standardized(actions, dists)
    for j, name in enumerate(CONTINUOUS):
        for test, p in normal_tests(z[:, j]).items():
            out[f'{name}_{test}'] = p
    out['kappa'] = kappa_test(actions[:, 6], d['kappa'][:, 1])[2]
    return out


def compare_draws(actions_a: np.ndarray, dists_a, actions_b: np.ndarray,
                  dists_b, obs_ids_a: np.ndarray,
                  obs_ids_b: np.ndarray) -> Dict[str, float]:
    """The p-value of each two-sample statistic of two sets of draws at the
    same observations, each with the distributions at its own actions."""
    a = np.asarray(actions_a, dtype=np.float64)
    b = np.asarray(actions_b, dtype=np.float64)
    num_focus = np.asarray(dists_a.focus).shape[1]
    num_elements = np.asarray(dists_a.element).shape[1]

    def counts(actions, rows, col, num):
        return np.bincount(actions[rows, col].astype(int),
                           minlength=num).astype(np.float64)

    focus_groups, element_groups = [], []
    for i in np.unique(obs_ids_a):
        ra, rb = obs_ids_a == i, obs_ids_b == i
        focus_groups.append((counts(a, ra, 1, num_focus),
                             counts(b, rb, 1, num_focus)))
        for f in np.unique(a[ra, 1]):
            fa, fb = ra & (a[:, 1] == f), rb & (b[:, 1] == f)
            element_groups.append((counts(a, fa, 2, num_elements),
                                   counts(b, fb, 2, num_elements)))
    out = dict(focus=chi_square_two_sample(focus_groups)[2],
               element=chi_square_two_sample(element_groups)[2])
    za, zb = standardized(a, dists_a), standardized(b, dists_b)
    for j, name in enumerate(CONTINUOUS):
        for test, p in normal_two_sample(za[:, j], zb[:, j]).items():
            out[f'{name}_{test}'] = p
    out['kappa'] = kappa_two_sample(
        a[:, 6], np.asarray(dists_a.kappa, dtype=np.float64)[:, 1],
        b[:, 6], np.asarray(dists_b.kappa, dtype=np.float64)[:, 1])[2]
    return out


def failures(p_values: Dict[str, float], p_min: float = P_MIN) -> Dict[str, float]:
    """The statistics whose p-value is below `p_min`."""
    return {k: p for k, p in p_values.items() if p < p_min}
