"""What the per-layer metrics' readers (metrics/*.py) share. Each takes
the run's context: `window` (the loop's statistics of the timed window),
`trace` (the profiled piece after it, or None), `traced_steps` and
`traced_calls` (its env steps and the kernel calls it made, by the
benchmark's count). A reader that finds nothing to read returns None."""
from __future__ import annotations

from collections import Counter
from statistics import mean
from typing import Optional

from harness import count


def mean_ms(ctx: dict, key: str) -> Optional[float]:
    """The window's mean of a list of host-clock seconds, in ms."""
    values = ctx['window'].get(key)
    return 1e3 * mean(values) if values else None


def per_iteration(ctx: dict, key: str) -> Optional[float]:
    values = ctx['window'].get(key)
    return float(mean(values)) if values else None


def mfu_pct(ctx: dict) -> Optional[float]:
    """The window's model FLOPs (count.flops' `model`) over its seconds, as
    a share of the card's f32 peak."""
    w = ctx['window']
    if not w['steps']:
        return None
    return 100 * w['model_flops'] / w['seconds'] / count.PEAK_FLOP_PER_S


def _trace(ctx: dict):
    tr = ctx['trace']
    return tr if tr is not None and tr.saw_device else None


def kernel_roofline_pct(ctx: dict) -> Optional[float]:
    """The program's kernels' least time (count.least_seconds of the calls
    the traced work made) over their summed device time in the trace. Left
    out where the trace's launches of a kernel differ from the count's."""
    tr = _trace(ctx)
    if tr is None or not ctx['traced_calls']:
        return None
    expected = Counter(k for k, _o, _b in ctx['traced_calls'])
    device = 0.0
    for name in count.KERNELS:
        seconds, n = tr.seconds_of(name)
        if n != expected.get(name, 0):
            return None
        device += seconds
    return 100 * count.least_seconds(ctx['traced_calls']) / device if device else None


def launches_per_env_step(ctx: dict) -> Optional[float]:
    tr = _trace(ctx)
    return tr.launches / ctx['traced_steps'] if tr and ctx['traced_steps'] else None


def device_idle_pct(ctx: dict) -> Optional[float]:
    tr = _trace(ctx)
    return 100 * (1 - tr.busy_s / tr.window_s) if tr else None
