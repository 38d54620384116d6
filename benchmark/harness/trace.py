"""One piece of the timed work under torch.profiler, read in memory: the
device's operations (their time, count and names), the seconds in which
any ran, and the device's idle gaps by what the host was doing meanwhile.
Nothing is written to disk."""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple


class Trace:

    def __init__(self, events, window_s: float):
        from torch.autograd import DeviceType
        self.window_s = window_s
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        self.ops = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
                    for e in dev]
        self.ops.sort(key=lambda x: x[1])
        self.host = sorted(
            (e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
            for e in events
            if e.device_type == DeviceType.CPU and e.cpu_parent is None)
        self.busy = self._union([(a, b) for _n, a, b in self.ops])

    @staticmethod
    def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for a, b in sorted(spans):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def saw_device(self) -> bool:
        """Whether the profiler saw the device at all (where it did not,
        every device reading is left out)."""
        return bool(self.ops) and self.busy_s > 0

    @property
    def launches(self) -> int:
        return len(self.ops)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def seconds_of(self, pattern: str) -> Tuple[float, int]:
        """(summed device seconds, count) of the operations whose name
        holds the function name `pattern` as a whole word."""
        rx = re.compile(rf'\b{re.escape(pattern)}\b')
        spans = [b - a for name, a, b in self.ops if rx.search(name)]
        return sum(spans), len(spans)

    def device_ops(self, top: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for name, a, b in self.ops:
            by[name[:64]] += b - a
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle time between its first and last operation,
        split by the top-level host operation that ran meanwhile
        (`python_between_operations` where none did)."""
        by: Dict[str, float] = defaultdict(float)
        starts = [h[0] for h in self.host]
        for (_a, end), (start, _b) in zip(self.busy, self.busy[1:]):
            covered = 0.0
            i = max(bisect.bisect_right(starts, end) - 1, 0)
            # host operations are short: look back a little for one still open
            j = max(i - 64, 0)
            for h0, h1, name in self.host[j:]:
                if h0 >= start:
                    break
                overlap = min(h1, start) - max(h0, end)
                if overlap > 0:
                    by[name[:64]] += overlap
                    covered += overlap
            by['python_between_operations'] += max(start - end - covered, 0.0)
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:top]]


def profile(fn: Callable, sync: Callable) -> Tuple[Trace, object]:
    """fn() under the profiler (host and device), ended by `sync`."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    sync()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    return Trace(prof.events(), wall), out

