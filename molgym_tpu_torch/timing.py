"""Device time of small calls on a CUDA card."""
from __future__ import annotations

import torch


def time_ms(fn, reps=30, replays=5, stream=None):
    """Mean device time of one call: `reps` calls captured in a CUDA graph,
    replayed between CUDA events. Replay leaves out the host's time to issue
    each call, which at these sizes is longer than the kernels themselves and
    would otherwise be measured as gaps between launches. `fn` is warmed up
    and captured on `stream` (a new side stream by default)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode='relaxed'):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)
