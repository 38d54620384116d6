"""The policy's weights, made by the benchmark from the seed on the device
in one draw, and handed alike to the program and to the reference.

Scales by the parameter's role: biases 0, layer-norm gains 1, the distance
head's log standard deviations log 0.1, a channel mix's weights of an l
1/sqrt(2 C) with C the pairs times channels that l mixes over its sources
(the Cormorant mix's own scale), every other matrix 1/sqrt(fan in)."""
from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch

MIX = re.compile(r'^(.*)\.w_r_l(\d+)_s(\d+)$')


def stream(seed: int, purpose: int) -> int:
    """A generator seed for one purpose of a run, from the run's seed."""
    state = np.random.SeedSequence([seed % 2 ** 64, purpose]).generate_state(
        1, np.uint64)[0]
    return int(state) % 2 ** 63


def _scales(shapes: Dict[str, torch.Size]) -> Dict[str, object]:
    mixed: Dict[tuple, int] = {}
    for name, shape in shapes.items():
        m = MIX.match(name)
        if m:
            key = (m.group(1), m.group(2))
            mixed[key] = mixed.get(key, 0) + shape[0] * shape[1]
    out = {}
    for name, shape in shapes.items():
        m = MIX.match(name.replace('.w_i_', '.w_r_'))
        if name.endswith('.bias'):
            out[name] = 0.0
        elif name.endswith('norm.weight'):
            out[name] = 1.0
        elif name == 'distance_log_stds':
            out[name] = math.log(0.1)
        elif m:
            out[name] = ('randn', 1 / math.sqrt(2 * mixed[(m.group(1), m.group(2))]))
        else:
            out[name] = ('randn', 1 / math.sqrt(shape[-1]))
    return out


def make(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights for parameters of these names and shapes, from `seed`."""
    scales = _scales(shapes)
    total = sum(int(np.prod(shapes[k])) for k, v in scales.items()
                if isinstance(v, tuple))
    gen = torch.Generator(device=device).manual_seed(stream(seed, 1))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        rule = scales[name]
        if isinstance(rule, tuple):
            n = int(np.prod(shape))
            out[name] = flat[at:at + n].view(shape) * rule[1]
            at += n
        else:
            out[name] = torch.full(shape, rule, device=device)
    return out
