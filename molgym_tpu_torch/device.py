"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`cuda` when no device is named; raises when a CUDA device is asked
    for (by default or by name) and no card is visible.

    The port never falls back to the CPU by itself: a caller that wants the
    CPU (the tests, a debugging session) says so with device='cpu'."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is visible; pass device="cpu" to run on the CPU')
    return device
