"""Carry CovariantAC weights from the Flax param tree to the port.

The port's modules mirror the Flax module names, so the map is a renaming:

  * 'params/' prefix dropped, '/' -> '.'
  * Flax Dense `kernel` [in, out] -> torch Linear `weight` [out, in]
  * MLP `Dense_{i}` -> `layers.{i}`
  * LayerNorm `scale` -> `weight` (the port's LayerNorms use Flax's eps 1e-6)
  * PackedCatMix `w_{r,i}_l{l}_s{s}` [pairs, tau, tau_out] and
    `distance_log_stds` are taken as they are.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def covariant_params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened Flax params of CovariantAC (keys joined by '/', with or
    without the leading 'params/') -> a state_dict for the port's
    CovariantAC."""
    state = {}
    for key, value in flat.items():
        parts = key.split('/')
        if parts[0] == 'params':
            parts = parts[1:]
        value = np.asarray(value, dtype=np.float32)
        leaf = parts[-1]
        if leaf == 'kernel':
            parts[-1] = 'weight'
            value = value.T
        elif leaf == 'scale':
            parts[-1] = 'weight'
        name = '.'.join(parts)
        name = re.sub(r'\.Dense_(\d+)\.', r'.layers.\1.', name)
        state[name] = torch.from_numpy(np.array(value, copy=True))
    return state
