"""Carry CovariantAC weights, and the optimizer state beside them, from the
Flax param tree and the optax state to the port.

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
from typing import Any, Dict, Mapping

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


def flatten_tree(tree: Mapping, prefix: str = '') -> Dict[str, np.ndarray]:
    """Nested mapping of arrays (a Flax param tree) -> {'a/b/c': array}."""
    out = {}
    for key, value in tree.items():
        name = f'{prefix}/{key}' if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def _adam_state(state: Any):
    """The ScaleByAdamState / ScaleByAmsgradState inside an optax chain's
    state (nested tuples), found by its fields."""
    if all(hasattr(state, f) for f in ('count', 'mu', 'nu')):
        return state
    if isinstance(state, (tuple, list)):
        for part in state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def optimizer_state_from_jax(opt_state: Any) -> dict:
    """The optax state of clip_by_global_norm + adam (or amsgrad) -> the
    state of the port's rl.ppo.Optimizer: count, and the moment trees mu,
    nu (and nu_max) renamed and transposed as the params are."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError('no adam / amsgrad state (count, mu, nu) in the '
                         'optax state')
    out = {'count': int(np.asarray(adam.count))}
    for key in ('mu', 'nu', 'nu_max'):
        if hasattr(adam, key):
            out[key] = covariant_params_from_jax(flatten_tree(getattr(adam, key)))
    return out
