"""Carry agent weights, and the optimizer state beside them, from the Flax
param tree and the optax state to the port.

The port's modules mirror the Flax module names, so the map is a renaming:

  * 'params/' prefix dropped, '/' -> '.'
  * Flax Dense `kernel` [in, out] -> torch Linear `weight` [out, in]
  * MLP `Dense_{i}` -> `layers.{i}`
  * LayerNorm `scale` -> `weight` (the port's LayerNorms use Flax's eps 1e-6)
  * PackedCatMix `w_{r,i}_l{l}_s{s}` [pairs, tau, tau_out],
    `distance_log_stds` and `log_stds` are taken as they are.

The internal agents (InternalAC) name their encoders' modules:

  * `encoder/Embed_0/embedding` -> `encoder.embedding.weight`
  * `encoder/SchNetInteraction_{i}/Dense_{j}` ->
    `encoder.interactions.{i}.<filter_in, filter_out, in2f, f2out, out>`
    for j = 0 .. 4 (the port's SchNetInteraction)
  * `encoder/MLP_0/Dense_{j}` -> `encoder.mlp.layers.{j}` (AtomMLPEncoder)
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

ParamMap = Callable[[Dict[str, np.ndarray]], Dict[str, torch.Tensor]]
# the port's names of a Flax SchNetInteraction's Dense_0 .. Dense_4
INTERACTION_DENSES = ('filter_in', 'filter_out', 'in2f', 'f2out', 'out')


def _params_from_jax(flat: Dict[str, np.ndarray],
                     rename: Callable[[str], str]) -> Dict[str, torch.Tensor]:
    """Flattened Flax params (keys joined by '/', with or without the
    leading 'params/') -> a state_dict, each dotted name passed through
    `rename`."""
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
        elif leaf in ('scale', 'embedding'):
            parts[-1] = 'weight'
        state[rename('.'.join(parts))] = torch.from_numpy(
            np.array(value, copy=True))
    return state


def _mlp_layers(name: str) -> str:
    return re.sub(r'\.Dense_(\d+)\.', r'.layers.\1.', name)


def covariant_params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened Flax params of CovariantAC -> a state_dict for the port's
    CovariantAC."""
    return _params_from_jax(flat, _mlp_layers)


def _internal_name(name: str) -> str:
    name = name.replace('encoder.Embed_0.', 'encoder.embedding.')
    name = re.sub(r'^encoder\.SchNetInteraction_(\d+)\.Dense_(\d)\.',
                  lambda m: (f'encoder.interactions.{m.group(1)}.'
                             f'{INTERACTION_DENSES[int(m.group(2))]}.'), name)
    name = name.replace('encoder.MLP_0.', 'encoder.mlp.')
    return _mlp_layers(name)


def internal_params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened Flax params of InternalAC (the `internal` SchNet agent or
    the `mlp` one) -> a state_dict for the port's InternalAC."""
    return _params_from_jax(flat, _internal_name)


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


def _field(state: Any, key: str):
    return state[key] if isinstance(state, Mapping) else getattr(state, key)


def _adam_state(state: Any):
    """The ScaleByAdamState / ScaleByAmsgradState inside an optax chain's
    state (nested tuples), found by its fields; in a checkpoint restored
    without a template (ModelIO._restore_raw) the same state is nested
    lists and dicts, and in a portable archive nested dicts keyed '0',
    '1', ..."""
    keys = ('count', 'mu', 'nu')
    if (all(k in state for k in keys) if isinstance(state, Mapping)
            else all(hasattr(state, k) for k in keys)):
        return state
    parts = (state.values() if isinstance(state, Mapping)
             else state if isinstance(state, (tuple, list)) else ())
    for part in parts:
        found = _adam_state(part)
        if found is not None:
            return found
    return None


def optimizer_state_from_jax(
        opt_state: Any,
        params_from_jax: ParamMap = covariant_params_from_jax) -> dict:
    """The optax state of clip_by_global_norm + adam (or amsgrad) -> the
    state of the port's rl.ppo.Optimizer: count, and the moment trees mu,
    nu (and nu_max) renamed and transposed as the agent's params are by
    `params_from_jax` (the covariant map, or internal_params_from_jax)."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError('no adam / amsgrad state (count, mu, nu) in the '
                         'optax state')
    out = {'count': int(np.asarray(_field(adam, 'count')))}
    for key in ('mu', 'nu', 'nu_max'):
        if (key in adam if isinstance(adam, Mapping) else hasattr(adam, key)):
            out[key] = params_from_jax(flatten_tree(_field(adam, key)))
    return out


# the param map of each --model
FAMILY_MAPS: Dict[str, ParamMap] = {'covariant': covariant_params_from_jax,
                                    'internal': internal_params_from_jax,
                                    'mlp': internal_params_from_jax}


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    """{'a/b/c': array} -> nested dicts."""
    tree: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split('/')
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def checkpoint_from_jax(flat: Mapping[str, np.ndarray], family: str) -> dict:
    """A JAX checkpoint as a flat tree of '/'-joined keys ('params/params/
    ...', and 'opt_state/1/0/mu/params/...' where it holds the optimizer
    state; a portable archive's layout) of the `family` of agents
    ('covariant', 'internal' or 'mlp') -> {'model': state_dict,
    'optimizer': the state of rl.ppo.Optimizer}. Without optimizer state
    there is no 'optimizer': the optimizer starts fresh, as the JAX
    driver's does."""
    params_map = FAMILY_MAPS[family]

    def subtree(root: str) -> Dict[str, np.ndarray]:
        return {k[len(root) + 1:]: v for k, v in flat.items()
                if k.startswith(root + '/')}
    out = {'model': params_map(subtree('params'))}
    opt_state = subtree('opt_state')
    if opt_state:
        out['optimizer'] = optimizer_state_from_jax(_unflatten(opt_state),
                                                    params_map)
    return out
