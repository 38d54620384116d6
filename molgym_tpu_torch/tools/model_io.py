"""Checkpoint save/load with the file naming of molgym_tpu/tools/model_io.py:
`{tag}_steps-{n}.model`, the previous one deleted unless `keep`, resume by
the step count in the name. A checkpoint is one `torch.save` file holding the
model's state_dict, the optimizer's state (rl.ppo.Optimizer.state_dict) and
the step count.

Data-parallel runs save per process, as the JAX package's --multihost does:
the replicas hold the same state, so only a writer rank saves a full copy
(rank 0; under --multihost the first rank of each process, into that
process's own --model_dir), and every rank reads the checkpoint it resumes
from.

`load` also reads the JAX package's checkpoints, orbax directories of the
same name, through the portable archive that
tests/torch_export_checkpoints.py makes of each where JAX is installed
(molgym_tpu_torch/checkpoints/<experiment>/<tag>_steps-<n>.npz: flat
'/'-joined keys, numpy arrays, a JSON metadata entry); the archive's
recorded sha256 must match the directory's _METADATA and manifest.ocdbt.
Round-1 covariant checkpoints (per-l CG level weights) are migrated to the
packed layout on the way, as the JAX package's ModelIO.load does."""
from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from molgym_tpu_torch.convert import checkpoint_from_jax

ARCHIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'checkpoints')
EXPORT_COMMAND = 'python -m tests.torch_export_checkpoints <model dir>'
METADATA_KEY = '__metadata__'
HASHED_FILES = ('_METADATA', 'manifest.ocdbt')


_PACKED_W = re.compile(r'w_([ri])_l(\d+)_s(\d+)')
_LEGACY_AG = re.compile(r'ag_mix_l\d+')
_LEGACY_CAT = re.compile(r'mix_l\d+')


def _legacy_parent(key: str) -> Optional[str]:
    """The node that holds a round-1 CG level's weights (ag_mix_l{l}/...,
    cat_mix/mix_l{l}/...) of which `key` is a leaf, else None."""
    parts = key.split('/')
    for i, part in enumerate(parts):
        if _LEGACY_AG.fullmatch(part) or (
                part == 'cat_mix' and i + 1 < len(parts)
                and _LEGACY_CAT.fullmatch(parts[i + 1])):
            return '/'.join(parts[:i])
    return None


def is_legacy_covariant_tree(flat: Mapping[str, Any]) -> bool:
    """True if the flat tree holds round-1 per-l CG level weights
    (ag_mix_l{l} / cat_mix/mix_l{l}) anywhere."""
    return any(_LEGACY_AG.fullmatch(part) for key in flat
               for part in key.split('/'))


def _migrate_packed_mix(kind: str, old: Mapping[str, np.ndarray],
                        parent: str, template: Mapping[str, Tuple[int, ...]]
                        ) -> Dict[str, np.ndarray]:
    """One legacy ComplexLinear/CatMixReps weight group of `parent` in the
    flat tree `old` -> the PackedCatMix leaves `template` names
    ({'w_r_l0_s0': shape, ...}), as molgym_tpu/tools/model_io.py's function
    of the same name translates them:
      ag_mix_l{l}/{w_r,w_i} [p*tau, tau_out] -> ag_mix/w_{r,i}_l{l}_s0
        [p, tau, tau_out];
      cat_mix/mix_l{l}/{w_r,w_i} [tau_out + p_sq*tau_out + tau, tau_out]
        -> cat_mix/w_{r,i}_l{l}_s{0,1,2}, the rows in the order [linear,
        square, atom]."""
    out = {}
    for name, shape in template.items():
        m = _PACKED_W.fullmatch(name)
        if m is None:
            raise KeyError(f'unexpected key in packed mix template: {name}')
        part, l, s = f'w_{m.group(1)}', int(m.group(2)), int(m.group(3))
        if kind == 'ag_mix':
            w = np.asarray(old[f'{parent}/ag_mix_l{l}/{part}'])
            out[name] = w.reshape(shape)
        else:
            w = np.asarray(old[f'{parent}/cat_mix/mix_l{l}/{part}'])
            sizes = []
            for si in range(3):
                t_si = template.get(f'{part}_l{l}_s{si}')
                sizes.append(0 if t_si is None else int(np.prod(t_si[:2])))
            if sum(sizes) != w.shape[0]:
                raise ValueError(
                    f'legacy cat_mix mix_l{l} has {w.shape[0]} rows, packed '
                    f'template expects {sum(sizes)}')
            pieces = np.split(w, np.cumsum(sizes)[:-1], axis=0)
            out[name] = pieces[s].reshape(shape)
    return out


def migrate_legacy_covariant(flat: Mapping[str, np.ndarray],
                             template: Mapping[str, Any]
                             ) -> Dict[str, np.ndarray]:
    """A round-1 covariant checkpoint as a flat tree -> the packed layout,
    the counterpart of molgym_tpu/tools/model_io.py::migrate_legacy_covariant.
    `template` is the port's agent's state_dict (or its shapes): a packed
    leaf `<module>.ag_mix.w_r_l0_s0` has the Flax shape [pairs, tau,
    tau_out]. Every legacy group is migrated where it stands, in the params
    (under 'params/') and in the optimizer's moments that mirror them
    ('opt_state/.../mu/params/...'), so a full checkpoint migrates in one
    call; every other leaf is kept as it is."""
    shapes = {k: tuple(v.shape) if hasattr(v, 'shape') else tuple(v)
              for k, v in template.items()}
    out, parents = {}, set()
    for key, value in flat.items():
        parent = _legacy_parent(key)
        if parent is None:
            out[key] = value
        else:
            parents.add(parent)
    for parent in sorted(parents):
        # the module's path inside the Flax 'params' collection, dotted as
        # the port's state_dict names it
        parts = parent.split('/')
        module = '.'.join(parts[len(parts) - parts[::-1].index('params'):])
        for kind in ('ag_mix', 'cat_mix'):
            prefix = f'{module}.{kind}.' if module else f'{kind}.'
            packed = {k[len(prefix):]: v for k, v in shapes.items()
                      if k.startswith(prefix) and _PACKED_W.fullmatch(
                          k[len(prefix):])}
            if not packed:
                raise KeyError(f'the model has no packed {prefix}* for the '
                               f'legacy weights of {parent}')
            for name, w in _migrate_packed_mix(kind, flat, parent,
                                               packed).items():
                out[f'{parent}/{kind}/{name}'] = w
    return out


def _sha256(path: str) -> str:
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()


def find_archive(model_dir: str) -> str:
    """The portable archive of the JAX checkpoint directory `model_dir`:
    the one of its name under ARCHIVE_DIR whose recorded sha256 match the
    directory's _METADATA and manifest.ocdbt. FileNotFoundError when no
    archive has its name, ValueError when none has its hashes."""
    name = os.path.basename(os.path.normpath(model_dir))
    stem = name[:-len(ModelIO._suffix)]
    candidates = sorted(glob.glob(os.path.join(ARCHIVE_DIR, '*',
                                               stem + '.npz')))
    if not candidates:
        raise FileNotFoundError(
            f'{model_dir} is a JAX (orbax) checkpoint with no portable '
            f'archive under {ARCHIVE_DIR}. Export it where JAX is installed, '
            f'from the repository\'s root: {EXPORT_COMMAND} '
            '(add --opt_state to resume training from it)')
    hashes = {f: _sha256(os.path.join(model_dir, f)) for f in HASHED_FILES}
    for path in candidates:
        if read_archive_metadata(path)['sha256'] == hashes:
            return path
    raise ValueError(f'{model_dir}: its {" and ".join(HASHED_FILES)} match '
                     f'no archive of its name ({", ".join(candidates)}): '
                     f'the checkpoint changed since it was exported; export '
                     f'it again ({EXPORT_COMMAND})')


def read_archive_metadata(path: str) -> dict:
    with np.load(path, allow_pickle=False) as archive:
        return json.loads(str(archive[METADATA_KEY]))


def read_archive(path: str) -> Dict[str, np.ndarray]:
    """A portable archive's leaves, '/'-joined keys to numpy arrays; a
    bfloat16 leaf (stored as its bits in uint16) as the float32 of the same
    value."""
    with np.load(path, allow_pickle=False) as archive:
        metadata = json.loads(str(archive[METADATA_KEY]))
        flat = {k: archive[k] for k in archive.files if k != METADATA_KEY}
    for key in metadata['bfloat16']:
        flat[key] = (flat[key].astype(np.uint32) << 16).view(np.float32)
    return flat


@dataclass
class ModelPathInfo:
    path: str
    tag: str
    num_steps: int


class ModelIO:
    _steps_string = '_steps-'
    _suffix = '.model'

    def __init__(self, directory: str, tag: str, keep: bool = False) -> None:
        self.directory = os.path.abspath(directory)
        self.tag = tag
        self.keep = keep
        self.old_path: Optional[str] = None

    def _get_model_filename(self, num_steps: int) -> str:
        return f'{self.tag}{self._steps_string}{num_steps}{self._suffix}'

    def _parse_model_path(self, path: str) -> Optional[ModelPathInfo]:
        name = os.path.basename(os.path.normpath(path))
        match = re.fullmatch(
            rf'(?P<tag>.+){self._steps_string}(?P<num_steps>\d+){self._suffix}',
            name)
        if not match:
            return None
        return ModelPathInfo(path=path, tag=match.group('tag'),
                             num_steps=int(match.group('num_steps')))

    def _list_checkpoints(self) -> Sequence[ModelPathInfo]:
        if not os.path.isdir(self.directory):
            return []
        infos = [self._parse_model_path(os.path.join(self.directory, name))
                 for name in os.listdir(self.directory)]
        return [info for info in infos if info and info.tag == self.tag]

    def save(self, model: nn.Module, optimizer=None, num_steps: int = 0) -> str:
        if not self.keep and self.old_path and os.path.exists(self.old_path):
            logging.debug(f'Deleting old model: {self.old_path}')
            os.remove(self.old_path)
        path = os.path.join(self.directory, self._get_model_filename(num_steps))
        logging.debug(f'Saving model: {path}')
        state = {'model': model.state_dict(), 'num_steps': num_steps}
        if optimizer is not None:
            state['optimizer'] = optimizer.state_dict()
        torch.save(state, path)
        self.old_path = path
        return path

    def load(self, path: str, map_location=None,
             family: Optional[str] = None,
             template: Optional[Mapping[str, Any]] = None
             ) -> Tuple[dict, int]:
        """Returns ({'model': ..., 'optimizer': ...?, 'num_steps': n}, n),
        tensors on `map_location` (where they were saved by default).

        A file is the port's own checkpoint. A directory is a JAX orbax
        checkpoint, read from its portable archive (find_archive) and
        carried over by convert.checkpoint_from_jax with the map of the
        agent `family` (--model); a round-1 covariant one is migrated
        first, against `template`, the agent's state_dict. Without
        optimizer state in the archive there is no 'optimizer'."""
        info = self._parse_model_path(path)
        if info is None or not os.path.exists(path):
            raise RuntimeError(f"Cannot find model '{path}'")
        if not os.path.isdir(path):
            logging.info(f'Loading model: {info.path}')
            state = torch.load(path, map_location=map_location,
                               weights_only=True)
            return state, info.num_steps
        if family is None:
            raise ValueError(f'{path} is a JAX checkpoint: name its agent '
                             'family (--model) to carry it over')
        archive = find_archive(path)
        logging.info(f'Loading JAX checkpoint: {info.path} from its archive '
                     f'{archive}')
        flat = read_archive(archive)
        if is_legacy_covariant_tree(flat):
            if template is None:
                raise ValueError(f'{path} holds round-1 covariant weights: '
                                 'pass the agent\'s state_dict as template')
            logging.info('Legacy covariant checkpoint detected; migrating to '
                         'the packed parameter layout')
            flat = migrate_legacy_covariant(flat, template)
        state = checkpoint_from_jax(flat, family)
        if map_location is not None:
            state = _to(state, torch.device(map_location))
        state.update(num_steps=info.num_steps, format='JAX')
        return state, info.num_steps

    def load_latest(self, map_location=None, family: Optional[str] = None,
                    template: Optional[Mapping[str, Any]] = None
                    ) -> Tuple[dict, int]:
        """The checkpoint of the most steps in the directory, the port's
        file or a JAX directory (see load)."""
        infos = self._list_checkpoints()
        if not infos:
            raise RuntimeError(f"Cannot find model to load in '{self.directory}'")
        latest = max(infos, key=lambda info: info.num_steps)
        return self.load(latest.path, map_location=map_location,
                         family=family, template=template)


def _to(obj, device):
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    return obj.to(device) if isinstance(obj, torch.Tensor) else obj
