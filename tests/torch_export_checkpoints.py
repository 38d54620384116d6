"""Export a JAX orbax checkpoint of experiments/ to the portable archive the
port reads (molgym_tpu_torch/tools/model_io.py) on a machine without JAX.

    python -m tests.torch_export_checkpoints <model dir> [<model dir> ...] \\
        [--opt_state]

Run from the repository's root where JAX and orbax are installed. Each
`experiments/<experiment>/models/<tag>_steps-<n>.model` becomes
`molgym_tpu_torch/checkpoints/<experiment>/<tag>_steps-<n>.npz`: the
checkpoint restored without a template (molgym_tpu's
ModelIO._restore_raw), flattened to '/'-joined keys (a restored sequence
becomes a node keyed '0', '1', ...), written by np.savez_compressed, no
pickled object. Only the params are kept unless --opt_state is given. Every
leaf keeps its dtype; a bfloat16 leaf, which numpy lacks, is stored as its
raw bits in uint16 and named in the metadata. The metadata entry holds the
source path relative to the repository, the tag, the steps, the run's
recorded configuration (logs/<tag>.json), the sha256 of the checkpoint's
_METADATA and manifest.ocdbt, the bfloat16 leaves and the keys of empty
(None) nodes.

A helper, not a test: it imports molgym_tpu, and no module of the port
imports it. tests/test_torch_jax_checkpoints.py holds every committed
archive equal to its checkpoint.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

from molgym_tpu_torch.tools.model_io import (ARCHIVE_DIR, HASHED_FILES,
                                             METADATA_KEY)

ROOT = Path(__file__).resolve().parents[1]
ARCHIVES = Path(ARCHIVE_DIR)
_NAME = re.compile(r'(?P<tag>.+)_steps-(?P<steps>\d+)\.model')


def flatten(tree: Any, prefix: str = '') -> Tuple[Dict[str, np.ndarray],
                                                  List[str]]:
    """A raw restore -> ({'a/b/c': leaf}, [keys of None nodes])."""
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    elif tree is None:
        return {}, [prefix]
    else:
        return {prefix: np.asarray(tree)}, []
    leaves, nones = {}, []
    for key, value in items:
        sub_leaves, sub_nones = flatten(value, f'{prefix}/{key}' if prefix
                                        else key)
        leaves.update(sub_leaves)
        nones += sub_nones
    return leaves, nones


def sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def restore_raw(model_dir: Path) -> Any:
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from molgym_tpu.tools.model_io import ModelIO
    return ModelIO(str(model_dir.parent), 'unused')._restore_raw(
        str(model_dir))


def archive_of(model_dir: Path, opt_state: bool) -> Tuple[Path, dict]:
    """(archive path, {npz key: array}) of a checkpoint directory."""
    model_dir = model_dir.resolve()
    match = _NAME.fullmatch(model_dir.name)
    if match is None or model_dir.parent.name != 'models':
        raise ValueError(f'{model_dir}: expected experiments/<experiment>/'
                         'models/<tag>_steps-<n>.model')
    experiment_dir = model_dir.parent.parent
    tag = match.group('tag')
    raw = restore_raw(model_dir)
    if not opt_state:
        raw = {'params': raw['params']}
    leaves, nones = flatten(raw)
    bf16 = sorted(k for k, v in leaves.items() if v.dtype.name == 'bfloat16')
    arrays = {k: (v.view(np.uint16) if k in bf16 else v)
              for k, v in leaves.items()}
    config_path = experiment_dir / 'logs' / f'{tag}.json'
    metadata = dict(
        source=str(model_dir.relative_to(ROOT)), tag=tag,
        steps=int(match.group('steps')),
        config=json.loads(config_path.read_text()),
        sha256={name: sha256(model_dir / name) for name in HASHED_FILES},
        bfloat16=bf16, none=nones)
    arrays[METADATA_KEY] = np.array(json.dumps(metadata, sort_keys=True))
    path = ARCHIVES / experiment_dir.name / f'{model_dir.stem}.npz'
    return path, arrays


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('model_dirs', nargs='+', type=Path)
    parser.add_argument('--opt_state', action='store_true',
                        help='keep the optimizer state beside the params')
    args = parser.parse_args(argv)
    for model_dir in args.model_dirs:
        path, arrays = archive_of(model_dir, args.opt_state)
        os.makedirs(path.parent, exist_ok=True)
        np.savez_compressed(path, **arrays)
        print(f'{path.relative_to(ROOT)}: {len(arrays) - 1} leaves, '
              f'{path.stat().st_size} bytes')
    return 0


if __name__ == '__main__':
    sys.exit(main())
