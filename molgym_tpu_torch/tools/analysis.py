"""Offline analysis of a run's artifacts (the port's own copy of
molgym_tpu/tools/analysis.py): artifact discovery, JSON-lines metric
loading and the per-seed aggregation of learning curves.

Artifact names follow one grammar,
`{name}_run-{seed}[_steps-{n}][_rank-{r}]_{mode}.{ext}`, which the port's
savers write (tools/util.py) as the JAX package's do. pandas is imported
inside `load_metrics` only: the card's machine has none.
"""
from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass
from typing import Iterator, List, Optional

# one grammar for every run artifact; steps/rank are optional segments
_ARTIFACT = re.compile(
    r'^(?P<name>.+?)_run-(?P<seed>\d+)'
    r'(?:_steps-(?P<steps>\d+))?'
    r'(?:_rank-(?P<rank>\d+))?'
    r'_(?P<mode>[^_.]+)\.(?P<ext>txt|pkl|model)$')


@dataclass(frozen=True)
class RunArtifact:
    """A parsed results/data/model file belonging to one run."""
    path: str
    name: str
    seed: int
    mode: str
    ext: str
    steps: Optional[int] = None
    rank: int = 0

    @property
    def tag(self) -> str:
        return f'{self.name}_run-{self.seed}'


def parse_artifact(path: str) -> RunArtifact:
    match = _ARTIFACT.match(os.path.basename(path))
    if match is None:
        raise ValueError(f'not a run artifact name: {path!r}')
    g = match.groupdict()
    return RunArtifact(path=path, name=g['name'], seed=int(g['seed']),
                       mode=g['mode'], ext=g['ext'],
                       steps=int(g['steps']) if g['steps'] else None,
                       rank=int(g['rank']) if g['rank'] else 0)


def iter_artifacts(directory: str, mode: Optional[str] = None,
                   ext: Optional[str] = None) -> Iterator[RunArtifact]:
    """Yield parsed artifacts under `directory`, optionally filtered by
    metric stream (train/eval/opt) and extension; unparseable files skip."""
    for path in sorted(glob.glob(os.path.join(directory, '*'))):
        try:
            art = parse_artifact(path)
        except ValueError:
            continue
        if mode is not None and art.mode != mode:
            continue
        if ext is not None and art.ext != ext:
            continue
        yield art


def read_jsonl(path: str) -> List[dict]:
    """All records of a JSON-lines metric stream."""
    with open(path) as handle:
        return [json.loads(line) for line in handle if line.strip()]


def load_metrics(directory: str, mode: str):
    """One pandas frame of all `{mode}` metric rows in `directory`, annotated
    with the run's name/seed/rank columns."""
    import pandas as pd

    frames = []
    for art in iter_artifacts(directory, mode=mode, ext='txt'):
        frame = pd.DataFrame(read_jsonl(art.path))
        frame['name'] = art.name
        frame['seed'] = art.seed
        frame['rank'] = art.rank
        frames.append(frame)
    if not frames:
        raise RuntimeError(f'no *_{mode}.txt metric streams in {directory!r}')
    return pd.concat(frames, ignore_index=True)


def aggregate_over_seeds(metrics, column: str = 'return_mean',
                         x: str = 'total_num_steps'):
    """mean and std of `column` over seeds, per (experiment name, x): the
    learning-curve statistic."""
    grouped = metrics.groupby(['name', x])[column].agg(['mean', 'std'])
    return grouped.reset_index()


# -- the per-filetype helpers of the older API ----------------------------------

def parse_json_lines_file(path: str) -> List[dict]:
    return read_jsonl(path)


def parse_buffer_filename(filename: str) -> dict:
    try:
        art = parse_artifact(filename)
    except ValueError as exc:
        raise RuntimeError(f'Cannot parse filename: {filename}') from exc
    if art.steps is None:
        raise RuntimeError(f'Cannot parse filename: {filename}')
    return {'name': art.name, 'seed': art.seed, 'steps': art.steps,
            'rank': art.rank, 'mode': art.mode}


def parse_results_filename(filename: str) -> dict:
    try:
        art = parse_artifact(filename)
    except ValueError as exc:
        raise RuntimeError(f'Cannot parse filename: {filename}') from exc
    return {'name': art.name, 'seed': art.seed, 'mode': art.mode}


def collect_results_paths(directory: str, mode: str) -> List[str]:
    return [a.path for a in iter_artifacts(directory, mode=mode, ext='txt')]


def collect_buffer_paths(directory: str, mode: str) -> List[str]:
    return [a.path for a in iter_artifacts(directory, mode=mode, ext='pkl')]
