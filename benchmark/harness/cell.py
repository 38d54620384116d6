"""A cell of BENCHMARK.json and the files it names: its configuration, its
traffic mix, its limits and its metrics' readers, each found by name, so
that a cell or a metric is added by adding files and entries."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _metrics_of(entries: List[dict], cell: str, moved: set = None) -> List[dict]:
    """The metrics a cell reports: those that list it, or list no cells
    (and then, for a per-layer metric, move an end-to-end metric the cell
    reports)."""
    out = []
    for m in entries:
        if 'workloads' in m:
            if cell in m['workloads']:
                out.append(m)
        elif moved is None or m['moves'] in moved:
            out.append(m)
    return out


def load(root: Path, workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    cells = {w['name']: w for w in spec['workloads']}
    if workload not in cells:
        raise SystemExit(f'no workload {workload!r} in BENCHMARK.json '
                         f'(has {sorted(cells)})')
    w = cells[workload]
    config_file = {c['name']: c['file'] for c in spec['configs']}[w['config']]
    config = json.loads((root / config_file).read_text())
    traffic = json.loads((bench_dir / 'traffic' / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench_dir / 'limits' / f'{workload}.json').read_text())
    e2e = _metrics_of(spec['end_to_end'], workload)
    per_layer = _metrics_of(spec['per_layer'], workload,
                            {m['name'] for m in e2e})
    return Cell(workload, config, traffic, limits, e2e, per_layer)


def reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """The `read(ctx)` of metrics/<name>.py."""
    path = bench_dir / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(f'metric_{name}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
