"""The benchmark's CPU tests: the harness and the reference on tiny copies
of the cells, made in a temporary checkout (`tiny_root`)."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

# each cell's configuration at a size the CPU runs in seconds; every other
# flag as recorded
TINY_CONFIG = dict(maxl=2, num_cg_levels=2, num_channels_hidden=3,
                   num_channels_per_element=2, network_width=16)
TINY_TRAFFIC = dict(train=dict(num_envs=4, steps_per_env=3, mini_batch_size=12),
                    sample=dict(num_envs=6, steps_per_env=3))
TINY_CHECK_ITERATIONS = 2


def make_tiny_root(tmp: Path) -> Path:
    """A checkout holding BENCHMARK.json and benchmark/ with a tiny cell
    `tiny.<cell>` beside each cell, with the cell's own limits."""
    shutil.copytree(BENCH, tmp / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    spec = json.loads((BENCH.parent / 'BENCHMARK.json').read_text())
    configs = {c['name']: c for c in spec['configs']}
    for w in list(spec['workloads']):
        name = f"tiny.{w['name']}"
        config = json.loads((BENCH.parent / configs[w['config']]['file']).read_text())
        config.update(TINY_CONFIG)
        (tmp / 'benchmark/configs' / f"tiny_{w['config']}.json").write_text(
            json.dumps(config))
        traffic = json.loads((BENCH / 'traffic' / f"{w['traffic']}.json").read_text())
        traffic.update(TINY_TRAFFIC[traffic['loop']])
        (tmp / 'benchmark/traffic' / f"tiny_{w['traffic']}.json").write_text(
            json.dumps(traffic))
        shutil.copy(BENCH / 'limits' / f"{w['name']}.json",
                    tmp / 'benchmark/limits' / f'{name}.json')
        if f"tiny_{w['config']}" not in configs:
            configs[f"tiny_{w['config']}"] = dict(
                name=f"tiny_{w['config']}", source='tiny', reduced=[], why='tiny',
                file=f"benchmark/configs/tiny_{w['config']}.json")
        spec['workloads'].append(dict(w, name=name, config=f"tiny_{w['config']}",
                                      traffic=f"tiny_{w['traffic']}"))
        for m in spec['end_to_end'] + spec['per_layer']:
            if w['name'] in m.get('workloads', ()):
                m['workloads'].append(name)
    spec['configs'] = list(configs.values())
    (tmp / 'BENCHMARK.json').write_text(json.dumps(spec))
    return tmp


@pytest.fixture(scope='session')
def _tiny_checkout(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp('checkout'))


@pytest.fixture
def tiny_root(_tiny_checkout, monkeypatch) -> Path:
    """The tiny checkout, with set-up running fewer check iterations."""
    from harness import loops
    monkeypatch.setattr(loops, 'CHECK_ITERATIONS', TINY_CHECK_ITERATIONS)
    return _tiny_checkout


def cells_of(loop: str = None):
    """BENCHMARK.json's cells, or those whose traffic runs `loop`."""
    spec = json.loads((BENCH.parent / 'BENCHMARK.json').read_text())
    return [w['name'] for w in spec['workloads'] if loop is None or json.loads(
        (BENCH / 'traffic' / f"{w['traffic']}.json").read_text())['loop'] == loop]


@pytest.fixture(scope='session')
def cells():
    return cells_of()
