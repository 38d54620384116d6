"""The harness on the CPU: cells found by name in files of their own, the
result line's keys, the check for JAX, and the benchmark's weights."""
import json
import sys
from pathlib import Path

import pytest
import torch

import run
from conftest import cells_of
from harness import cell as cells_mod
from harness import weights

CONTRACT = ['correct', 'attempted', 'failed', 'metrics', 'device']


def test_new_cell_from_new_files(tiny_root, tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric added as
    new files, and entries in BENCHMARK.json, are found with no file of the
    harness edited."""
    root = tmp_path
    bench = root / 'benchmark'
    for sub in ('configs', 'traffic', 'limits', 'metrics'):
        (bench / sub).mkdir(parents=True)
    spec = json.loads((tiny_root / 'BENCHMARK.json').read_text())
    (bench / 'configs/new_cfg.json').write_text(json.dumps({'maxl': 1}))
    (bench / 'traffic/new_mix.json').write_text(json.dumps({'loop': 'sample'}))
    (bench / 'limits/new_cfg.new_mix.json').write_text(json.dumps({'logp_gap': 1}))
    (bench / 'metrics/new_metric.py').write_text(
        'def read(ctx):\n    return 42.0 if ctx["window"] else None\n')
    spec['configs'].append(dict(name='new_cfg', source='x', reduced=[], why='x',
                                file='benchmark/configs/new_cfg.json'))
    spec['workloads'].append(dict(name='new_cfg.new_mix', config='new_cfg',
                                  traffic='new_mix', chips=1, why='x'))
    spec['per_layer'].append(dict(name='new_metric', unit='count', better='lower',
                                  source='program_counter', layer='Policy',
                                  moves='sampled_env_steps_per_s',
                                  workloads=['new_cfg.new_mix']))
    [rate] = [m for m in spec['end_to_end'] if m['name'] == 'sampled_env_steps_per_s']
    rate['workloads'].append('new_cfg.new_mix')
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    c = cells_mod.load(root, 'new_cfg.new_mix', bench)
    assert c.config == {'maxl': 1} and c.traffic == {'loop': 'sample'}
    assert c.limits == {'logp_gap': 1}
    assert [m['name'] for m in c.per_layer] == ['new_metric']
    assert {m['name'] for m in c.end_to_end} == {
        'sampled_env_steps_per_s', 'peak_mem_gib', 'setup_s'}
    assert cells_mod.reader('new_metric', bench)({'window': {'steps': 1}}) == 42.0


def test_every_cell_has_its_files(cells):
    bench = Path(run.BENCH_DIR)
    for name in cells:
        c = cells_mod.load(bench.parent, name)
        assert c.limits and c.end_to_end and c.per_layer
        for m in c.per_layer:
            assert callable(cells_mod.reader(m['name']))


@pytest.mark.parametrize('traced', [False, True])
def test_result_line_keys(tiny_root, traced):
    """The line's keys are the contract's, `compared` last; a traced run
    adds the device's busy and window seconds and the breakdown."""
    out, notes = run.run_cell(tiny_root, f'tiny.{cells_of("sample")[0]}', 2 ** 40 + 7,
                              0.2, traced, torch.device('cpu'),
                              bench_dir=tiny_root / 'benchmark')
    keys = CONTRACT + (['breakdown'] if traced else []) + ['compared']
    assert list(out) == keys
    assert out['correct'] is True and out['failed'] == 0
    device = ['platform', 'kind', 'count', 'memory_peak_bytes']
    assert list(out['device']) == device + (['busy_s', 'window_s'] if traced else [])
    json.dumps(out)
    if not traced:
        assert set(out['metrics']) == {'sampled_env_steps_per_s', 'peak_mem_gib',
                                       'setup_s'}
    for v in out['compared'].values():
        assert set(v) == {'value', 'limit'}
    assert notes['judged_steps'] > 0


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ('molgym_tpu_torch', 'molgym_tpu_torch.ops', 'jaxtyping',
                 'flax_like'):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, 'molgym_tpu.ops.cg', object())
    monkeypatch.setitem(sys.modules, 'jaxlib', object())
    assert run.loaded_forbidden() == ['jaxlib', 'molgym_tpu']


def test_weights_from_the_seed():
    shapes = {'a.weight': torch.Size([4, 3]), 'a.bias': torch.Size([4]),
              'm.w_r_l0_s0': torch.Size([1, 2, 2]), 'm.w_i_l0_s0': torch.Size([1, 2, 2]),
              'inv_norm.weight': torch.Size([3])}
    a = weights.make(shapes, 2 ** 33 + 1, 'cpu')
    b = weights.make(shapes, 2 ** 33 + 1, 'cpu')
    c = weights.make(shapes, 2 ** 33 + 2, 'cpu')
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a['a.weight'], c['a.weight'])
    assert torch.equal(a['a.bias'], torch.zeros(4))
    assert torch.equal(a['inv_norm.weight'], torch.ones(3))
