"""tests/torch_jax_seeds.py, the JAX arm of curve_summary.settle_by_reference:
its command for each family is the port's recorded command
(tools/recorded_run.py) with --device=cpu, and the record's configuration
key for key under the JAX driver's parser; its conversion of a JAX
checkpoint into a port checkpoint file gives the committed solv_run-1
archive's state dict bit for bit; its `compare` and `table` steps read the
committed records. Writes only under pytest's tmp_path."""
import json
from pathlib import Path

import pytest
import torch

import scripts.run_scaffold as jax_run_scaffold
import scripts.run_solvation as jax_run_solvation
from molgym_tpu_torch.tools import recorded_run
from molgym_tpu_torch.tools.model_io import ModelIO
from tests import torch_jax_seeds

ROOT = Path(__file__).resolve().parents[1]
SOLVATION = ROOT / 'experiments' / 'solvation'
PARSERS = {'solvation': jax_run_solvation.build_parser,
           'scaffold': jax_run_scaffold.build_parser}
# the keys the records predate, which the JAX driver fills by its defaults
NEWER = {'agg_backend', 'encoder_dtype', 'eval_sample_k', 'host_reward_mode'}


def _jax_config(family, seed):
    command = torch_jax_seeds.jax_command(family, seed)
    assert command[1] == str(ROOT / torch_jax_seeds.RECORDS[family][1])
    return vars(PARSERS[family]().parse_args(command[2:]))


@pytest.mark.parametrize('family,record', [
    ('solvation', 'experiments/solvation/logs/solv_run-1.json'),
    ('scaffold', 'experiments/scaffold')])
def test_jax_command_is_the_ports(family, record, monkeypatch):
    """The helper's flags are those that recorded_run runs the port with
    for the seed, and --device=cpu."""
    monkeypatch.chdir(ROOT)
    port = recorded_run.main([record, '--seed=7', '--dry_run']).split()
    jax = torch_jax_seeds.jax_command(family, 7)
    assert port[:3] == ['python3', '-m', f'molgym_tpu_torch.run_{family}']
    assert jax[2:] == port[3:] + ['--device=cpu']
    assert torch_jax_seeds.tag_of(family, 7) == (
        'solv_run-7' if family == 'solvation' else 'scaffold_run-7')


def test_solvation_command_is_the_record_key_for_key():
    """Parsed by scripts/run_solvation.py's parser, the command gives the
    log JSON's configuration: every recorded key (num_eval_episodes 1,
    where the driver's default is None) but the directories, device and
    seed; the keys the record predates at their defaults."""
    config = _jax_config('solvation', 5)
    record = json.loads((SOLVATION / 'logs' / 'solv_run-1.json').read_text())
    parser = PARSERS['solvation']()
    assert set(config) - set(record) == NEWER
    assert all(config[k] == parser.get_default(k) for k in NEWER)
    for key, value in record.items():
        if key in recorded_run.LEFT_OUT or key == 'seed':
            continue
        if key == 'initial_structure':
            assert config[key] == str(SOLVATION / value)
            continue
        assert config[key] == value, key
    assert config['seed'] == 5 and config['device'] == 'cpu'
    assert config['num_eval_episodes'] == 1
    assert parser.get_default('num_eval_episodes') is None


def test_scaffold_command_is_the_readme_key_for_key():
    """Parsed by scripts/run_scaffold.py's parser, the command gives what
    experiments/scaffold/README.md's command gives, but the seed, the
    device and the scaffold's absolute path."""
    config = _jax_config('scaffold', 5)
    _script, flags = recorded_run.UNLOGGED['scaffold']
    readme = vars(PARSERS['scaffold']().parse_args(list(flags)))
    differ = {k for k in config if config[k] != readme[k]}
    assert differ == {'seed', 'device', 'scaffold'}
    assert (config['seed'], readme['seed']) == (5, 1)
    assert config['device'] == 'cpu'
    assert config['scaffold'] == str(ROOT / 'experiments' / 'scaffold' /
                                     readme['scaffold'])


def test_conversion_is_the_archive_bit_for_bit(tmp_path):
    """The JAX checkpoint of solv_run-1, through the helper's route
    (restore, checkpoint_from_jax, load_state_dict, the port's
    ModelIO.save), reads back as the committed archive's state dict; the
    run's configuration lies beside it, where diagnose_greedy reads it."""
    model_dir = SOLVATION / 'models' / 'solv_run-1_steps-7000.model'
    path = torch_jax_seeds.convert_run(
        model_dir, SOLVATION / 'logs' / 'solv_run-1.json', tmp_path)
    assert path == tmp_path / 'models' / 'solv_run-1_steps-7000.model'
    state, steps = ModelIO(str(tmp_path / 'models'), 'unused').load(
        str(path), 'cpu')
    archive, archive_steps = ModelIO(str(model_dir.parent), 'unused').load(
        str(model_dir), 'cpu', family='internal')
    assert steps == archive_steps == 7000
    assert state['model'].keys() == archive['model'].keys()
    for key, value in archive['model'].items():
        assert state['model'][key].dtype == value.dtype, key
        assert torch.equal(state['model'][key], value), key
    assert json.loads((tmp_path / 'logs' / 'solv_run-1.json').read_text()) \
        == json.loads((SOLVATION / 'logs' / 'solv_run-1.json').read_text())


@pytest.mark.parametrize('text,seeds', [('3-20', list(range(3, 21))),
                                        ('3,5,7', [3, 5, 7]),
                                        ('28-30,41', [28, 29, 30, 41])])
def test_seed_list(text, seeds):
    assert torch_jax_seeds.seed_list(text) == seeds


def test_against_record_reads_a_record_as_itself(tmp_path):
    """`compare`'s numbers: a committed scaffold record against itself is
    0 on every key both lines hold, and a run one line short is refused."""
    results = ROOT / 'experiments' / 'scaffold' / 'results'
    diff = torch_jax_seeds.against_record('scaffold', results,
                                          'scaffold_run-1')
    assert set(diff) == {'train', 'eval'}
    assert {'return_mean', 'value_mean', 'logp_mean'} <= set(diff['train'])
    assert all(v == 0.0 for mode in diff.values() for v in mode.values())
    for mode in ('train', 'eval'):
        lines = (results / f'scaffold_run-1_{mode}.txt').read_text()
        if mode == 'eval':
            lines = ''.join(lines.splitlines(keepends=True)[:-1])
        (tmp_path / f'scaffold_run-1_{mode}.txt').write_text(lines)
    with pytest.raises(ValueError, match='eval'):
        torch_jax_seeds.against_record('scaffold', tmp_path, 'scaffold_run-1')


def test_table_rows_of_the_committed_records():
    """`table`: one row a seed index, one cell a seed of each arm of each
    record, in the records' order."""
    records = [ROOT / 'molgym_tpu_torch' / 'records' / f'seed_spread_{f}.json'
               for f in ('solvation', 'scaffold')]
    rows = torch_jax_seeds.table_rows(records)
    assert len(rows) == 18
    cells = [c.strip() for c in rows[0].strip('|').split('|')]
    assert [c.split()[0] for c in cells] == ['28', '3', '19', '3']
