"""molgym_tpu_torch/tools/recorded_run.py on the four recorded runs with a
device reward (sf6_bf16, organics, solvation and scaffold): the scaffold
record, which kept no log JSON, resolves from the port's table UNLOGGED,
which must equal the command of experiments/scaffold/README.md flag for
flag; each record resolves to its driver with its assets absolute; and
each resolved command, cut to a tiny width and two iterations on the CPU,
trains and writes its records and a model; sf6_bf16's so cut also
through tests/torch_full_run_w2.py, two gloo ranks; and chip_smoke.py's
phase 17 (run_recorded) expects the counters of each record's agent and
rehearses on the CPU at a tiny width. The file reads experiments/ and
writes only under pytest's tmp_path and temporary directories."""
import json
import math
import shlex
from pathlib import Path

import pytest
import torch

from molgym_tpu_torch.tools import recorded_run
from tests import torch_full_run_w2

EXPERIMENTS = Path(__file__).resolve().parents[1] / 'experiments'

# record (a log JSON, or the experiment directory UNLOGGED names) -> (the
# port's driver, the asset option and its file, the run's tag)
RECORDS = {
    'sf6_bf16/logs/sf6bf16_run-1.json': ('run', None, 'sf6bf16_run-1'),
    'organics/logs/organics_run-1.json': ('run', None, 'organics_run-1'),
    'solvation/logs/solv_run-1.json': (
        'run_solvation', ('initial_structure', 'solute.xyz'), 'solv_run-1'),
    'scaffold': ('run_scaffold', ('scaffold', 'cube.xyz'), 'scaffold_run-1'),
}

# a tiny width and 8 samples an iteration on the CPU; --num_steps=16 and
# the log level are added where the test trains two iterations itself
TINY = ['--num_envs=2', '--num_steps_per_iter=8', '--mini_batch_size=8',
        '--device=cpu']
TINY_MODEL = {
    'covariant': ['--maxl=2', '--num_cg_levels=2', '--network_width=16',
                  '--num_channels_hidden=3', '--num_channels_per_element=2',
                  '--num_gaussians=2'],
    'internal': ['--network_width=16', '--num_interactions=2'],
}


def tiny_flags(module, argv):
    """TINY and the tiny width of the model that the record's flags name."""
    model = vars(recorded_run.parser_of(module).parse_args(argv))['model']
    return TINY + TINY_MODEL[model]


def readme_command(readme: Path):
    """The `python scripts/<script> ...` command under "Reproduce:" in an
    experiment's README, its lines joined: (script name, its flags)."""
    text = readme.read_text().split('Reproduce:', 1)[1]
    lines, command = text.splitlines(), []
    start = next(i for i, line in enumerate(lines)
                 if line.strip().startswith('python '))
    for line in lines[start:]:
        command.append(line.strip().rstrip('\\').strip())
        if not line.rstrip().endswith('\\'):
            break
    words = shlex.split(' '.join(command))
    assert words[0] == 'python' and words[1].startswith('scripts/')
    return Path(words[1]).name, tuple(words[2:])


def test_scaffold_table_is_the_readme_command():
    assert recorded_run.UNLOGGED['scaffold'] == readme_command(
        EXPERIMENTS / 'scaffold' / 'README.md')
    # the record has no log JSON of its own
    assert not (EXPERIMENTS / 'scaffold' / 'logs').exists()


@pytest.mark.parametrize('record', list(RECORDS))
def test_dry_run_resolves_the_driver(record, monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)   # assets found from the experiment
    driver, asset, tag = RECORDS[record]
    path = EXPERIMENTS / record
    command = recorded_run.main([str(path), '--seed=2', '--dry_run'])
    assert capsys.readouterr().err.strip() == command
    words = command.split()
    assert words[:3] == ['python3', '-m', 'molgym_tpu_torch.' + driver]
    assert words[-1] == '--seed=2'
    module, argv = recorded_run.recorded_argv(str(path))
    config = vars(recorded_run.parser_of(module).parse_args(argv))
    if asset is not None:
        option, name = asset
        given = Path(config[option])
        assert given.is_absolute() and given.exists()
        assert given == EXPERIMENTS / Path(record).parts[0] / name
        assert f'--{option}={given}' in words
    assert config['reward'] == 'device_lj'
    assert f'{config["name"]}_run-{config["seed"]}' == tag
    assert config['device'] == 'cuda'
    if record == 'scaffold':
        # the README's values, the JAX parser's defaults elsewhere
        assert (config['max_num_steps'], config['num_steps_per_iter'],
                config['num_envs'], config['mini_batch_size'],
                config['model'], config['save_rollouts']) == (
                    6144, 256, 8, 128, 'internal', 'eval')
    else:
        recorded = json.loads(path.read_text())
        assert config['max_num_steps'] == recorded['max_num_steps']
        assert config['model'] == recorded['model']
    if record.startswith('sf6_bf16'):
        assert config['encoder_dtype'] == 'bfloat16'


def test_an_unlogged_flag_the_driver_lacks_raises(monkeypatch, tmp_path):
    script, flags = recorded_run.UNLOGGED['scaffold']
    monkeypatch.setitem(recorded_run.UNLOGGED, 'scaffold',
                        (script, flags + ('--not_an_option=1', )))
    with pytest.raises(ValueError, match='--not_an_option'):
        recorded_run.recorded_argv(str(EXPERIMENTS / 'scaffold'))


def tiny_argv(record, tmp_path):
    """The record, then the flags that cut it to a tiny width and two
    iterations on the CPU, writing under tmp_path."""
    flags = tiny_flags(*recorded_run.recorded_argv(str(EXPERIMENTS / record)))
    return ([str(EXPERIMENTS / record)] + flags
            + ['--num_steps=16', '--log_level=WARNING']
            + [f'--{d}_dir={tmp_path / d}'
               for d in ('log', 'model', 'data', 'results')])


def check_written(tmp_path, tag):
    """Two training and two update records, evaluations with finite
    returns, and a model at the last step; returns the logged config."""
    def lines(mode):
        with open(tmp_path / 'results' / f'{tag}_{mode}.txt') as f:
            return [json.loads(line) for line in f]
    assert len(lines('train')) == len(lines('opt')) == 2
    evals = lines('eval')
    assert evals and all(math.isfinite(r['return_mean']) for r in evals)
    assert [r['total_num_steps'] for r in lines('train')] == [0, 8]
    assert any(p.name.startswith(f'{tag}_steps-16')
               for p in (tmp_path / 'model').iterdir())
    config = json.loads((tmp_path / 'log' / f'{tag}.json').read_text())
    assert config['device'] == 'cpu'
    return config


@pytest.mark.parametrize('record', list(RECORDS))
def test_tiny_cpu_run_writes_its_records(record, tmp_path):
    """The resolved command at a tiny width, two iterations of 8 samples,
    on the CPU, writes its records and a model."""
    recorded_run.main(tiny_argv(record, tmp_path))
    check_written(tmp_path, RECORDS[record][2])


def test_w2_helper_trains_the_bf16_record(tmp_path):
    """tests/torch_full_run_w2.py: sf6_bf16's record cut as above, trained
    by two gloo ranks on the CPU; rank 0 writes, and the logged config
    names the two ranks."""
    record = 'sf6_bf16/logs/sf6bf16_run-1.json'
    ranks = torch_full_run_w2.main(tiny_argv(record, tmp_path))
    assert ranks == [dict(rank=r, world_size=2, backend='gloo', device='cpu')
                     for r in (0, 1)]
    config = check_written(tmp_path, RECORDS[record][2])
    assert config['num_devices'] == 2
    assert config['encoder_dtype'] == 'bfloat16'


def test_w2_helper_takes_run_records_only():
    with pytest.raises(ValueError, match='run_scaffold'):
        torch_full_run_w2.main([str(EXPERIMENTS / 'scaffold'),
                                '--device=cpu'])


def tiny_recorded_argv(monkeypatch):
    """recorded_run.recorded_argv wrapped to cut every record to the tiny
    width (chip_smoke.py's phase 17 adds its own --num_steps)."""
    resolve = recorded_run.recorded_argv

    def tiny(record):
        module, argv = resolve(record)
        return module, argv + tiny_flags(module, argv)
    monkeypatch.setattr(recorded_run, 'recorded_argv', tiny)


@pytest.mark.parametrize('name', ['sf6_bf16', 'organics', 'solvation',
                                  'scaffold'])
def test_phase17_expects_the_counters_of_its_agent(name, monkeypatch):
    """chip_smoke.py's RECORDED_KERNELS[name] is exactly the set of
    counters that a forward and a gradient pass of the record's agent
    move (per_forward_launches, expected_launches)."""
    import chip_smoke
    from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
    from molgym_tpu_torch.tools.model_util import build_model
    tiny_recorded_argv(monkeypatch)
    module, argv = recorded_run.recorded_argv(chip_smoke.RECORDED[name])
    config = vars(recorded_run.parser_of(module).parse_args(argv))
    space = ObservationSpace(config['canvas_size'],
                             symbols_to_zs(config['symbols']))
    agent = build_model(config, space, device='cpu')
    counts = chip_smoke.expected_launches(
        chip_smoke.per_forward_launches(agent, config['encoder_dtype']),
        forwards=1, passes=1)
    assert sorted(k for k, n in counts.items() if n) == sorted(
        chip_smoke.RECORDED_KERNELS[name])


def test_phase17_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.run_recorded on the CPU with the records cut to a tiny
    width: each command trains RECORDED_ITERATIONS iterations through its
    driver with run_training's checks (the counts are checked on the card
    only)."""
    import chip_smoke
    tiny_recorded_argv(monkeypatch)
    out = chip_smoke.run_recorded(torch.device('cpu'))
    assert {n: r['module'] for n, r in out.items()} == dict(
        sf6_bf16='molgym_tpu_torch.run', organics='molgym_tpu_torch.run',
        solvation='molgym_tpu_torch.run_solvation',
        scaffold='molgym_tpu_torch.run_scaffold')
    for r in out.values():
        assert len(r['iteration_ms']) == chip_smoke.RECORDED_ITERATIONS
        assert r['transports'] == ['in_step'] * chip_smoke.RECORDED_ITERATIONS
        assert not any(r['counts'].values())   # plain versions on the CPU
