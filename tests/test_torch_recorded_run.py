"""molgym_tpu_torch/tools/recorded_run.py on the committed JAX records:
each PM6 family's configuration becomes the flags of the port's driver
that its script was, which parse back to the recorded values, its assets
as absolute paths that exist, the record's directories and device left
out, later flags winning; a recorded option the driver lacks raises."""
import json
from pathlib import Path

import pytest

from molgym_tpu_torch.tools import recorded_run

EXPERIMENTS = Path(__file__).resolve().parents[1] / 'experiments'
# experiment -> (its run-1 record, the port's driver)
RECORDS = {
    'qm9_pm6': ('qm9pm6', 'run_qm9'),
    'scaffold_pm6': ('scafpm6', 'run_scaffold'),
    'solvation_pm6': ('solvpm6', 'run_solvation'),
    'stochastic_pm6': ('stochpm6', 'run_stochastic'),
    'halides_pm6': ('halo', 'run'),
    'organics_pm6': ('orgpm6', 'run'),
    'sf6_internal_pm6': ('sf6int_pm6', 'run'),
}


def _record(experiment):
    return EXPERIMENTS / experiment / 'logs' / (
        f'{RECORDS[experiment][0]}_run-1.json')


@pytest.mark.parametrize('experiment', list(RECORDS))
def test_recorded_flags_parse_back(experiment, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)   # assets found from the experiment
    path = _record(experiment)
    module, argv = recorded_run.recorded_argv(str(path))
    assert module == 'molgym_tpu_torch.' + RECORDS[experiment][1]
    config = vars(recorded_run.parser_of(module).parse_args(
        argv + ['--seed=3']))
    record = json.loads(path.read_text())
    assert config['seed'] == 3 and record['seed'] == 1
    assert config['device'] == 'cuda'
    assert config['results_dir'] == 'results'
    for key, value in record.items():
        if key in recorded_run.LEFT_OUT + ('seed', ):
            continue
        if key in recorded_run.ASSETS:
            assert Path(config[key]).is_absolute()
            assert Path(config[key]).exists()
            assert Path(config[key]).name == Path(value).name
        else:
            assert str(config[key]) == str(value), key
    assert config['host_reward_mode'] == 'auto'


def test_dry_run_prints_the_command(capsys):
    command = recorded_run.main([str(_record('halides_pm6')), '--seed=2',
                                 '--dry_run'])
    assert command.startswith('python3 -m molgym_tpu_torch.run ')
    assert command.endswith(' --seed=2')
    assert capsys.readouterr().err.strip() == command


def test_an_option_the_driver_lacks_raises(tmp_path):
    record = json.loads(_record('halides_pm6').read_text())
    path = tmp_path / 'logs' / 'x_run-1.json'
    path.parent.mkdir()
    path.write_text(json.dumps(dict(record, not_an_option=1)))
    with pytest.raises(ValueError, match='not_an_option'):
        recorded_run.recorded_argv(str(path))
