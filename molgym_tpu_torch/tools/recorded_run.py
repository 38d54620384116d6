"""A recorded run again through the port: the flags of a JAX record's
configuration (`experiments/<experiment>/logs/<tag>_run-<n>.json`) for the
port's driver that the record's script was (run_qm9 for a QM9 dataset,
run_stochastic for a size range, run_solvation for an initial structure,
run_scaffold for a scaffold, else run), then any flags given after it,
which win:

    python3 -m molgym_tpu_torch.tools.recorded_run \\
        experiments/qm9_pm6/logs/qm9pm6_run-1.json --seed=2 \\
        --log_dir=out/logs --results_dir=out/results \\
        --model_dir=/tmp/models --data_dir=/tmp/data

A record whose configuration was not logged is named by its experiment's
directory (`experiments/scaffold`), and its command is taken from
UNLOGGED, a copy of the one its README gives.

The record's directories and device are left out (the driver's defaults
hold unless given: directories under the working directory, the card). An
asset (the QM9 sample, the solute, the scaffold) is found by its recorded
path, from the experiment's directory or the working directory, and then
by its name in the experiment's directory, and passed as an absolute
path. `--dry_run` prints the command and runs nothing.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from typing import List, Optional, Sequence, Tuple

ASSETS = ('qm9_dataset', 'initial_structure', 'scaffold')
LEFT_OUT = ('log_dir', 'model_dir', 'data_dir', 'results_dir', 'device')

# experiment directory name -> (its script, the flags its README.md's
# "Reproduce" command gives it), for the records that kept no log JSON
UNLOGGED = {
    'scaffold': ('run_scaffold.py', (
        '--name=scaffold', '--scaffold=cube.xyz', '--formulas=H2O',
        '--bag_scale=3', '--canvas_size=12', '--symbols=X,H,O,Ar',
        '--reward=device_lj', '--num_steps=6144', '--num_steps_per_iter=256',
        '--num_envs=8', '--mini_batch_size=128', '--model=internal',
        '--seed=1', '--save_rollouts=eval')),
}


def driver_of(config: dict) -> str:
    """The port's driver module for a recorded configuration."""
    for key, module in (('qm9_dataset', 'run_qm9'),
                        ('size_range', 'run_stochastic'),
                        ('initial_structure', 'run_solvation'),
                        ('scaffold', 'run_scaffold')):
        if config.get(key):
            return 'molgym_tpu_torch.' + module
    return 'molgym_tpu_torch.run'


def parser_of(module: str) -> argparse.ArgumentParser:
    """The argument parser of a driver module."""
    driver = importlib.import_module(module)
    if hasattr(driver, 'build_parser'):
        return driver.build_parser()
    from molgym_tpu_torch.tools.arg_parser import build_default_argparser
    return build_default_argparser()


def find_asset(path: str, experiment_dir: str) -> str:
    for candidate in (os.path.join(experiment_dir, path), path,
                      os.path.join(experiment_dir, os.path.basename(path))):
        if os.path.exists(candidate):
            return os.path.abspath(candidate)
    raise FileNotFoundError(f'{path}: not found from {experiment_dir} or '
                            'the working directory')


def unlogged_config(experiment_dir: str) -> dict:
    """The configuration of UNLOGGED's command for `experiment_dir`, by
    option name, as a log JSON would give the options it sets. Raises
    ValueError for a flag its driver does not have."""
    script, flags = UNLOGGED[os.path.basename(os.path.normpath(
        experiment_dir))]
    module = 'molgym_tpu_torch.' + os.path.splitext(script)[0]
    actions = {s: a for a in parser_of(module)._actions
               for s in a.option_strings}
    config = {}
    for flag in flags:
        name, given, value = flag.partition('=')
        if name not in actions:
            raise ValueError(f'{experiment_dir}: {module} has no {name}')
        config[actions[name].dest] = value if given else True
    if driver_of(config) != module:
        raise ValueError(f'{experiment_dir}: {script} is not the driver of '
                         'its flags')
    return config


def recorded_argv(record: str) -> Tuple[str, List[str]]:
    """(driver module, its flags) of the configuration `record`: a log
    JSON, or an experiment directory that UNLOGGED names. Raises
    ValueError for a recorded option the driver does not have."""
    if os.path.isdir(record):
        config = unlogged_config(record)
        experiment_dir = os.path.abspath(record)
    else:
        with open(record) as f:
            config = json.load(f)
        experiment_dir = os.path.dirname(os.path.dirname(
            os.path.abspath(record)))
    module = driver_of(config)
    actions = {a.dest: a for a in parser_of(module)._actions
               if a.option_strings}
    unknown = sorted(set(config) - set(actions) - set(LEFT_OUT))
    if unknown:
        raise ValueError(f'{record}: {module} has no option for {unknown}')
    argv = []
    for key, value in config.items():
        if key in LEFT_OUT or value is None:
            continue
        if key in ASSETS:
            value = find_asset(value, experiment_dir)
        flag = actions[key].option_strings[-1]
        if actions[key].nargs == 0:   # store_true
            argv += [flag] if value else []
        else:
            argv.append(f'{flag}={value}')
    return module, argv


def main(argv: Optional[Sequence[str]] = None):
    """Runs (or with --dry_run prints) the record's command; returns the
    driver's result, or the command."""
    argv = list(sys.argv[1:] if argv is None else argv)
    dry_run = '--dry_run' in argv
    argv = [a for a in argv if a != '--dry_run']
    if not argv or argv[0].startswith('-'):
        raise SystemExit(__doc__)
    module, flags = recorded_argv(argv[0])
    flags += argv[1:]
    command = ' '.join(['python3', '-m', module] + flags)
    print(command, file=sys.stderr)
    if dry_run:
        return command
    return importlib.import_module(module).main(flags)


if __name__ == '__main__':
    main()
