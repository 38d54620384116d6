"""The JAX package's own seeds of the solvation and scaffold records: the
reference arm of curve_summary.settle_by_reference (ROADMAP Queue 3).

    python -m tests.torch_jax_seeds run --family=solvation --seeds=3-20 \\
        --workdir=/tmp/jax_solv [--jobs=4]

runs the JAX package's driver (scripts/run_solvation.py,
scripts/run_scaffold.py) once for each seed, at most --jobs at a time, as
subprocesses in --workdir (which gets the usual logs/ models/ results/
data/ and one seed<s>.out each), with the record's flags as
tools/recorded_run.py derives them for the port (the log JSON of
experiments/solvation, the README command of experiments/scaffold, assets
absolute), then --seed=<s> and --device=cpu: JAX_PLATFORMS=cpu alone is
overridden on some images. The runs are f32 on the CPU, about two minutes
a seed with 3-4 at a time on 8 cores. Then each run's final checkpoint
becomes a port checkpoint file, <workdir>/port/models/<tag>_steps-<n>.model
with the run's configuration at <workdir>/port/logs/<tag>.json, so that
tools/diagnose_greedy.py reads it as it reads any port run: the orbax
restore of tests/torch_export_checkpoints.py, convert.checkpoint_from_jax,
the agent's load_state_dict, the port's ModelIO.save. `compare` prints how far a run of a recorded seed
(scaffold's 1 and 2) lies from the committed record, key by key.

    python -m tests.torch_jax_seeds record --family=solvation \\
        --port=<the port's run dir> --port_seeds=28-45 \\
        --jax=<workdir>/port --jax_seeds=3-20 --card='<name, limit>' \\
        --out=molgym_tpu_torch/records/seed_spread_solvation.json

writes the seed-spread record that curve_summary --seed_spread reads:
for each seed of each arm (a run dir holding logs/ models/ results/),
summarize's dict, diagnose_greedy's sampled mean and complete fraction
(--num_sampled 16 --seed 1, on the CPU) and the median rollout plus
update seconds; `table --out=<that
JSON> [--out=<another>]` prints them side by side as markdown rows.

A helper, not a test: it imports molgym_tpu (only to restore a JAX
checkpoint), and no module of the port imports it.
tests/test_torch_jax_seeds.py holds its command and its conversion.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# family -> (its record for tools/recorded_run.py, the JAX driver)
RECORDS = {
    'solvation': ('experiments/solvation/logs/solv_run-1.json',
                  'scripts/run_solvation.py'),
    'scaffold': ('experiments/scaffold', 'scripts/run_scaffold.py'),
}


def seed_list(text: str) -> List[int]:
    """'3-20' or '3,5,7' -> the seeds."""
    seeds: List[int] = []
    for part in text.split(','):
        first, _, last = part.partition('-')
        seeds += range(int(first), int(last or first) + 1)
    return seeds


def jax_command(family: str, seed: int) -> List[str]:
    """The JAX driver's command line for `seed`: the record's flags as
    recorded_run gives them to the port, then --seed and --device=cpu."""
    from molgym_tpu_torch.tools.recorded_run import recorded_argv
    record, script = RECORDS[family]
    _module, flags = recorded_argv(str(ROOT / record))
    return ([sys.executable, str(ROOT / script)] + flags
            + [f'--seed={seed}', '--device=cpu'])


def _run_one(family: str, seed: int, workdir: Path) -> dict:
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=str(ROOT))
    start = time.time()
    with open(workdir / f'seed{seed}.out', 'w') as out:
        rc = subprocess.run(jax_command(family, seed), cwd=workdir, env=env,
                            stdout=out, stderr=subprocess.STDOUT).returncode
    return dict(family=family, seed=seed, rc=rc,
                seconds=round(time.time() - start, 1))


def run_seeds(family: str, seeds: List[int], workdir: Path,
              jobs: int) -> List[dict]:
    """Runs the seeds, at most `jobs` at a time; a JSON line each."""
    workdir.mkdir(parents=True, exist_ok=True)
    results = []
    with concurrent.futures.ThreadPoolExecutor(jobs) as pool:
        for result in pool.map(lambda s: _run_one(family, s, workdir), seeds):
            print(json.dumps(result), flush=True)
            results.append(result)
    return results


def _steps(model_dir: Path) -> int:
    return int(model_dir.name.rsplit('_steps-', 1)[1][:-len('.model')])


def final_checkpoint(models: Path, tag: str) -> Path:
    """The checkpoint of the most steps of `tag` in `models`."""
    found = sorted(models.glob(f'{tag}_steps-*.model'), key=_steps)
    if not found:
        raise FileNotFoundError(f'no checkpoint of {tag} in {models}')
    return found[-1]


def port_state(model_dir: Path, family: str) -> Dict[str, 'torch.Tensor']:
    """A JAX orbax checkpoint's params as the port agent's state dict:
    the raw restore flattened as the archives are, then
    convert.checkpoint_from_jax (a bfloat16 leaf as the float32 of the
    same value, as model_io.read_archive reads it)."""
    from molgym_tpu_torch.convert import checkpoint_from_jax
    from tests.torch_export_checkpoints import flatten, restore_raw
    leaves, _nones = flatten({'params': restore_raw(model_dir)['params']})
    flat = {k: (v.astype(np.float32) if v.dtype.name == 'bfloat16' else v)
            for k, v in leaves.items()}
    return checkpoint_from_jax(flat, family)['model']


def convert_run(model_dir: Path, config_path: Path, out: Path) -> Path:
    """The JAX checkpoint `model_dir` as a port checkpoint file under
    out/models, its configuration copied to out/logs/<tag>.json."""
    from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
    from molgym_tpu_torch.tools.model_io import ModelIO
    from molgym_tpu_torch.tools.model_util import build_model
    config = json.loads(config_path.read_text())
    tag = config_path.stem
    space = ObservationSpace(config['canvas_size'],
                             symbols_to_zs(config['symbols']))
    agent = build_model(config, space, device='cpu')
    agent.load_state_dict(port_state(model_dir, config['model']))
    (out / 'logs').mkdir(parents=True, exist_ok=True)
    (out / 'models').mkdir(parents=True, exist_ok=True)
    shutil.copy(config_path, out / 'logs' / f'{tag}.json')
    return Path(ModelIO(str(out / 'models'), tag).save(
        agent, num_steps=_steps(model_dir)))


def tag_of(family: str, seed: int) -> str:
    """The tag a run of the record's command with `seed` writes."""
    from molgym_tpu_torch.tools.recorded_run import recorded_argv
    flags = dict(f.lstrip('-').partition('=')[::2]
                 for f in recorded_argv(str(ROOT / RECORDS[family][0]))[1])
    return f'{flags["name"]}_run-{seed}'


def convert_seeds(family: str, seeds: List[int], workdir: Path) -> None:
    for seed in seeds:
        tag = tag_of(family, seed)
        path = convert_run(final_checkpoint(workdir / 'models', tag),
                           workdir / 'logs' / f'{tag}.json',
                           workdir / 'port')
        print(path, flush=True)
    shutil.copytree(workdir / 'results', workdir / 'port' / 'results',
                    dirs_exist_ok=True)


def against_record(family: str, results: Path, tag: str) -> dict:
    """The largest |difference| of a run's train and eval lines from the
    committed record of the same tag (experiments/<family>/results), key
    by key, over the keys both hold: a run of a recorded seed again."""
    from molgym_tpu_torch.tools.analysis import read_jsonl
    record = ROOT / 'experiments' / family / 'results'
    out = {}
    for mode in ('train', 'eval'):
        runs, recs = (read_jsonl(str(d / f'{tag}_{mode}.txt'))
                      for d in (results, record))
        if len(runs) != len(recs):
            raise ValueError(f'{tag} {mode}: {len(runs)} lines, the record '
                             f'{len(recs)}')
        keys = sorted(k for k in set(runs[0]) & set(recs[0])
                      if k not in ('time', 'total_num_steps'))
        out[mode] = {k: max(abs(a[k] - b[k]) for a, b in zip(runs, recs))
                     for k in keys}
    return out


def _diagnose(model_path: str) -> Tuple[float, float]:
    import torch
    from molgym_tpu_torch.tools.diagnose_greedy import diagnose
    torch.set_num_threads(2)
    sampled = diagnose(model_path, num_sampled=16, seed=1,
                       device='cpu')['sampled']
    return sampled['mean'], sampled['complete_fraction']


def rollout_update_s(results: Path, tag: str) -> float:
    """The median of an iteration's rollout plus update seconds (the
    first left out), which both packages' train and opt lines keep (the
    JAX package's no iteration_time)."""
    from molgym_tpu_torch.tools.analysis import read_jsonl
    train = read_jsonl(str(results / f'{tag}_train.txt'))
    opt = read_jsonl(str(results / f'{tag}_opt.txt'))
    return statistics.median(t['time'] + o['time']
                             for t, o in zip(train[1:], opt[1:]))


def arm_record(family: str, run_dir: Path, seeds: List[int],
               jobs: int) -> List[dict]:
    """Each seed's summary, sampled mean, complete fraction and median
    rollout plus update seconds."""
    from molgym_tpu_torch.curve_summary import summarize
    tags = [tag_of(family, s) for s in seeds]
    paths = [str(final_checkpoint(run_dir / 'models', t)) for t in tags]
    with concurrent.futures.ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context('spawn')) as pool:
        sampled = list(pool.map(_diagnose, paths))
    return [dict(seed=seed, tag=tag,
                 summary=summarize(str(run_dir / 'results'), tag),
                 sampled_mean=mean, complete_fraction=complete,
                 rollout_update_s=rollout_update_s(run_dir / 'results', tag))
            for seed, tag, (mean, complete) in zip(seeds, tags, sampled)]


def table_rows(paths: List[Path]) -> List[str]:
    """Seed-spread records side by side as markdown rows, the i-th seed of
    each arm of each record in row i; a cell: the seed, whether it meets
    THRESHOLDS, its last-10, its last 4 greedy evals (the atoms placed
    where short), its sampled mean (complete fraction) and its median
    rollout plus update seconds."""
    from molgym_tpu_torch.curve_summary import THRESHOLDS, seed_meets
    columns = []
    for path in paths:
        spread = json.loads(path.read_text())
        atoms = THRESHOLDS[spread['family']][2]
        for arm in ('port', 'jax'):
            cells = []
            for s in spread[arm]['seeds']:
                summary = s['summary']
                evals = ' '.join(
                    f'{r:.3f}' + (f'({n:g})' if n < atoms - 1e-6 else '')
                    for r, n in summary['last4_evals'])
                meets = seed_meets(spread['family'], summary)
                cells.append(
                    f'{s["seed"]} {"✓" if meets else "✗"} '
                    f'{summary["last10_train_return"]:.4f}; {evals}; '
                    f'{s["sampled_mean"]:.6f} ({s["complete_fraction"]:.4f});'
                    f' {s["rollout_update_s"]:.3f}')
            columns.append(cells)
    return ['| ' + ' | '.join(row) + ' |' for row in zip(*columns)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('step', choices=['run', 'compare', 'record',
                                         'table'])
    parser.add_argument('--family', required=True, choices=sorted(RECORDS))
    parser.add_argument('--seeds', type=seed_list,
                        help='run, compare: e.g. 3-20')
    parser.add_argument('--workdir', type=Path,
                        help='run, compare: where the JAX runs write')
    parser.add_argument('--jobs', type=int, default=4,
                        help='processes at a time (default 4)')
    parser.add_argument('--port', type=Path, help="record: the port's run "
                        'directory (logs/ models/ results/)')
    parser.add_argument('--port_seeds', type=seed_list)
    parser.add_argument('--jax', type=Path, help='record: the converted JAX '
                        'runs (<workdir>/port)')
    parser.add_argument('--jax_seeds', type=seed_list)
    parser.add_argument('--card', help="record: the card's name and power "
                        'limit that trained the port arm')
    parser.add_argument('--out', type=Path, action='append',
                        help='record: the JSON to write; table: a record '
                        'to print, once for each')
    args = parser.parse_args(argv)
    if args.step == 'table':
        print('\n'.join(table_rows(args.out)))
        return 0
    if args.step == 'compare':
        for seed in args.seeds:
            tag = tag_of(args.family, seed)
            print(json.dumps(dict(tag=tag, max_abs_diff=against_record(
                args.family, args.workdir / 'results', tag))))
        return 0
    if args.step == 'run':
        if any(r['rc'] != 0 for r in run_seeds(args.family, args.seeds,
                                               args.workdir, args.jobs)):
            return 1
        convert_seeds(args.family, args.seeds, args.workdir)
        return 0
    record = dict(
        family=args.family, record=RECORDS[args.family][0],
        sampled='diagnose_greedy --num_sampled 16 --seed 1, on the CPU',
        port=dict(trained_on=args.card, driver='tools/recorded_run.py, f32',
                  seeds=arm_record(args.family, args.port, args.port_seeds,
                                   args.jobs)),
        jax=dict(trained_on='CPU, f32',
                 driver=RECORDS[args.family][1] + ', --device=cpu',
                 seeds=arm_record(args.family, args.jax, args.jax_seeds,
                                  args.jobs)))
    out, = args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record) + '\n')
    from molgym_tpu_torch.curve_summary import read_seed_spread
    print(json.dumps(read_seed_spread(str(out))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
