"""Multi-bag training run of the port on formulas drawn from the QM9/GDB9
dataset (counterpart of scripts/run_qm9.py): --qm9_dataset names a GDB9
tar, and the bag set is drawn from its parsed molecules (--formulas is
ignored, as in the JAX script).

The selection is deterministic in --qm9_selection_seed (independent of
--seed, so every seed of a run trains on the same bag set): parse ->
formula strings -> keep those whose elements all lie in --symbols and whose
size fits --canvas_size -> dedup in the archive's order -> a draw of
--qm9_num_formulas by np.random.RandomState(--qm9_selection_seed).

The recorded configuration (experiments/qm9_pm6/logs/qm9pm6_run-1.json;
it selects CNH,COH2,CFH3,CO2H2), on the card, from the repository's root:

    python3 -m molgym_tpu_torch.run_qm9 --name=qm9pm6 \\
        --qm9_dataset=experiments/qm9_pm6/qm9_sample.tar.gz \\
        --qm9_num_formulas=4 --canvas_size=7 --symbols=X,H,C,N,O,F \\
        --reward=pm6 --model=covariant --beta=-10 --bag_scale=6 \\
        --num_envs=10 --num_steps_per_iter=140 --mini_batch_size=140 \\
        --save_rollouts=eval --num_steps=8400 --seed=1

Add `--device=cpu` to run on the CPU (slow; for tiny configurations).
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np

from molgym_tpu_torch.formula import formula_to_string, zs_to_formula
from molgym_tpu_torch.spaces import symbols_to_zs
from molgym_tpu_torch.tools.arg_parser import build_default_argparser
from molgym_tpu_torch.tools.driver import run_experiment
from molgym_tpu_torch.tools.qm9_parser import parse_dataset


def select_qm9_formulas(dataset_path: str, symbols: str, canvas_size: int,
                        num_formulas: int, selection_seed: int) -> List[str]:
    """`num_formulas` distinct formulas of the dataset's molecules that fit
    the symbols and the canvas, in the archive's order (all of them when
    there are no more)."""
    allowed = set(symbols_to_zs(symbols))
    seen = set()
    candidates = []
    for _gdb_id, atoms, _info in parse_dataset(dataset_path):
        zs = [a.z for a in atoms]
        if len(zs) > canvas_size or any(z not in allowed for z in zs):
            continue
        formula = formula_to_string(zs_to_formula(zs))
        if formula not in seen:
            seen.add(formula)
            candidates.append(formula)
    if not candidates:
        raise RuntimeError(
            f'no QM9 molecules from {dataset_path} fit --symbols={symbols} '
            f'and --canvas_size={canvas_size}')
    if num_formulas >= len(candidates):
        return candidates
    rng = np.random.RandomState(selection_seed)
    idx = rng.choice(len(candidates), size=num_formulas, replace=False)
    return [candidates[i] for i in sorted(idx)]


def build_parser() -> argparse.ArgumentParser:
    parser = build_default_argparser()
    for action in parser._actions:
        if action.dest == 'formulas':
            action.required = False
            action.help += ' (ignored: drawn from --qm9_dataset)'
    parser.add_argument('--qm9_dataset', required=True,
                        help='GDB9 tar of xyz records (the full dsgdb9nsd '
                             'archive or experiments/qm9_pm6/'
                             'qm9_sample.tar.gz)')
    parser.add_argument('--qm9_num_formulas', type=int, default=4,
                        help='size of the bag set drawn from the dataset')
    parser.add_argument('--qm9_selection_seed', type=int, default=0,
                        help='seed of the draw (independent of --seed, so '
                             'that every seed shares one bag set)')
    return parser


def config_from(argv: Optional[Sequence[str]] = None) -> dict:
    """The run's configuration parsed from `argv` (else the command line),
    its 'formulas' the bag set drawn from --qm9_dataset."""
    config = vars(build_parser().parse_args(argv))
    config['formulas'] = ','.join(select_qm9_formulas(
        config['qm9_dataset'], config['symbols'], config['canvas_size'],
        config['qm9_num_formulas'], config['qm9_selection_seed']))
    return config


def main(argv: Optional[Sequence[str]] = None):
    """Parses `argv` (else the command line), draws the bag set, prints it
    (the config snapshot in --log_dir records it too), trains, and returns
    the trained (agent, optimizer)."""
    config = config_from(argv)
    print(f'QM9-sampled formulas: {config["formulas"]}', flush=True)
    return run_experiment(config)


if __name__ == '__main__':
    main()
