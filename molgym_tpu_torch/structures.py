"""The molecules a run built, from its saved rollouts (counterpart of
scripts/structures.py): unpickle the rollouts that the port's RolloutSaver
wrote (`{tag}_steps-{n}_{mode}.pkl`, a dict of numpy arrays), take the
canvas after every terminal step, and write them as one multi-frame XYZ
file.

    python3 -m molgym_tpu_torch.structures --dir=data --mode=eval \\
        --symbols=X,H,C,O --output=structures.xyz

It runs on the host and never touches a card.
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

from molgym_tpu_torch.atoms import Atoms, write_xyz
from molgym_tpu_torch.periodic import CHEMICAL_SYMBOLS
from molgym_tpu_torch.spaces import symbols_to_zs
from molgym_tpu_torch.tools.analysis import iter_artifacts


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='Extract terminal structures')
    parser.add_argument('--dir', help='directory with rollout pickles',
                        type=str, default='data')
    parser.add_argument('--mode', help='which rollouts', type=str,
                        default='eval', choices=['train', 'eval'])
    parser.add_argument('--symbols', help='comma-separated symbols (X first) '
                        'used by the run', type=str, required=True)
    parser.add_argument('--output', help='output XYZ file', type=str,
                        default='structures.xyz')
    parser.add_argument('--name', help='only rollouts of this experiment '
                        'name (a directory of several runs would otherwise '
                        'mix canvases of other symbol sets)', type=str,
                        default=None)
    return parser


def terminal_structures(rollout: dict, zs: Sequence[int]) -> List[Atoms]:
    """The non-empty canvases of `next_obs` at terminal steps (the finished
    molecules), in step-then-env order, of a rollout as RolloutSaver
    pickles it ([T, B] fields)."""
    terminals = np.asarray(rollout['terminals'])
    elements = np.asarray(rollout['next_obs']['elements'])
    positions = np.asarray(rollout['next_obs']['positions'])
    structures = []
    for t, b in zip(*np.nonzero(terminals)):
        keep = elements[t, b] != 0
        if keep.any():
            symbols = [CHEMICAL_SYMBOLS[zs[e]] for e in elements[t, b][keep]]
            structures.append(Atoms(symbols, positions[t, b][keep]))
    return structures


def main(argv: Optional[Sequence[str]] = None) -> List[Atoms]:
    """Writes the structures of the rollouts `argv` selects, in the order
    of their step counts, and returns them."""
    args = build_parser().parse_args(argv)
    zs = symbols_to_zs(args.symbols)
    artifacts = sorted(
        (a for a in iter_artifacts(args.dir, mode=args.mode, ext='pkl')
         if a.steps is not None and args.name in (None, a.name)),
        key=lambda a: a.steps)
    structures = []
    for art in artifacts:
        with open(art.path, 'rb') as f:
            structures.extend(terminal_structures(pickle.load(f), zs))
    if not structures:
        raise RuntimeError('No terminal structures found in '
                           f'{os.path.abspath(args.dir)}')
    write_xyz(args.output, structures)
    print(f'Wrote {len(structures)} structures to {args.output}')
    return structures


if __name__ == '__main__':
    main()
