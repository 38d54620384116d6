"""Scaffold-constrained training run of the port (counterpart of
scripts/run_scaffold.py): the scaffold's atoms are pre-placed on the
canvas, every new atom must land inside the scaffold's convex hull (a
halfspace test computed once from the hull), and the reward sees the
non-scaffold atoms only.

The recorded configuration (experiments/scaffold_pm6/logs/
scafpm6_run-1.json), on the card, from the repository's root:

    python3 -m molgym_tpu_torch.run_scaffold --name=scafpm6 \\
        --formulas=H2O --scaffold=experiments/scaffold_pm6/cube.xyz \\
        --canvas_size=12 --symbols=X,H,O,Ar --bag_scale=3 --model=internal \\
        --network_width=128 --num_interactions=3 --num_envs=8 \\
        --num_steps_per_iter=256 --mini_batch_size=128 --reward=pm6 \\
        --eval_freq=3 --save_rollouts=eval --num_steps=12288 --seed=1

Add `--device=cpu` to run on the CPU (slow; for tiny configurations).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from molgym_tpu_torch.atoms import read_xyz
from molgym_tpu_torch.envs.environment import MolecularEnv, scaffold_halfspaces
from molgym_tpu_torch.envs.reward import RewardFn
from molgym_tpu_torch.spaces import ObservationSpace
from molgym_tpu_torch.tools.arg_parser import build_default_argparser
from molgym_tpu_torch.tools.driver import (initial_canvas, run_experiment,
                                           standard_envs)


def build_parser() -> argparse.ArgumentParser:
    parser = build_default_argparser()
    parser.add_argument('--scaffold',
                        help='path to the scaffold XYZ file whose convex hull '
                        'constrains atom placement', type=str, required=True)
    return parser


def scaffold_envs(config: dict, observation_space: ObservationSpace,
                  reward_fn: RewardFn, device: torch.device
                  ) -> Tuple[MolecularEnv, MolecularEnv]:
    """Training and evaluation environments over the formulas, each
    episode starting from the scaffold. Raises ValueError when the canvas
    has no free slot beside the scaffold, or the scaffold holds an element
    --symbols lacks."""
    scaffold = read_xyz(config['scaffold'])
    elements, positions = initial_canvas(observation_space, scaffold,
                                         'scaffold')
    hull = scaffold_halfspaces(positions[:len(scaffold)].astype(np.float64))
    return standard_envs(config, observation_space, reward_fn, device,
                         initial_elements=elements,
                         initial_positions=positions,
                         scaffold_halfspaces=hull, n_scaffold=len(scaffold))


def main(argv: Optional[Sequence[str]] = None):
    """Parses `argv` (else the command line), trains, and returns the
    trained (agent, optimizer)."""
    config = vars(build_parser().parse_args(argv))
    return run_experiment(config, env_builder=scaffold_envs)


if __name__ == '__main__':
    main()
