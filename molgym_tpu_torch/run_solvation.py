"""Solvation training run of the port (counterpart of
scripts/run_solvation.py): bags refilled up to --num_refills times around an
optional pre-placed structure, with every reward less --distance_penalty *
|new position| (the solvation reward).

The recorded configuration (experiments/solvation/logs/solv_run-1.json),
on the card, from the repository's root:

    python3 -m molgym_tpu_torch.run_solvation --name=solv \\
        --formulas=H2O --initial_structure=experiments/solvation/solute.xyz \\
        --num_refills=2 --distance_penalty=0.01 --canvas_size=12 \\
        --symbols=X,H,C,O --bag_scale=4 --model=internal \\
        --network_width=64 --num_interactions=3 --num_envs=10 \\
        --num_steps_per_iter=140 --mini_batch_size=140 --reward=device_lj \\
        --num_eval_episodes=1 --save_rollouts=eval --num_steps=7000 --seed=1

The PM6 runs (experiments/solvation_pm6) take `--reward=pm6` in place of
the device LJ reward. Add `--device=cpu` to run on the CPU (slow; for tiny
configurations).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import torch

from molgym_tpu_torch.atoms import read_xyz
from molgym_tpu_torch.envs.environment import MolecularEnv
from molgym_tpu_torch.envs.reward import RewardFn
from molgym_tpu_torch.spaces import ObservationSpace
from molgym_tpu_torch.tools.arg_parser import build_default_argparser
from molgym_tpu_torch.tools.driver import (initial_canvas, run_experiment,
                                           standard_envs)


def build_parser() -> argparse.ArgumentParser:
    parser = build_default_argparser()
    parser.add_argument('--initial_structure',
                        help='path to an XYZ file pre-placed on the canvas',
                        type=str, default=None)
    parser.add_argument('--num_refills',
                        help='number of times the bag is refilled', type=int,
                        default=0)
    parser.add_argument('--distance_penalty',
                        help='solvation distance penalty', type=float,
                        default=0.01)
    return parser


def solvation_envs(config: dict, observation_space: ObservationSpace,
                   reward_fn: RewardFn, device: torch.device
                   ) -> Tuple[MolecularEnv, MolecularEnv]:
    """Training and evaluation environments over the formulas, each
    episode starting from the --initial_structure (if any) and refilling
    its bag --num_refills times."""
    kwargs = dict(num_refills=config['num_refills'])
    if config.get('initial_structure'):
        elements, positions = initial_canvas(
            observation_space, read_xyz(config['initial_structure']),
            'the initial structure')
        kwargs.update(initial_elements=elements, initial_positions=positions)
    return standard_envs(config, observation_space, reward_fn, device,
                         **kwargs)


def main(argv: Optional[Sequence[str]] = None):
    """Parses `argv` (else the command line), trains, and returns the
    trained (agent, optimizer)."""
    config = vars(build_parser().parse_args(argv))
    return run_experiment(config, env_builder=solvation_envs, solvation=True)


if __name__ == '__main__':
    main()
