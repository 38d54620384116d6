"""Stochastic-bag training run of the port (counterpart of
scripts/run_stochastic.py): train on bags sampled from the base formula's
element distribution within --size_range (even total valence enforced),
evaluate on the fixed formulas.

The recorded configuration (experiments/stochastic/logs/stoch_run-1.json),
on the card:

    python3 -m molgym_tpu_torch.run_stochastic --name=stoch \\
        --formulas=C2H6O --size_range=4,9 --canvas_size=10 \\
        --symbols=X,H,C,O --bag_scale=6 --model=covariant --maxl=3 \\
        --num_cg_levels=2 --beta=-10 --min_mean_distance=0.9 \\
        --max_mean_distance=1.8 --num_envs=10 --num_steps_per_iter=140 \\
        --mini_batch_size=140 --reward=device_lj --num_steps=7000 \\
        --save_rollouts=eval --seed=1

The same run with the PM6 reward on the host (experiments/stochastic_pm6)
takes `--reward=pm6 --maxl=4 --num_cg_levels=3` in place of the device LJ
reward and the narrower agent. Add `--device=cpu` to run on the CPU (slow;
for tiny configurations).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from molgym_tpu_torch.envs.environment import MolecularEnv
from molgym_tpu_torch.envs.reward import RewardFn
from molgym_tpu_torch.formula import parse_size_range, string_to_formula
from molgym_tpu_torch.spaces import ObservationSpace
from molgym_tpu_torch.tools.arg_parser import build_default_argparser
from molgym_tpu_torch.tools.driver import run_experiment


def build_parser() -> argparse.ArgumentParser:
    parser = build_default_argparser()
    parser.add_argument('--size_range',
                        help='size range of sampled formulas, e.g. 4,10',
                        type=str, required=True)
    return parser


def stochastic_envs(config: dict, observation_space: ObservationSpace,
                    reward_fn: RewardFn, device: torch.device
                    ) -> Tuple[MolecularEnv, MolecularEnv]:
    """A training env that samples its bags from the first formula's
    element distribution, and an evaluation env over the fixed formulas."""

    def bags(strings: str) -> np.ndarray:
        return np.stack([observation_space.bag_from_formula(string_to_formula(s))
                         for s in strings.split(',')])

    kwargs = dict(reward_fn=reward_fn, observation_space=observation_space,
                  min_atomic_distance=config['min_atomic_distance'],
                  max_solo_distance=config['max_solo_distance'],
                  min_reward=config['min_reward'], device=device)
    train_env = MolecularEnv(
        formulas=bags(config['formulas'])[:1],
        stochastic_size_range=parse_size_range(config['size_range']), **kwargs)
    eval_env = MolecularEnv(
        formulas=bags(config.get('eval_formulas') or config['formulas']),
        **kwargs)
    return train_env, eval_env


def main(argv: Optional[Sequence[str]] = None):
    """Parses `argv` (else the command line), trains, and returns the
    trained (agent, optimizer)."""
    config = vars(build_parser().parse_args(argv))
    return run_experiment(config, env_builder=stochastic_envs)


if __name__ == '__main__':
    main()
