"""Single/multi-bag training run of the port (counterpart of scripts/run.py).

The canonical SF6 covariant run, on the card:

    python3 -m molgym_tpu_torch.run --name=sf6 --formulas=SF6 \\
        --canvas_size=7 --symbols=X,S,F --bag_scale=5 --model=covariant \\
        --beta=-10 --min_mean_distance=1.10 --max_mean_distance=2.10 \\
        --num_envs=10 --num_steps_per_iter=140 --mini_batch_size=140 \\
        --reward=device_lj --num_steps=50000

The recorded SF6 run with the PM6 reward (experiments/sf6_pm6/logs/
sf6pm6_run-1.json), its reward computed on the host by the native library:

    python3 -m molgym_tpu_torch.run --name=sf6pm6 --formulas=SF6 \\
        --canvas_size=7 --symbols=X,S,F --bag_scale=5 --model=covariant \\
        --beta=-10 --min_mean_distance=1.1 --max_mean_distance=2.1 \\
        --num_envs=10 --num_steps_per_iter=140 --mini_batch_size=140 \\
        --reward=pm6 --host_reward_mode=auto --num_eval_episodes=1 \\
        --save_rollouts=eval --num_steps=15120 --seed=1

`--host_reward_mode=loop` overlaps each step's host reward with the next
policy forward; `callback` and `loop_serial` compute it inside the env's
step, strictly in order; `auto` (the default) times both on the first warm
iterations and keeps the faster. Add `--device=cpu`
to run on the CPU (slow; for tiny configurations).
"""
from __future__ import annotations

from typing import Optional, Sequence

from molgym_tpu_torch.tools.arg_parser import build_default_argparser
from molgym_tpu_torch.tools.driver import run_experiment, standard_envs


def main(argv: Optional[Sequence[str]] = None):
    """Parses `argv` (else the command line), trains, and returns the
    trained (agent, optimizer)."""
    config = vars(build_default_argparser().parse_args(argv))
    return run_experiment(config, env_builder=standard_envs)


if __name__ == '__main__':
    main()
