"""The readings the limits of limits/<cell>.json are set from: the compared
numbers of sound runs of the program over many seeds, of the control in
lower precision, and of each planted fault (harness/faults.py), all in one
process on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--plant tf32|reward_bf16|unchanged|half_batch|answer] [--seconds 3]

Prints one JSON line a seed: the plant, the seed, whether the run came out
correct, each compared number, and the judge's numbers that are not
compared (`seen`). The training cells' readings need no window
(--seconds 0: the window then runs only the iterations the judge keeps);
the sampled cell's need one long enough for the rollouts the judge keeps.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path[:0] = [str(Path(__file__).resolve().parent),
                str(Path(__file__).resolve().parent.parent)]

import run  # noqa: E402
from harness.faults import PLANTS  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--plant', choices=sorted(PLANTS))
    parser.add_argument('--seconds', type=float, default=0.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('calibrate.py: no CUDA card', file=sys.stderr)
        return 3
    plant = PLANTS[args.plant] if args.plant else None
    for seed in (int(s) for s in args.seeds.split(',')):
        out, notes = run.run_cell(Path.cwd(), args.workload, seed, args.seconds, False,
                           torch.device('cuda'), plant=plant,
                           started=time.perf_counter())
        print(json.dumps(dict(workload=args.workload, plant=args.plant,
                              seed=seed, correct=out['correct'],
                              timing=notes['timing'], seen=notes['seen'],
                              **{k: v['value'] for k, v in out['compared'].items()})),
              flush=True)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
