"""A run's learning curve summed up beside its JAX record: the numbers kept
of the recorded runs trained in full on the card.

    python3 -m molgym_tpu_torch.curve_summary --tag=sf6lj_run-1 \\
        --results=<the run's results dir> --reference=experiments/sf6/results

Prints one JSON object: for the run and the reference, the iterations, the
mean training return of the last 10 iterations, the last 4 greedy
evaluations (return, episode length) and the final one; for the run also
its iteration seconds (the first, which builds the kernels, the median of
the rest, the sum), which the reference's records lack. Host only: it reads
the JSON lines a run wrote (tools/util.py's InfoSaver).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
from typing import Optional, Sequence

from molgym_tpu_torch.tools.analysis import read_jsonl

LAST_TRAIN = 10
LAST_EVALS = 4


def summarize(results_dir: str, tag: str) -> dict:
    def lines(mode):
        return read_jsonl(os.path.join(results_dir, f'{tag}_{mode}.txt'))
    train, evals, opt = lines('train'), lines('eval'), lines('opt')
    out = dict(
        iterations=len(train),
        last10_train_return=statistics.fmean(
            r['return_mean'] for r in train[-LAST_TRAIN:]),
        last4_evals=[(r['return_mean'], r['episode_length_mean'])
                     for r in evals[-LAST_EVALS:]],
        final_eval=evals[-1]['return_mean'],
        evals=[(r['total_num_steps'], r['return_mean'],
                r['episode_length_mean']) for r in evals])
    seconds = [r['iteration_time'] for r in opt if 'iteration_time' in r]
    if seconds:
        out.update(first_iteration_s=seconds[0],
                   median_iteration_s=statistics.median(seconds[1:]),
                   total_iteration_s=sum(seconds))
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--tag', required=True, help='e.g. sf6lj_run-1')
    parser.add_argument('--results', required=True,
                        help="the run's results directory")
    parser.add_argument('--reference', help="the JAX record's results "
                        'directory (experiments/<experiment>/results)')
    args = parser.parse_args(argv)
    out = dict(tag=args.tag, run=summarize(args.results, args.tag))
    if args.reference:
        out['reference'] = summarize(args.reference, args.tag)
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
