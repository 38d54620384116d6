"""Learning curves of the port's runs (counterpart of scripts/plot.py):
the JSON-lines metric streams of a results directory, the mean and std of
`return_mean` over seeds per experiment, drawn into one PDF.

    python3 -m molgym_tpu_torch.plot --dir=results --mode=eval \\
        --output=average_return.pdf

matplotlib and pandas are imported when it runs; the card's machine has
neither, and nothing there imports this module.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from molgym_tpu_torch.tools.analysis import aggregate_over_seeds, load_metrics

FIG_WIDTH, FIG_HEIGHT = 6.0, 4.0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='Plot learning curves')
    parser.add_argument('--dir', help='directory with results files', type=str,
                        default='results')
    parser.add_argument('--mode', help='metric stream to plot', type=str,
                        default='eval', choices=['train', 'eval', 'opt'])
    parser.add_argument('--output', help='output file', type=str,
                        default='average_return.pdf')
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    args = build_parser().parse_args(argv)
    grouped = aggregate_over_seeds(load_metrics(args.dir, args.mode))
    fig, ax = plt.subplots(figsize=(FIG_WIDTH, FIG_HEIGHT),
                           constrained_layout=True)
    for name, group in grouped.groupby('name'):
        ax.plot(group['total_num_steps'], group['mean'], label=name)
        std = group['std'].fillna(0.0)
        ax.fill_between(group['total_num_steps'], group['mean'] - std,
                        group['mean'] + std, alpha=0.25)
    ax.set_xlabel('environment steps')
    ax.set_ylabel('average return')
    ax.legend()
    fig.savefig(args.output)
    plt.close(fig)
    print(f'Wrote {args.output}')


if __name__ == '__main__':
    main()
