"""A run's learning curve summed up beside its JAX record: the numbers kept
of the recorded runs trained in full on the card.

    python3 -m molgym_tpu_torch.curve_summary --tag=sf6lj_run-1 \\
        --results=<the run's results dir> --reference=experiments/sf6/results

Prints one JSON object: for the run and the reference, the iterations, the
mean training return of the last 10 iterations, the last 4 greedy
evaluations (return, episode length), the final one and the last
iteration's host transport; for the run also
its iteration seconds (the first, which builds the kernels, the median of
the rest, the sum), which the reference's records lack. Host only: it reads
the JSON lines a run wrote (tools/util.py's InfoSaver). With a host reward
it adds the reward's share of the rollouts' seconds (the first iteration
left out).

    python3 -m molgym_tpu_torch.curve_summary --family=sf6_pm6 \\
        --tag=sf6pm6_run-1 --results=<run 1's results dir> \\
        --tag=sf6pm6_run-2 --results=<run 2's> ... \\
        --reference=experiments/sf6_pm6/results

sums up each tag (one --results for all, or one for each; with --logs,
the transport that --host_reward_mode=auto chose and its timed probes,
from the run's log and the reference's) and prints the family's verdict
under THRESHOLDS beside them (`meets`): the thresholds
that the port's seeds 1, 2 and 3 of a recorded run are held to when it is
trained in full on the card, set from the JAX records before any such run.
With --sampled (once for each of nine tags) and --reference_sampled, it
adds the settling rule's verdict (`settle`, SETTLE_SEEDS) of a family that
missed its threshold; for a family of SETTLE_BY_TRAINING, --reference_tag
(once for each JAX record in --reference) in their place. With
--precision, the same rule on seeds trained under the emulation of the
TPU's default matmul precision (settle_by_precision). With --jax_tag,
--jax_results and --jax_sampled (the JAX package's own seeds of the same
command) beside --sampled, the seed-spread rule (settle_by_reference,
SPREAD_SEEDS) in their place.

    python3 -m molgym_tpu_torch.curve_summary \\
        --seed_spread=molgym_tpu_torch/records/seed_spread_solvation.json

prints a committed seed-spread record's verdict and both p-values.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import re
import statistics
from typing import Optional, Sequence

from molgym_tpu_torch.tools.analysis import read_jsonl

LAST_TRAIN = 10
LAST_EVALS = 4

# family -> (floor of the last-10 training mean, floor of a greedy eval,
# the atoms of a full episode[, the evals that must meet]). A seed meets
# its family's threshold when its last-10 mean is at or above the first
# floor and at least the given number (EVALS_TO_MEET unless given) of its
# last LAST_EVALS greedy evals are at or above the second with every atom
# placed: an eval's mean episode length at or above the atoms, which are
# a mean over the eval formulas where those differ (qm9_pm6's CNH, COH2,
# CFH3 and CO2H2: 4.25); a family meets it when at least SEEDS_TO_MEET of
# its seeds (1, 2 and 3) do.
THRESHOLDS = {
    'sf6_pm6': (0.35, 0.60, 7),
    'sf6_internal': (0.40, 0.85, 7),
    'sf6_eht': (0.70, 1.00, 7),
    'h2o_eht': (0.25, 0.30, 3),
    'qm9_pm6': (0.25, 0.40, 4.25),
    'scaffold_pm6': (-0.40, 0.45, 3),
    'solvation_pm6': (0.45, 0.70, 9),
    # the multimodal greedy mode (tools/diagnose_greedy.py): the JAX seeds
    # themselves place every atom in 2 of their last 4 evals at most
    'stochastic_pm6': (0.05, 0.45, 9, 2),
    'halides_pm6': (0.30, 0.45, 5),
    'organics_pm6': (0.30, 0.55, 6),
    'sf6_internal_pm6': (-0.10, 0.50, 7),
    # the device-reward records of one seed each (two for scaffold): the
    # bf16 floors leave room for the f32 twin's seeds (experiments/sf6:
    # last-10 0.960 / 0.954, a 4-atom eval in 1 of their last 4, the
    # lowest full one 1.218); organics' eval plays its first bag only
    # (--num_eval_episodes=1); scaffold's records evaluate 4 times a seed
    # and place the whole bag only in their last evals (0.147 / 0.160), so
    # one eval of 4 must meet
    'sf6_bf16': (0.85, 1.10, 7),
    'organics': (0.35, 0.50, 6),
    'solvation': (0.25, 0.55, 9),
    'scaffold': (-0.60, 0.12, 3, 1),
}
EVALS_TO_MEET = 3
SEEDS_TO_MEET = 2

# The rule that settles a family whose port seeds 1-3 missed THRESHOLDS on
# greedy evaluations alone (stochastic_pm6, ROADMAP Queue 3), fixed before
# its seeds 1-9 were trained: the misses are the reference's greedy
# protocol, not a fault, when (a) at least SETTLE_SEEDS_TO_MEET of
# SETTLE_SEEDS port seeds meet the family's unchanged threshold (3 or fewer
# of 9 seeds that each met it at the JAX seeds' rate of 2/3 would occur
# 4.2% of the time), and (b) the mean of the port seeds' sampled means
# (tools/diagnose_greedy.py --num_sampled 16 --seed 1 on each final
# checkpoint) is at or above the lower of the JAX checkpoints' sampled means
# (the same protocol) less the port means' standard deviation (n - 1).
# The same rule settles solvation and scaffold (ROADMAP Queue 3), fixed
# before their seeds 10-18 were trained (seeds 1-9 were read before any
# rule existed, so they do not decide): solvation's (b) holds the nine
# sampled means against the JAX solv_run-1 archive's; scaffold's record kept
# no checkpoint, so for a family of SETTLE_BY_TRAINING (b) holds the nine
# seeds' mean last-10 training return against the lower JAX record's
# (summarize's last10_train_return of each record) less the nine's
# standard deviation.
SETTLE_SEEDS = 9
SETTLE_SEEDS_TO_MEET = 4
SETTLE_BY_TRAINING = frozenset({'scaffold'})

# solvation's rule said 'fault' on seeds 10-18; the cause no CPU test
# reaches is the record's arithmetic (one seed, trained on a TPU v5e at
# the TPU's default matmul precision). Fixed before they were trained: the
# same rule (`settle`), unchanged, on SETTLE_SEEDS fresh seeds (19-27)
# trained under tools/tpu_precision.py's emulation of that precision (their
# tags carry its TAG_SUFFIX), each sampled mean read as before, in f32 on
# the CPU. 'not a fault': the gap is the record's precision, a known
# difference by design; 'fault': precision is ruled out, the item stays
# open. Family -> the emulated runs' tag suffix.
SETTLE_BY_PRECISION = {'solvation': '_tpudefault'}
PRECISION_OUTCOMES = {
    'not a fault': "known difference by design: the record's TPU precision",
    'fault': 'precision ruled out: the item stays open'}

# solvation's and scaffold's rules said 'fault' against one JAX draw each;
# this one, fixed before any of its seeds ran, asks whether the port's
# seeds train worse than the JAX package's own seeds of the same command
# (its driver, the record's flags, f32 on a CPU): SPREAD_SEEDS fresh seeds
# of each arm, read by the same tools. (a) A one-sided Fisher exact test
# that the port's count of seeds meeting THRESHOLDS is lower than the JAX
# arm's; (b) a one-sided Mann-Whitney U test that the port's sampled means
# (diagnose_greedy --num_sampled 16 --seed 1 on each final checkpoint) lie
# below the JAX arm's. Each holds at p >= SPREAD_P; both holding: the
# reference's seed spread, not a fault. Its size when the arms are equal:
# (a) 2.5-3.3% at meet rates 0.3-0.7 (exact, Fisher's test is
# conservative), (b) 5%, so about 8% false 'fault' in all; (b)'s power at
# 18 against 18 for a shift of one sd (normal means) about 0.9
# (tests/test_torch_curve_summary.py::test_spread_rule_size).
SPREAD_SEEDS = 18
SPREAD_P = 0.05
SPREAD_OUTCOMES = {
    'not a fault': "the reference's seed spread",
    'fault': 'the port trains worse than the reference\'s seeds'}


def summarize(results_dir: str, tag: str,
              max_steps: Optional[int] = None) -> dict:
    """The run's numbers; with `max_steps`, of its first max_steps env
    steps only (the iterations that start before them and the evaluations
    up to them), for a record that a resumed run continued."""
    def lines(mode):
        recs = read_jsonl(os.path.join(results_dir, f'{tag}_{mode}.txt'))
        if max_steps is None:
            return recs
        return [r for r in recs if r['total_num_steps'] < max_steps
                or (mode == 'eval' and r['total_num_steps'] == max_steps)]
    train, evals, opt = lines('train'), lines('eval'), lines('opt')
    out = dict(
        iterations=len(train),
        last10_train_return=statistics.fmean(
            r['return_mean'] for r in train[-LAST_TRAIN:]),
        last4_evals=[(r['return_mean'], r['episode_length_mean'])
                     for r in evals[-LAST_EVALS:]],
        final_eval=evals[-1]['return_mean'],
        # the transport the run kept (--host_reward_mode=auto's choice)
        transport=train[-1].get('transport'),
        evals=[(r['total_num_steps'], r['return_mean'],
                r['episode_length_mean']) for r in evals])
    seconds = [r['iteration_time'] for r in opt if 'iteration_time' in r]
    if seconds:
        out.update(first_iteration_s=seconds[0],
                   median_iteration_s=statistics.median(seconds[1:]),
                   total_iteration_s=sum(seconds))
    rollouts = [r for r in train[1:] if 'reward_time' in r]
    if rollouts:
        out['reward_share'] = (sum(r['reward_time'] for r in rollouts)
                               / sum(r['time'] for r in rollouts))
    return out


def selector_probes(log_path: str) -> Optional[dict]:
    """The line of a run's log (either package's) where
    --host_reward_mode=auto chose its transport, the last where the log
    holds several runs: the choice and each timed probe's ms by transport;
    None without such a line or log."""
    if not os.path.exists(log_path):
        return None
    with open(log_path) as f:
        lines = [line for line in f if 'transport auto-selected' in line]
    if not lines:
        return None
    choice, probes = re.search(r"auto-selected '(\w+)' \((.*)\)",
                               lines[-1]).groups()
    return dict(choice=choice, probe_ms={
        name: float(ms) for name, ms in re.findall(r'(\w+): ([\d.]+) ms',
                                                   probes)})


def seed_meets(family: str, summary: dict) -> bool:
    """Whether one seed's summary meets THRESHOLDS[family]."""
    train_floor, eval_floor, atoms, *evals_to_meet = THRESHOLDS[family]
    evals_met = sum(ret >= eval_floor and length >= atoms - 1e-6
                    for ret, length in summary['last4_evals'])
    return (summary['last10_train_return'] >= train_floor
            and evals_met >= (evals_to_meet or [EVALS_TO_MEET])[0])


def meets(family: str, summaries: Sequence[dict]) -> dict:
    """The verdict on a family's seeds (summarize's dicts): each seed's,
    and whether at least SEEDS_TO_MEET of them meet THRESHOLDS[family]."""
    seeds = [seed_meets(family, s) for s in summaries]
    return dict(family=family, thresholds=THRESHOLDS[family],
                seeds=seeds, meets=sum(seeds) >= SEEDS_TO_MEET)


def settle(family: str, summaries: Sequence[dict],
           port_sampled: Optional[Sequence[float]],
           reference: Sequence[float]) -> dict:
    """The settling rule's verdict (see SETTLE_SEEDS) on a family's
    SETTLE_SEEDS port seeds (summarize's dicts): 'not a fault' when both
    conditions hold, else 'fault'. (b) reads the seeds' sampled means
    `port_sampled` (in the summaries' order) against the JAX checkpoints'
    `reference`, or, for a family of SETTLE_BY_TRAINING (`port_sampled`
    None), the summaries' last-10 training means against the JAX records'
    `reference`."""
    by_training = family in SETTLE_BY_TRAINING
    if by_training != (port_sampled is None):
        raise ValueError(f'{family}: the rule reads '
                         + ('the last-10 training means, not sampled means'
                            if by_training else 'the seeds\' sampled means'))
    values = ([s['last10_train_return'] for s in summaries] if by_training
              else list(port_sampled))
    if not len(summaries) == len(values) == SETTLE_SEEDS:
        raise ValueError(f'the rule takes {SETTLE_SEEDS} seeds and their '
                         f'sampled means, not {len(summaries)} and '
                         f'{len(values)}')
    seeds = [seed_meets(family, s) for s in summaries]
    mean = statistics.fmean(values)
    sd = statistics.stdev(values)
    floor = min(reference) - sd
    seeds_hold = sum(seeds) >= SETTLE_SEEDS_TO_MEET
    measure_holds = mean >= floor
    return dict(family=family, thresholds=THRESHOLDS[family], seeds=seeds,
                seeds_met=sum(seeds), seeds_to_meet=SETTLE_SEEDS_TO_MEET,
                seeds_hold=seeds_hold,
                measure=('last10_train_return' if by_training
                         else 'sampled_mean'),
                mean=mean, sd=sd, reference=list(reference), floor=floor,
                measure_holds=measure_holds,
                verdict=('not a fault' if seeds_hold and measure_holds
                         else 'fault'))


def settle_by_precision(family: str, tags: Sequence[str],
                        summaries: Sequence[dict],
                        port_sampled: Sequence[float],
                        reference: Sequence[float]) -> dict:
    """`settle`'s verdict on seeds trained under the emulation of the TPU's
    default matmul precision (SETTLE_BY_PRECISION), with its outcome
    (PRECISION_OUTCOMES). Raises for another family or a tag of a run not
    trained under the emulation."""
    if family not in SETTLE_BY_PRECISION:
        raise ValueError(f'{family}: no precision rule')
    marker = SETTLE_BY_PRECISION[family] + '_run-'
    unmarked = [t for t in tags if marker not in t]
    if unmarked:
        raise ValueError(f'{unmarked}: not trained under the emulation '
                         f'(no {marker!r} in the tag)')
    out = settle(family, summaries, port_sampled, reference)
    return dict(out, precision='tpu_default',
                outcome=PRECISION_OUTCOMES[out['verdict']])


def settle_by_reference(family: str, port_summaries: Sequence[dict],
                        port_sampled: Sequence[float],
                        jax_summaries: Sequence[dict],
                        jax_sampled: Sequence[float]) -> dict:
    """The seed-spread rule's verdict (see SPREAD_SEEDS) on SPREAD_SEEDS
    port seeds against as many JAX seeds of the same command: each arm's
    summarize dicts and sampled means, in one order. Raises ValueError for
    another count of seeds or a sampled mean too many or too few."""
    from scipy.stats import fisher_exact, mannwhitneyu
    arms = dict(port=(port_summaries, port_sampled),
                jax=(jax_summaries, jax_sampled))
    for name, (summaries, sampled) in arms.items():
        if not len(summaries) == len(sampled) == SPREAD_SEEDS:
            raise ValueError(f'{name}: the rule takes {SPREAD_SEEDS} seeds '
                             f'and their sampled means, not '
                             f'{len(summaries)} and {len(sampled)}')
    out = dict(family=family, thresholds=THRESHOLDS[family])
    for name, (summaries, sampled) in arms.items():
        seeds = [seed_meets(family, s) for s in summaries]
        last10 = [s['last10_train_return'] for s in summaries]
        out[name] = dict(seeds=seeds, seeds_met=sum(seeds),
                         sampled_mean=statistics.fmean(sampled),
                         sampled_sd=statistics.stdev(sampled),
                         last10_mean=statistics.fmean(last10),
                         last10_sd=statistics.stdev(last10))
    met = [out[name]['seeds_met'] for name in arms]
    seeds_p = float(fisher_exact([[met[0], SPREAD_SEEDS - met[0]],
                                  [met[1], SPREAD_SEEDS - met[1]]],
                                 alternative='less')[1])
    measure_p = float(mannwhitneyu(port_sampled, jax_sampled,
                                   alternative='less').pvalue)
    seeds_hold, measure_holds = seeds_p >= SPREAD_P, measure_p >= SPREAD_P
    verdict = 'not a fault' if seeds_hold and measure_holds else 'fault'
    return dict(out, p=SPREAD_P, seeds_p=seeds_p, seeds_hold=seeds_hold,
                measure='sampled_mean', measure_p=measure_p,
                measure_holds=measure_holds, verdict=verdict,
                outcome=SPREAD_OUTCOMES[verdict])


def read_seed_spread(path: str) -> dict:
    """settle_by_reference's verdict on a committed seed-spread record
    (molgym_tpu_torch/records/seed_spread_<family>.json: for each arm,
    each seed's summarize dict, sampled mean and complete fraction)."""
    with open(path) as f:
        spread = json.load(f)

    def arm(name):
        seeds = spread[name]['seeds']
        return ([s['summary'] for s in seeds],
                [s['sampled_mean'] for s in seeds])
    (port_summaries, port_sampled), (jax_summaries, jax_sampled) = (
        arm('port'), arm('jax'))
    return settle_by_reference(spread['family'], port_summaries,
                               port_sampled, jax_summaries, jax_sampled)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--tag', action='append',
                        help='e.g. sf6lj_run-1; once for each run')
    parser.add_argument('--results', action='append',
                        help="the run's results directory: once for all "
                        'runs, or once for each')
    parser.add_argument('--reference', help="the JAX record's results "
                        'directory (experiments/<experiment>/results); a '
                        'tag without a record there is left out')
    parser.add_argument('--max_steps', type=int,
                        help="the reference's first MAX_STEPS env steps "
                        'only (a record that a resumed run continued)')
    parser.add_argument('--family', choices=sorted(THRESHOLDS),
                        help="print the family's verdict (THRESHOLDS)")
    parser.add_argument('--sampled', type=float, action='append',
                        help="a port seed's sampled mean (diagnose_greedy), "
                        'once for each --tag, in its order: with '
                        '--reference_sampled and --family, prints the '
                        'settling rule\'s verdict (settle)')
    parser.add_argument('--reference_sampled', type=float, action='append',
                        help="a JAX checkpoint's sampled mean, once for each")
    parser.add_argument('--reference_tag', action='append',
                        help="a JAX record's tag in --reference, once for "
                        'each: with a --family of SETTLE_BY_TRAINING, prints '
                        "the settling rule's verdict from the records' "
                        'last-10 training means')
    parser.add_argument('--precision', action='store_true',
                        help='with --sampled: the seeds were trained under '
                        'the emulation of the TPU\'s default matmul '
                        'precision; prints settle_by_precision\'s verdict')
    parser.add_argument('--logs', action='append',
                        help="the run's log directory, once for all runs "
                        'or once for each: adds the probes of '
                        '--host_reward_mode=auto (the reference\'s from '
                        'the logs beside its results)')
    parser.add_argument('--jax_tag', action='append',
                        help="a JAX seed's tag of the same command, once for "
                        'each: with --sampled, --jax_sampled and --family, '
                        "prints the seed-spread rule's verdict "
                        '(settle_by_reference)')
    parser.add_argument('--jax_results', action='append',
                        help="the JAX seeds' results directory: once for "
                        'all, or once for each --jax_tag')
    parser.add_argument('--jax_sampled', type=float, action='append',
                        help="a JAX seed's sampled mean, once for each "
                        '--jax_tag, in its order')
    parser.add_argument('--seed_spread',
                        help='a committed seed-spread record '
                        '(molgym_tpu_torch/records/seed_spread_<family>.json)'
                        ": prints its verdict and both p-values, alone")
    args = parser.parse_args(argv)
    if args.seed_spread:
        out = dict(seed_spread=args.seed_spread,
                   settlement=read_seed_spread(args.seed_spread))
        print(json.dumps(out))
        return out
    if not (args.tag and args.results):
        parser.error('--tag and --results are required without '
                     '--seed_spread')
    if args.precision and not (args.family and args.sampled):
        parser.error('--precision needs --family and --sampled')
    if args.jax_tag and not (args.family and args.sampled and args.jax_results
                             and args.jax_sampled):
        parser.error('--jax_tag needs --family, --sampled, --jax_results '
                     'and --jax_sampled')

    def per_tag(name, given, tags=args.tag, tag_flag='tag'):
        if len(given) not in (1, len(tags)):
            parser.error(f'give --{name} once, or once for each --{tag_flag}')
        return given * (len(tags) // len(given))
    results = per_tag('results', args.results)
    logs = per_tag('logs', args.logs) if args.logs else [None] * len(args.tag)
    runs = []
    for tag, directory, log_dir in zip(args.tag, results, logs):
        out = dict(tag=tag, run=summarize(directory, tag))
        if log_dir:
            out['run']['selector'] = selector_probes(
                os.path.join(log_dir, f'{tag}.log'))
        if args.reference and os.path.exists(
                os.path.join(args.reference, f'{tag}_train.txt')):
            out['reference'] = summarize(args.reference, tag,
                                         args.max_steps)
            if log_dir:
                out['reference']['selector'] = selector_probes(os.path.join(
                    os.path.dirname(os.path.abspath(args.reference)), 'logs',
                    f'{tag}.log'))
        runs.append(out)
    out = runs[0] if len(runs) == 1 else dict(runs=runs)
    if args.family:
        out['verdict'] = meets(args.family, [r['run'] for r in runs])
        if args.jax_tag:
            out['settlement'] = settle_by_reference(
                args.family, [r['run'] for r in runs], args.sampled,
                [summarize(directory, tag) for tag, directory in zip(
                    args.jax_tag, per_tag('jax_results', args.jax_results,
                                          args.jax_tag, 'jax_tag'))],
                args.jax_sampled)
        elif args.sampled:
            if not args.reference_sampled:
                parser.error('--sampled needs --reference_sampled')
            settle_fn = (functools.partial(settle_by_precision,
                                           tags=args.tag)
                         if args.precision else settle)
            out['settlement'] = settle_fn(
                args.family, summaries=[r['run'] for r in runs],
                port_sampled=args.sampled, reference=args.reference_sampled)
        elif args.reference_tag:
            if not args.reference:
                parser.error('--reference_tag needs --reference')
            out['settlement'] = settle(
                args.family, [r['run'] for r in runs], None,
                [summarize(args.reference, tag)['last10_train_return']
                 for tag in args.reference_tag])
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
