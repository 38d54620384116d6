"""molgym_tpu_torch/curve_summary.py on the committed JAX records
(experiments/*/results/): the last-10 training means and the last 4
greedy evaluations that the thresholds of a full run on the card were set
from, the thresholds' rule on those records (sf6_pm6's seeds 1 and 3 meet
it, seed 2, the 6-atom local optimum of experiments/sf6_pm6/README.md,
does not; the single-seed records meet it; the seven other PM6
families' records meet theirs at the seeds their thresholds were set for, stochastic_pm6 with 2 full evals of 4, qm9_pm6's
4.25 atoms a mean over its formulas; the device-reward records of
sf6_bf16, organics, solvation and scaffold, whose two seeds need one full
eval of 4 and miss at 2), synthetic curves below a floor, the settling rule of a family that missed on greedy evaluations (settle) on
made-up seeds on both sides of each of its conditions, the seed-spread
rule (settle_by_reference) on synthetic arms with its size and power, and
the command line. The file reads experiments/ and writes
only under pytest's tmp_path."""
import json
import statistics
from pathlib import Path

import numpy as np
import pytest

from molgym_tpu_torch import curve_summary

EXPERIMENTS = Path(__file__).resolve().parents[1] / 'experiments'

# tag -> (experiment, the first env steps of the record (a resumed run
# continued sf6pm6_run-2 to 30,240), its last-10 training mean, its last 4
# greedy evals, their episode length)
RECORDS = {
    'sf6pm6_run-1': ('sf6_pm6', None, 0.4937,
                     (0.7171, 0.6576, 0.6721, 0.6826), 7),
    'sf6pm6_run-2': ('sf6_pm6', 15120, -0.1580,
                     (-0.1111, -0.1033, -0.1085, -0.1072), 6),
    'sf6pm6_run-3': ('sf6_pm6', None, 0.5256,
                     (0.7130, 0.7149, 0.7054, 0.6995), 7),
    'sf6int_run-1': ('sf6_internal', None, 0.5645,
                     (1.391, 1.311, 1.215, 0.968), 7),
    'sf6eht_run-1': ('sf6_eht', None, 0.9443,
                     (1.143, 1.138, 1.130, 1.129), 7),
    'h2oeht_run-1': ('h2o_eht', None, 0.3174,
                     (0.333, 0.335, 0.333, 0.332), 3),
    # the device-reward records (an episode length of each eval where they
    # differ): scaffold's two seeds evaluated 4 times each
    'sf6bf16_run-1': ('sf6_bf16', None, 1.1846,
                      (1.724, 1.586, 1.572, 1.544), 7),
    'organics_run-1': ('organics', None, 0.5127,
                       (0.701, 0.676, -0.146, 1.295), (6, 6, 5, 6)),
    'solv_run-1': ('solvation', None, 0.3619,
                   (0.581, 0.743, 0.948, 0.847), 9),
    'scaffold_run-1': ('scaffold', None, -0.5937,
                       (-0.6, -0.6, -0.6, 0.147), (1, 1, 2, 3)),
    'scaffold_run-2': ('scaffold', None, -0.5679,
                       (-0.6, -0.558, 0.104, 0.16), (1, 3, 3, 3)),
}


def record(tag):
    experiment, max_steps, *_ = RECORDS[tag]
    return curve_summary.summarize(str(EXPERIMENTS / experiment / 'results'),
                                   tag, max_steps)


@pytest.mark.parametrize('tag', list(RECORDS))
def test_record_summaries(tag):
    _experiment, _steps, last10, evals, length = RECORDS[tag]
    got = record(tag)
    assert round(got['last10_train_return'], 4) == last10
    digits = 4 if tag.startswith('sf6pm6') else 3
    assert [round(r, digits) for r, _n in got['last4_evals']] == list(evals)
    lengths = length if isinstance(length, tuple) else (length, ) * 4
    assert tuple(n for _r, n in got['last4_evals']) == lengths
    assert got['final_eval'] == got['last4_evals'][-1][0]


def test_sf6_pm6_records_meet_two_of_three():
    verdict = curve_summary.meets(
        'sf6_pm6', [record(f'sf6pm6_run-{s}') for s in (1, 2, 3)])
    assert verdict['seeds'] == [True, False, True]
    assert verdict['meets']


@pytest.mark.parametrize('family,tag', [('sf6_internal', 'sf6int_run-1'),
                                        ('sf6_eht', 'sf6eht_run-1'),
                                        ('h2o_eht', 'h2oeht_run-1'),
                                        ('sf6_bf16', 'sf6bf16_run-1'),
                                        ('organics', 'organics_run-1'),
                                        ('solvation', 'solv_run-1'),
                                        ('scaffold', 'scaffold_run-1'),
                                        ('scaffold', 'scaffold_run-2')])
def test_single_seed_records_meet_their_family(family, tag):
    assert RECORDS[tag][0] == family
    assert curve_summary.seed_meets(family, record(tag))


@pytest.mark.parametrize('tag', ['scaffold_run-1', 'scaffold_run-2'])
def test_scaffold_records_need_only_their_last_eval(tag, monkeypatch):
    """Each scaffold record places the whole bag above the eval floor in
    one of its last 4 evals only: at the default count of evals to meet,
    or at 2, it misses."""
    summary = record(tag)
    thresholds = curve_summary.THRESHOLDS['scaffold']
    assert thresholds[3] == 1
    for count in (thresholds[:3], thresholds[:3] + (2, )):
        monkeypatch.setitem(curve_summary.THRESHOLDS, 'scaffold', count)
        assert not curve_summary.seed_meets('scaffold', summary)
    # both seeds meet the family's threshold, so the family meets it
    monkeypatch.setitem(curve_summary.THRESHOLDS, 'scaffold', thresholds)
    assert curve_summary.meets('scaffold', [record('scaffold_run-1'),
                                            record('scaffold_run-2')])['meets']


# family -> (experiment, tag, the JAX seeds that meet its threshold)
PM6_FAMILIES = {
    'qm9_pm6': ('qm9_pm6', 'qm9pm6', (1, 2, 3)),
    'scaffold_pm6': ('scaffold_pm6', 'scafpm6', (1, 2, 3)),
    'solvation_pm6': ('solvation_pm6', 'solvpm6', (1, 2, 3)),
    'stochastic_pm6': ('stochastic_pm6', 'stochpm6', (1, 3)),
    'halides_pm6': ('halides_pm6', 'halo', (1, 2, 3)),
    'organics_pm6': ('organics_pm6', 'orgpm6', (1, 2)),
    'sf6_internal_pm6': ('sf6_internal_pm6', 'sf6int_pm6', (1, 2, 3)),
}


def family_records(family):
    experiment, tag, _seeds = PM6_FAMILIES[family]
    return [curve_summary.summarize(str(EXPERIMENTS / experiment / 'results'),
                                    f'{tag}_run-{s}') for s in (1, 2, 3)]


@pytest.mark.parametrize('family', list(PM6_FAMILIES))
def test_pm6_family_records_meet_their_thresholds(family):
    """Each family's JAX seeds meet its threshold exactly at the seeds
    named when it was set, so the family meets it; every record kept the
    transport its selector chose."""
    seeds = PM6_FAMILIES[family][2]
    summaries = family_records(family)
    verdict = curve_summary.meets(family, summaries)
    assert verdict['seeds'] == [s in seeds for s in (1, 2, 3)]
    assert verdict['meets']
    assert {s['transport'] for s in summaries} <= {'pipelined', 'serial'}


def _evals_at_nine(n):
    """stochastic_pm6's last 4 evals with `n` of them full (9 atoms, above
    the eval floor) and the others short, as its seeds' are."""
    return [(0.6, 9.0)] * n + [(0.3, 6.0)] * (4 - n)


@pytest.mark.parametrize('full', [0, 1, 2, 3])
def test_stochastic_pm6_needs_two_full_evals(full):
    summary = dict(last10_train_return=0.2, last4_evals=_evals_at_nine(full))
    assert curve_summary.seed_meets('stochastic_pm6', summary) == (full >= 2)
    # three evals of four for a family that names no count
    assert curve_summary.THRESHOLDS['stochastic_pm6'][3] == 2
    assert len(curve_summary.THRESHOLDS['halides_pm6']) == 3


@pytest.mark.parametrize('lengths,meets', [
    ((4.25, 4.25, 4.25, 4.0), True), ((4.25, 4.0, 4.0, 4.25), False),
    ((4.5, 4.25, 4.75, 3.0), True)])
def test_qm9_pm6_atoms_are_judged_by_the_mean(lengths, meets):
    """qm9_pm6's eval plays CNH, COH2, CFH3 and CO2H2 (3, 4, 5 and 5 atoms):
    an eval places every atom when its mean episode length reaches 4.25;
    one short episode (4.0) misses."""
    summary = dict(last10_train_return=0.3,
                   last4_evals=[(0.5, n) for n in lengths])
    assert curve_summary.seed_meets('qm9_pm6', summary) == meets
    seed1 = family_records('qm9_pm6')[0]
    assert [n for _r, n in seed1['last4_evals']] == [4.25, 4.25, 4.25, 4.0]


def test_selector_probes_of_either_package(tmp_path):
    """The selector's line in a JAX record's log (its probes in whole ms,
    the serial loop by its name) and in the port's, the last where a log
    holds several runs; no line, or no log: None."""
    got = curve_summary.selector_probes(
        str(EXPERIMENTS / 'scaffold_pm6' / 'logs' / 'scafpm6_run-3.log'))
    assert got == dict(choice='pipelined',
                       probe_ms={'pipelined': 1109.0, 'serial': 1138.0})
    log = tmp_path / 'x_run-1.log'
    log.write_text(
        "I: Host rewards via auto-selected host-loop rollout\n"
        "I: host-reward transport auto-selected 'in_step' (pipelined: "
        "963.551 ms, in_step: 761.816 ms)\n"
        "I: host-reward transport auto-selected 'pipelined' (pipelined: "
        "594.173 ms, in_step: 673.869 ms)\n")
    assert curve_summary.selector_probes(str(log)) == dict(
        choice='pipelined', probe_ms={'pipelined': 594.173,
                                      'in_step': 673.869})
    log.write_text('I: Starting PPO\n')
    assert curve_summary.selector_probes(str(log)) is None
    assert curve_summary.selector_probes(str(tmp_path / 'none.log')) is None


def _below(summary, how):
    """A copy of `summary` moved below its family's threshold one way."""
    out = dict(summary, last4_evals=list(summary['last4_evals']))
    if how == 'last10':
        out['last10_train_return'] = 0.3499
    elif how == 'two_evals_low':
        out['last4_evals'][:2] = [(0.5999, 7.0)] * 2
    else:   # two evals that placed an atom too few
        out['last4_evals'][1:3] = [(0.9, 6.0)] * 2
    return out


@pytest.mark.parametrize('how', ['last10', 'two_evals_low', 'atoms_short'])
def test_a_curve_below_a_floor_fails(how):
    good = record('sf6pm6_run-1')
    assert curve_summary.seed_meets('sf6_pm6', good)
    bad = _below(good, how)
    assert not curve_summary.seed_meets('sf6_pm6', bad)
    # one seed below makes 2 of 3 still; two below, 1 of 3, fail
    assert curve_summary.meets('sf6_pm6', [good, bad, good])['meets']
    assert not curve_summary.meets('sf6_pm6', [good, bad, bad])['meets']


def _write_run(directory, tag, returns, evals, reward_time=None):
    """A run's results as InfoSaver writes them: 140 env steps an
    iteration, an evaluation every other one."""
    directory.mkdir(parents=True, exist_ok=True)
    lines = dict(train=[], opt=[], eval=[])
    for i, ret in enumerate(returns):
        train = dict(time=2.0, return_mean=ret, total_num_steps=140 * i)
        if reward_time is not None:
            train['reward_time'] = reward_time * (5 if i == 0 else 1)
        lines['train'].append(train)
        lines['opt'].append(dict(iteration_time=10.0 if i == 0 else 1.0 + i,
                                 total_num_steps=140 * i))
    for i, (ret, length) in enumerate(evals):
        lines['eval'].append(dict(return_mean=ret, episode_length_mean=length,
                                  total_num_steps=280 * i))
    for mode, recs in lines.items():
        (directory / f'{tag}_{mode}.txt').write_text(
            ''.join(json.dumps(r) + '\n' for r in recs))


def test_command_line_sums_up_a_family(tmp_path, capsys):
    good = [(0.31, 3.0)] * 4
    for seed, (last, evals) in enumerate([(0.3, good), (0.2, good),
                                          (0.3, [(0.31, 2.0)] * 4)], 1):
        _write_run(tmp_path / str(seed) / 'results', f'h2oeht_run-{seed}',
                   [0.0] * 5 + [last] * 10, evals, reward_time=0.5)
    argv = ['--family=h2o_eht', f'--logs={tmp_path / "logs"}']
    (tmp_path / 'logs').mkdir()
    (tmp_path / 'logs' / 'h2oeht_run-2.log').write_text(
        "I: host-reward transport auto-selected 'in_step' (pipelined: "
        "700.5 ms, in_step: 600.25 ms)\n")
    for seed in (1, 2, 3):
        argv += [f'--tag=h2oeht_run-{seed}',
                 f'--results={tmp_path / str(seed) / "results"}']
    argv.append(f'--reference={EXPERIMENTS / "h2o_eht" / "results"}')
    out = curve_summary.main(argv)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == json.loads(
        json.dumps(out))
    # only seed 1 meets: seed 2's last-10 mean and seed 3's atoms fall short
    assert out['verdict']['seeds'] == [True, False, False]
    assert not out['verdict']['meets']
    first = out['runs'][0]
    assert first['reference']['last10_train_return'] == pytest.approx(
        0.3174, abs=5e-5)
    assert 'reference' not in out['runs'][1]   # no record of seed 2
    # the selector's probes from each run's log (seed 2's alone has one),
    # the reference's from the logs beside its results (none for h2o_eht)
    assert [r['run']['selector'] for r in out['runs']] == [None, dict(
        choice='in_step', probe_ms={'pipelined': 700.5, 'in_step': 600.25}),
        None]
    assert out['runs'][0]['reference']['selector'] is None
    run = first['run']
    assert run['iterations'] == 15 and run['last10_train_return'] == 0.3
    assert run['first_iteration_s'] == 10.0
    assert run['median_iteration_s'] == 8.5   # of 2.0 .. 15.0
    assert run['total_iteration_s'] == 10.0 + sum(range(2, 16))
    assert run['reward_share'] == 0.25   # the first iteration left out



def _nine(met):
    """Nine stochastic_pm6 seeds, the first `met` of them meeting its
    threshold (2 full evals of 4), the others 1 (a greedy miss)."""
    return [dict(last10_train_return=0.15,
                 last4_evals=_evals_at_nine(2 if i < met else 1))
            for i in range(9)]


# nine port seeds' sampled means, their mean 0.25
SAMPLED = [0.25 + d for d in
           (-0.15, -0.1, -0.05, 0.0, 0.0, 0.0, 0.05, 0.1, 0.15)]


@pytest.mark.parametrize('met,k,verdict', [
    (4, 0.0, 'not a fault'),     # both hold
    (3, 0.0, 'fault'),           # (a) one seed short
    (9, 0.0, 'not a fault'),
    (4, 0.999, 'not a fault'),   # (b) the mean just above the floor
    (4, 1.001, 'fault'),         # (b) just below it
    (2, 2.0, 'fault')])          # neither
def test_settling_rule_on_both_sides_of_each_condition(met, k, verdict):
    """settle: (a) at least 4 of 9 seeds meet the unchanged threshold; (b)
    the nine sampled means' mean at or above the lower JAX checkpoint's
    mean less the nine's standard deviation (n - 1). The lower JAX mean is
    set k standard deviations above the port's mean."""
    sd = statistics.stdev(SAMPLED)
    jax_low = statistics.fmean(SAMPLED) + k * sd
    got = curve_summary.settle('stochastic_pm6', _nine(met), SAMPLED,
                               [0.9, jax_low])
    assert got['seeds'] == [True] * met + [False] * (9 - met)
    assert got['seeds_met'] == met and got['seeds_to_meet'] == 4
    assert got['seeds_hold'] == (met >= 4)
    assert got['measure'] == 'sampled_mean'
    assert got['mean'] == pytest.approx(0.25)
    assert got['sd'] == sd
    assert got['floor'] == jax_low - sd
    assert got['measure_holds'] == (k < 1)
    assert got['verdict'] == verdict
    assert got['thresholds'] == (0.05, 0.45, 9, 2)


def test_settling_rule_takes_nine_seeds():
    with pytest.raises(ValueError, match='9 seeds'):
        curve_summary.settle('stochastic_pm6', _nine(4)[:8], SAMPLED[:8],
                             [0.3, 0.4])
    with pytest.raises(ValueError, match='9 seeds'):
        curve_summary.settle('stochastic_pm6', _nine(4), SAMPLED[:8],
                             [0.3, 0.4])


def test_command_line_settles_a_family(tmp_path, capsys):
    """--sampled once for each of nine tags and --reference_sampled: the
    verdict's settlement beside it."""
    argv = ['--family=stochastic_pm6', f'--results={tmp_path}']
    for seed in range(1, 10):
        evals = _evals_at_nine(2 if seed <= 4 else 0)
        _write_run(tmp_path, f'stochpm6_run-{seed}', [0.15] * 12, evals)
        argv += [f'--tag=stochpm6_run-{seed}',
                 f'--sampled={SAMPLED[seed - 1]}']
    argv += ['--reference_sampled=0.3', '--reference_sampled=0.35']
    out = curve_summary.main(argv)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == json.loads(
        json.dumps(out))
    assert out['verdict']['seeds'] == [True] * 4 + [False] * 5
    assert out['settlement']['seeds_met'] == 4
    assert out['settlement']['reference'] == [0.3, 0.35]
    assert out['settlement']['verdict'] == 'not a fault'


def _nine_scaffold(met, last10):
    """Nine scaffold seeds with the given last-10 means, the first `met` of
    them meeting its threshold (one full eval of 4 at 0.12 or more), the
    others none."""
    full, short = (0.15, 3.0), (-0.6, 1.0)
    return [dict(last10_train_return=m,
                 last4_evals=[full if i < met else short] + [short] * 3)
            for i, m in enumerate(last10)]


# nine port seeds' last-10 means, their mean -0.55
LAST10 = [-0.55 + d for d in
          (-0.03, -0.02, -0.01, 0.0, 0.0, 0.0, 0.01, 0.02, 0.03)]


@pytest.mark.parametrize('met,k,verdict', [
    (4, 0.0, 'not a fault'),     # both hold
    (3, 0.0, 'fault'),           # (a) one seed short
    (4, 0.999, 'not a fault'),   # (b) the mean just above the floor
    (4, 1.001, 'fault'),         # (b) just below it
    (2, 2.0, 'fault')])          # neither
def test_scaffold_rule_reads_the_last10_means(met, k, verdict):
    """scaffold's record kept no checkpoint: (b) holds the nine seeds'
    mean last-10 training return against the lower JAX record's less the
    nine's standard deviation; (a) as for every family. The lower record's
    is set k standard deviations above the port's mean."""
    assert 'scaffold' in curve_summary.SETTLE_BY_TRAINING
    sd = statistics.stdev(LAST10)
    jax_low = statistics.fmean(LAST10) + k * sd
    got = curve_summary.settle('scaffold', _nine_scaffold(met, LAST10), None,
                               [jax_low, jax_low + 0.03])
    assert got['seeds'] == [True] * met + [False] * (9 - met)
    assert got['measure'] == 'last10_train_return'
    assert got['mean'] == pytest.approx(-0.55)
    assert got['sd'] == sd
    assert got['floor'] == jax_low - sd
    assert got['measure_holds'] == (k < 1)
    assert got['verdict'] == verdict
    assert got['thresholds'] == (-0.60, 0.12, 3, 1)


def test_each_family_settles_by_its_measure():
    """solvation's rule reads sampled means (its JAX archive exists),
    scaffold's the last-10 means: the other measure is refused."""
    assert 'solvation' not in curve_summary.SETTLE_BY_TRAINING
    with pytest.raises(ValueError, match='sampled means'):
        curve_summary.settle('solvation', _nine_scaffold(4, LAST10), None,
                             [0.66])
    with pytest.raises(ValueError, match='last-10'):
        curve_summary.settle('scaffold', _nine_scaffold(4, LAST10), SAMPLED,
                             [-0.59])
    got = curve_summary.settle('solvation', _nine(4), SAMPLED, [0.66])
    assert got['measure'] == 'sampled_mean'
    assert got['floor'] == 0.66 - statistics.stdev(SAMPLED)


def test_command_line_settles_scaffold_by_its_records(tmp_path, capsys):
    """--reference_tag once for each JAX record: (b)'s reference is the
    lower of the two committed records' last-10 means (-0.5937)."""
    argv = ['--family=scaffold', f'--results={tmp_path}',
            f'--reference={EXPERIMENTS / "scaffold" / "results"}',
            '--reference_tag=scaffold_run-1', '--reference_tag=scaffold_run-2']
    for seed in range(10, 19):
        met = seed < 14
        evals = [(0.15 if met else -0.6, 3.0 if met else 1.0)] + [
            (-0.6, 1.0)] * 3
        _write_run(tmp_path, f'scaffold_run-{seed}',
                   [LAST10[seed - 10]] * 12, evals)
        argv.append(f'--tag=scaffold_run-{seed}')
    out = curve_summary.main(argv)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == json.loads(
        json.dumps(out))
    settled = out['settlement']
    assert settled['seeds_met'] == 4
    assert settled['reference'] == pytest.approx([-0.5937, -0.5679],
                                                 abs=5e-5)
    assert settled['floor'] == pytest.approx(
        min(settled['reference']) - statistics.stdev(LAST10))
    assert settled['verdict'] == 'not a fault'


@pytest.mark.parametrize('met,k,outcome', [
    (4, 0.0, "known difference by design: the record's TPU precision"),
    (3, 0.0, 'precision ruled out: the item stays open'),
    (4, 0.999, "known difference by design: the record's TPU precision"),
    (4, 1.001, 'precision ruled out: the item stays open')])
def test_precision_rule_settles_solvation_on_emulated_seeds(met, k, outcome):
    """settle_by_precision: solvation's rule, unchanged (settle), on nine
    seeds trained under tools/tpu_precision.py's emulation, the outcome
    beside the verdict; a tag without the emulation's marker, another
    family, or eight seeds are refused."""
    from molgym_tpu_torch.tools.tpu_precision import TAG_SUFFIX
    assert curve_summary.SETTLE_BY_PRECISION == {'solvation': TAG_SUFFIX}
    tags = [f'solv{TAG_SUFFIX}_run-{s}' for s in range(19, 28)]
    sd = statistics.stdev(SAMPLED)
    reference = [statistics.fmean(SAMPLED) + k * sd]
    got = curve_summary.settle_by_precision('solvation', tags,
                                            _solvation_seeds(met), SAMPLED,
                                            reference)
    want = curve_summary.settle('solvation', _solvation_seeds(met), SAMPLED,
                                reference)
    assert {k: v for k, v in got.items()
            if k not in ('precision', 'outcome')} == want
    assert got['precision'] == 'tpu_default' and got['outcome'] == outcome
    assert got['seeds_met'] == met
    with pytest.raises(ValueError, match='emulation'):
        curve_summary.settle_by_precision(
            'solvation', tags[:8] + ['solv_run-27'], _solvation_seeds(met),
            SAMPLED, reference)
    with pytest.raises(ValueError, match='no precision rule'):
        curve_summary.settle_by_precision('scaffold', tags, _nine(4),
                                          SAMPLED, reference)
    with pytest.raises(ValueError, match='9 seeds'):
        curve_summary.settle_by_precision('solvation', tags[:8],
                                          _solvation_seeds(met)[:8],
                                          SAMPLED[:8], reference)


def _solvation_seeds(met, n=9):
    """`n` solvation seeds at a last-10 of 0.3, the first `met` of them
    with 3 full evals of 4 at 0.6 (its threshold: 0.25, 0.55, 9 atoms), the
    others 2."""
    full, short = (0.6, 9.0), (0.2, 5.0)
    return [dict(last10_train_return=0.3,
                 last4_evals=[full] * (3 if i < met else 2) + [short] * (
                     1 if i < met else 2))
            for i in range(n)]


def test_command_line_settles_solvation_by_precision(tmp_path, capsys):
    """--precision with --sampled: the emulated seeds' settlement and its
    outcome; without --sampled it is refused."""
    argv = ['--family=solvation', f'--results={tmp_path}', '--precision']
    for seed, summary in zip(range(19, 28), _solvation_seeds(5)):
        tag = f'solv_tpudefault_run-{seed}'
        _write_run(tmp_path, tag, [0.3] * 12, summary['last4_evals'])
        argv += [f'--tag={tag}', f'--sampled={SAMPLED[seed - 19]}']
    out = curve_summary.main(argv + ['--reference_sampled=0.661021'])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == json.loads(
        json.dumps(out))
    settled = out['settlement']
    assert settled['seeds_met'] == 5
    assert settled['floor'] == pytest.approx(0.661021 - statistics.stdev(
        SAMPLED))
    assert settled['verdict'] == 'fault'
    assert settled['outcome'] == 'precision ruled out: the item stays open'
    with pytest.raises(SystemExit):
        curve_summary.main(['--family=solvation', f'--results={tmp_path}',
                            '--tag=solv_tpudefault_run-19', '--precision'])


# eighteen sampled means of one arm, drawn once (mean 0.45, sd 0.15)
SPREAD = [float(x) for x in
          np.random.default_rng(25).normal(0.45, 0.15, size=18)]


@pytest.mark.parametrize('port_met,jax_met,shift,verdict,fails', [
    (9, 9, 0.0, 'not a fault', None),    # the same arms
    (9, 9, -2.0, 'fault', 'measure'),    # port 2 sd lower: (b)
    (3, 15, 0.0, 'fault', 'seeds'),      # 3 of 18 against 15: (a)
    (15, 3, 0.0, 'not a fault', None)])  # one-sided: the port higher
def test_seed_spread_rule_on_synthetic_arms(port_met, jax_met, shift,
                                            verdict, fails):
    """settle_by_reference: (a) Fisher's exact test that the port meets
    less often, (b) Mann-Whitney's that its sampled means lie lower, each
    one-sided at p >= 0.05; the port's means are the JAX arm's in another
    order, moved by `shift` of their sd."""
    sd = statistics.stdev(SPREAD)
    port = [x + shift * sd for x in reversed(SPREAD)]
    out = curve_summary.settle_by_reference(
        'solvation', _solvation_seeds(port_met, 18), port,
        _solvation_seeds(jax_met, 18), SPREAD)
    assert out['verdict'] == verdict
    assert out['outcome'] == curve_summary.SPREAD_OUTCOMES[verdict]
    assert out['port']['seeds_met'] == port_met
    assert out['jax']['seeds_met'] == jax_met
    assert out['jax']['sampled_mean'] == pytest.approx(
        statistics.fmean(SPREAD))
    assert out['port']['last10_mean'] == pytest.approx(0.3)
    assert out['seeds_hold'] == (fails != 'seeds')
    assert out['measure_holds'] == (fails != 'measure')
    from scipy.stats import fisher_exact, mannwhitneyu
    assert out['seeds_p'] == pytest.approx(fisher_exact(
        [[port_met, 18 - port_met], [jax_met, 18 - jax_met]],
        alternative='less')[1])
    assert out['measure_p'] == pytest.approx(
        mannwhitneyu(port, SPREAD, alternative='less').pvalue)
    if fails == 'seeds':
        assert out['seeds_p'] < 0.01
    if shift == 0.0:
        assert out['measure_p'] > 0.4   # the same values


def test_seed_spread_rule_takes_eighteen_seeds_each():
    seeds = _solvation_seeds(9, 18)
    with pytest.raises(ValueError, match='port: the rule takes 18'):
        curve_summary.settle_by_reference('solvation', seeds[:17],
                                          SPREAD[:17], seeds, SPREAD)
    with pytest.raises(ValueError, match='jax: the rule takes 18'):
        curve_summary.settle_by_reference('solvation', seeds, SPREAD,
                                          seeds, SPREAD[:17])
    with pytest.raises(ValueError, match='port: .* 18 and 19'):
        curve_summary.settle_by_reference('solvation', seeds,
                                          SPREAD + [0.5], seeds, SPREAD)


def test_spread_rule_size():
    """The size and power that SPREAD_SEEDS' comment states: (a)'s false
    'fault' rate by exact enumeration of both arms' meet counts at meet
    rates 0.3, 0.5 and 0.7 (2.5-3.3%), (b)'s by 2,000 draws of normal
    means each way (5%, and about 0.9 for a shift of one sd)."""
    from scipy.stats import binom, fisher_exact, mannwhitneyu
    n, p_min = curve_summary.SPREAD_SEEDS, curve_summary.SPREAD_P
    rejected = np.array([[fisher_exact([[a, n - a], [b, n - b]],
                                       alternative='less')[1] < p_min
                          for b in range(n + 1)] for a in range(n + 1)])
    sizes = [float(binom.pmf(np.arange(n + 1), n, rate)
                   @ rejected @ binom.pmf(np.arange(n + 1), n, rate))
             for rate in (0.3, 0.5, 0.7)]
    assert sizes == pytest.approx([0.0247, 0.0326, 0.0247], abs=5e-4)
    rng = np.random.default_rng(0)
    jax = rng.normal(size=(2000, n))
    port = rng.normal(size=(2000, n))
    size = np.mean(mannwhitneyu(port, jax, alternative='less',
                                axis=1).pvalue < p_min)
    power = np.mean(mannwhitneyu(port - 1.0, jax, alternative='less',
                                 axis=1).pvalue < p_min)
    assert 0.035 <= size <= 0.065
    assert 0.86 <= power <= 0.93
    assert 1 - (1 - max(sizes)) * (1 - size) < 0.1


def test_command_line_settles_by_the_reference_seeds(tmp_path, capsys):
    """--jax_tag, --jax_results and --jax_sampled beside --sampled: the
    seed-spread rule over both arms' results; --jax_tag without
    --jax_sampled is refused."""
    argv = ['--family=solvation']
    for arm, seeds, met in (('port', range(28, 46), 12),
                            ('jax', range(3, 21), 10)):
        directory = tmp_path / arm
        for i, (seed, summary) in enumerate(zip(seeds,
                                                _solvation_seeds(met, 18))):
            tag = f'solv_run-{seed}'
            _write_run(directory, tag, [0.3] * 12, summary['last4_evals'])
            if arm == 'port':
                argv += [f'--tag={tag}', f'--sampled={SPREAD[i]}']
            else:
                argv += [f'--jax_tag={tag}',
                         f'--jax_sampled={SPREAD[17 - i]}']
    argv += [f'--results={tmp_path / "port"}',
             f'--jax_results={tmp_path / "jax"}']
    out = curve_summary.main(argv)
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == json.loads(
        json.dumps(out))
    settled = out['settlement']
    assert (settled['port']['seeds_met'], settled['jax']['seeds_met']) == (
        12, 10)
    assert settled['verdict'] == 'not a fault'
    with pytest.raises(SystemExit):
        curve_summary.main([a for a in argv
                            if not a.startswith('--jax_sampled')])


RECORDS_DIR = Path(curve_summary.__file__).resolve().parent / 'records'


# family -> (the port's meeting seeds, the JAX arm's, (a)'s p, (b)'s p):
# the verdicts PERF.md §6 reports
SPREAD_VERDICTS = {
    'solvation': (8, 11, 0.252543, 0.357987),
    'scaffold': (1, 3, 0.301299, 0.854414),
}


@pytest.mark.parametrize('family', list(SPREAD_VERDICTS))
def test_committed_seed_spreads_read_to_their_verdicts(family, capsys):
    """molgym_tpu_torch/records/seed_spread_<family>.json, read by
    --seed_spread: both arms' 18 fresh seeds (the port's solvation 28-45
    and scaffold 19-36 on the card, the JAX package's 3-20 on a CPU), each
    summary meeting THRESHOLDS as the record's numbers say, and the
    verdict with both p-values: not a fault, the reference's seed
    spread."""
    path = RECORDS_DIR / f'seed_spread_{family}.json'
    out = curve_summary.main([f'--seed_spread={path}'])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == json.loads(
        json.dumps(out))
    settled = out['settlement']
    port_met, jax_met, seeds_p, measure_p = SPREAD_VERDICTS[family]
    assert settled['family'] == family
    assert (settled['port']['seeds_met'], settled['jax']['seeds_met']) == (
        port_met, jax_met)
    assert settled['seeds_p'] == pytest.approx(seeds_p, abs=5e-7)
    assert settled['measure_p'] == pytest.approx(measure_p, abs=5e-7)
    assert settled['verdict'] == 'not a fault'
    assert settled['outcome'] == "the reference's seed spread"
    spread = json.loads(path.read_text())
    first = {'solvation': 28, 'scaffold': 19}[family]
    assert [s['seed'] for s in spread['port']['seeds']] == list(
        range(first, first + 18))
    assert [s['seed'] for s in spread['jax']['seeds']] == list(range(3, 21))
    assert spread['port']['trained_on'] == 'NVIDIA H100 80GB HBM3, 700.00 W'
    for arm in ('port', 'jax'):
        for s in spread[arm]['seeds']:
            assert s['tag'].endswith(f'_run-{s["seed"]}')
            assert 0.0 <= s['complete_fraction'] <= 1.0
            assert s['rollout_update_s'] > 0.0
            assert s['summary']['iterations'] == (50 if family == 'solvation'
                                                  else 24)
