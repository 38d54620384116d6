"""The port's bench (molgym_tpu_torch/bench.py) against the JAX system's
bench.py, on the CPU: the batch recipe bit for bit; the fwd+bwd of
bench.py's loss at a reduced SF6 configuration (maxl 2, 2 CG levels,
hidden 3, width 16, set on both modules' constants) from bench.py's own
parameters and seed actions carried over by convert.py, for the f32 and
bf16 encoders and the internal (SchNet) agent; the FLOP count's linearity
in the batch's tiles; the record's names against bench.py's source; the
host-reward rollout's two transports; and that the bench neither times nor
prints anything without a card.

Tolerances: the loss within 1e-5 relative (f32; the bf16 encoder's within
0.05, the bf16 tests' gate for log-probs and values); every gradient
within 1e-4 of its leaf's max |g| (bf16: 0.03), a leaf below 1e-3 of the
largest leaf's held against that floor (tests/test_torch_ppo.py,
tests/test_torch_bf16.py, tests/test_torch_internal.py)."""
import ast
import importlib
import inspect
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import bench as jbench
from molgym_tpu.ops import cg as jcg
from molgym_tpu.spaces import Observation as JaxObservation
from molgym_tpu_torch import bench as tbench
from molgym_tpu_torch.calculators.native import METHOD_LJ
from molgym_tpu_torch.convert import (covariant_params_from_jax,
                                      internal_params_from_jax)

ROOT = Path(__file__).resolve().parents[1]
REDUCED = dict(MAXL=2, NUM_LEVELS=2, HIDDEN=3, WIDTH=16)
# the names the port's record may have that bench.py's has not
ADDED = {'fwd_bwd_ms_p50', 'fwd_bwd_ms_p90', 'fwd_bwd_samples',
         'device_busy_ms', 'device_idle_share', 'profiled_wall_ms',
         'device_idle_share_profiled', 'launches_per_fwd_bwd',
         'peak_memory_bytes', 'flops_per_fwd_bwd',
         'peak_flop_per_s', 'flop_count_note', 'env_steps_per_sec_pm6_serial',
         'env_steps_reps', 'gates', 'device', 'nproc', 'settings',
         'no_counterpart', 'auto_transport_probe_ms'}
COUNTERPARTS = {'ms_headline_rerun', 'mfu_est_pct', 'mfu_est_pct_batch_2240',
                'mfu_est_pct_bf16_2240', 'ms_batch_2240', 'ms_bf16',
                'ms_bf16_2240', 'ms_internal_agent', 'env_steps_per_sec_pm6',
                'env_steps_per_sec_pm6_serial', 'env_steps_per_sec_eht',
                'env_steps_per_sec_eht_serial'}
NO_COUNTERPART = {'ms_einsum_agg', 'vs_baseline', 'baseline_pin_ms',
                  'baseline_live_ms'}


@pytest.mark.parametrize('batch', [jbench.BATCH, jbench.SEED_BATCH])
def test_batch_recipe_is_bench_pys(batch):
    for ours, theirs in zip(tbench.make_batch(batch=batch),
                            jbench.make_batch(batch=batch)):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        assert ours.tobytes() == theirs.tobytes()


@pytest.fixture
def reduced(monkeypatch):
    """A reduced SF6 configuration on both benches' constants, their seed
    caches emptied."""
    for name, value in REDUCED.items():
        monkeypatch.setattr(jbench, name, value)
        monkeypatch.setattr(tbench, name, value)
    monkeypatch.setattr(jbench, '_SEED_CACHE', {})
    monkeypatch.setattr(tbench, '_SEED_CACHE', {})


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep='/').items()}


def _jax_loss(jagent, params, arrays, actions):
    """bench.py's loss of the JAX agent (jitted, as its grad program is)."""
    def loss(prm, obs, act):
        logp, ent, v = jagent.apply(prm, obs, act, method=jagent.evaluate)
        return (jnp.mean(logp) + 0.5 * jnp.mean(jnp.square(v))
                + 0.01 * jnp.mean(ent))
    obs = JaxObservation(*(jnp.asarray(a) for a in arrays))
    return float(jax.jit(loss)(params, obs, jnp.asarray(actions)))


def _assert_grads_close(names, grads, ref, tol):
    """Each leaf within `tol` of its max |g|, a leaf below 1e-3 of the
    largest leaf's held against that floor."""
    grads = dict(zip(names, grads))
    assert set(grads) == set(ref)
    floor = 1e-3 * max(float(g.abs().max()) for g in ref.values())
    for name, g in ref.items():
        assert grads[name] is not None, name
        scale = max(float(g.abs().max()), floor)
        err = float((grads[name] - g).abs().max())
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize('encoder_dtype', [None, 'bfloat16'])
def test_fwd_bwd_matches_bench_py(reduced, encoder_dtype):
    """bench.py's seed batch and grad program at B = SEED_BATCH against the
    port's grad fn on its parameters and seed actions; then the port at two
    tiles gives the same loss (the rows repeated)."""
    params, *arrays, actions = jbench._seed_batch(encoder_dtype)
    # the bf16 JAX agent's aggregate and square as its Pallas kernels
    # compute them (interpret mode), as tests/test_torch_bf16.py runs it
    jcg.set_aggregate_backend('auto' if encoder_dtype is None
                              else 'pallas_interpret')
    try:
        jgrad_fn, jparams = jbench.build_grad_fn(batch=jbench.SEED_BATCH,
                                                 encoder_dtype=encoder_dtype)
        jgrads = covariant_params_from_jax(_flat(jgrad_fn(jparams)))
        jloss = _jax_loss(jbench.make_agent(encoder_dtype), params, arrays,
                          actions)
    finally:
        jcg.set_aggregate_backend('auto')

    agent = tbench.make_agent(encoder_dtype, 'cpu')
    missing, unexpected = agent.load_state_dict(
        covariant_params_from_jax(_flat(params)), strict=True)
    assert not missing and not unexpected
    fn = tbench.make_grad_fn(agent, *tbench.tiled(
        arrays, actions, tbench.SEED_BATCH, 'cpu'))
    loss, grads = fn()
    if encoder_dtype is None:
        assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
        _assert_grads_close(fn.names, grads, jgrads, 1e-4)
    else:
        assert abs(float(loss) - jloss) <= 0.05
        _assert_grads_close(fn.names, grads, jgrads, 0.03)

    twice = tbench.make_grad_fn(agent, *tbench.tiled(
        arrays, actions, 2 * tbench.SEED_BATCH, 'cpu'))
    loss2, _grads = twice()
    assert abs(float(loss2) - float(loss)) <= 1e-6 * abs(float(loss))


def test_port_seed_batch_tiles_to_the_batch(reduced):
    """The port's own seed batch: SEED_BATCH rows of sampled actions, the
    bf16 agent with the f32 agent's parameters, tiled with the
    observations."""
    state, *arrays, actions = tbench.seed_batch()
    state16, *arrays16, _actions16 = tbench.seed_batch('bfloat16')
    assert actions.shape == (tbench.SEED_BATCH, 6)
    assert all(torch.equal(state[k], state16[k]) for k in state)
    for ours, again in zip(arrays, arrays16):
        assert np.array_equal(ours, again)
    obs, acts = tbench.tiled(arrays, actions, 3 * tbench.SEED_BATCH, 'cpu')
    assert obs.elements.dtype == obs.bag.dtype == torch.int64
    assert torch.equal(obs.positions[2 * tbench.SEED_BATCH:],
                       torch.from_numpy(arrays[1]))
    assert torch.equal(acts[tbench.SEED_BATCH:2 * tbench.SEED_BATCH],
                       torch.from_numpy(actions))
    with pytest.raises(ValueError, match='multiple'):
        tbench.tiled(arrays, actions, 15, 'cpu')


def _closure(grad_fn):
    """The values a bench.py grad program closes over (its loss function's
    agent, obs and actions): jax.jit and jax.grad keep the function they
    wrap as __wrapped__."""
    fn = grad_fn
    while hasattr(fn, '__wrapped__'):
        fn = fn.__wrapped__
    return inspect.getclosurevars(fn).nonlocals


def test_internal_fwd_bwd_matches_bench_py(reduced):
    """bench.py's build_internal_grad_fn at width 16 (B = 140, not tiled)
    against the port's grad fn on its parameters, observations and
    actions."""
    jgrad_fn, jparams = jbench.build_internal_grad_fn()
    bound = _closure(jgrad_fn)
    obs = bound['obs']
    arrays = tuple(np.asarray(x) for x in (obs.elements, obs.positions,
                                           obs.bag))
    for ours, theirs in zip(arrays, jbench.make_batch()):
        assert np.array_equal(ours, theirs)
    actions = np.array(bound['actions'])
    jgrads = internal_params_from_jax(_flat(jgrad_fn(jparams)))
    jloss = _jax_loss(bound['agent'], jparams, arrays, actions)

    agent = tbench.make_internal_agent('cpu')
    agent.load_state_dict(internal_params_from_jax(_flat(jparams)),
                          strict=True)
    fn = tbench.make_grad_fn(agent, tbench.observation(arrays, 'cpu'),
                             torch.from_numpy(actions))
    loss, grads = fn()
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    _assert_grads_close(fn.names, grads, jgrads, 1e-4)


@pytest.mark.parametrize('encoder_dtype', [None, 'bfloat16'])
def test_flop_count_doubles_with_the_tiles(reduced, encoder_dtype):
    """count_flops: linear in the tiles, its CG part and the rest both
    there; the gradients it returns (the CG calls' plain backward formulas)
    are autograd's of the plain versions within float order; the plain
    versions are put back."""
    from molgym_tpu_torch.ops import fused_agg, fused_cg
    plain = (fused_cg.cg_contract_ri_plain, fused_agg.cg_square_fused_ri_plain,
             fused_agg.cg_aggregate_edge_fused_ri_plain)
    fns = [tbench.build_grad_fn(n, encoder_dtype, 'cpu')
           for n in (tbench.SEED_BATCH, 2 * tbench.SEED_BATCH)]
    (loss, grads), count = tbench.count_flops(fns[0])
    counts = [count, tbench.count_flops(fns[1])[1]]
    assert counts[0]['other_matrix_products'] > 0
    assert counts[0]['cg_kernels'] > 0
    assert counts[0]['total'] == (counts[0]['other_matrix_products']
                                  + counts[0]['cg_kernels'])
    assert counts[1] == {k: 2 * v for k, v in counts[0].items()}
    assert plain == (fused_cg.cg_contract_ri_plain,
                     fused_agg.cg_square_fused_ri_plain,
                     fused_agg.cg_aggregate_edge_fused_ri_plain)
    ref_loss, ref_grads = fns[0]()
    assert float(loss) == float(ref_loss)
    _assert_grads_close(fns[0].names, grads,
                        dict(zip(fns[0].names, ref_grads)), 1e-5)


def test_cg_ops_count_the_nonzeros():
    """The CG product's operations come from its table's nonzeros, far
    below the dense table's multiply-adds."""
    from molgym_tpu_torch.ops import cg, fused_agg, fused_cg
    table3, _sl = cg._fused_cg_table(3, 3, 2)
    m1, m2, k = table3.shape
    nnz = int(np.count_nonzero(table3))
    tabs = fused_cg.kernel_tables(table3, 'cpu')
    assert tabs['nnz'] == nnz
    assert tbench.product_ops(7, tabs) == 7 * 10 * nnz
    assert tbench.product_ops(7, tabs, True) == 7 * (
        4 * nnz + 16 * tabs['n_live'])
    assert 10 * nnz < 8 * m1 * m2 * k
    sq = fused_agg._kernel_tables('square', table3, None, None, 'cpu')
    assert tbench.square_ops(7, sq) == 7 * (6 * sq['slot_mn'].numel()
                                            + 4 * sq['nnz'])
    agg = fused_agg._kernel_tables('aggregate', table3, None, None, 'cpu')
    assert agg['nnz'] == nnz
    edges = 2 * 3 * 3 * 4 * m1
    assert tbench.aggregate_ops(2, 3, 4, m1, m2, agg) == (
        edges * (2 + 8 * m2) + 2 * 3 * 4 * nnz * 4)


def _bench_py_names():
    """bench.py's record names: the headline's keys and its extra's, the
    guard('...') extras and every extras['...']."""
    tree = ast.parse((ROOT / 'bench.py').read_text())
    names, metric = set(), None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == 'guard'):
            names.add(node.args[0].value)
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.value, ast.Name)
              and node.value.id == 'extras'
              and isinstance(node.slice, ast.Constant)):
            names.add(node.slice.value)
        elif isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if 'metric' in keys:
                names.update(keys)
                metric = node.values[keys.index('metric')].value
                extra = node.values[keys.index('extra')]
                names.update(k.value for k in extra.keys)
    return names, metric


def test_record_names_are_bench_pys():
    names, metric = _bench_py_names()
    assert {'metric', 'value', 'unit', 'vs_baseline', 'extra',
            'env_steps_per_sec_pm6', 'ms_einsum_agg', 'skipped',
            'mfu_est_pct_batch_2240', 'cache_entries_at_start'} <= names
    assert metric == tbench.METRIC
    ours = {'metric', 'value', 'unit', 'vs_baseline', 'extra'} | set(
        tbench.EXTRA_NAMES)
    assert len(ours) == 5 + len(tbench.EXTRA_NAMES)
    assert set(tbench.NO_COUNTERPART) == NO_COUNTERPART
    assert set(tbench.COUNTERPARTS) == COUNTERPARTS
    # vs_baseline stays in the record's shape, as null
    assert not (ours - {'vs_baseline'}) & NO_COUNTERPART
    assert names <= ours | NO_COUNTERPART, names - ours - NO_COUNTERPART
    assert ours - names <= ADDED, ours - names - ADDED
    assert COUNTERPARTS <= ours
    assert {'auto_transport_pm6', 'auto_transport_eht'} <= names & ours


def _full_record():
    extra = {name: 1.0 for name in tbench.EXTRA_NAMES}
    extra['no_counterpart'] = dict(tbench.NO_COUNTERPART)
    extra.update(auto_transport_pm6='pipelined', auto_transport_eht='in_step')
    return dict(metric=tbench.METRIC, value=50.0, unit='ms', vs_baseline=None,
                extra=extra)


@pytest.mark.parametrize('fault', [None, 'missing', 'undeclared', 'nan',
                                   'zero', 'value', 'no_counterpart',
                                   'transport'])
def test_check_record(fault):
    record = _full_record()
    extra = record['extra']
    if fault == 'missing':
        del extra['ms_bf16_2240']
    elif fault == 'undeclared':
        extra['ms_einsum_agg'] = 1.0
    elif fault == 'nan':
        extra['env_steps_per_sec_eht_serial'] = math.nan
    elif fault == 'zero':
        extra['mfu_est_pct'] = 0.0
    elif fault == 'value':
        record['value'] = None
    elif fault == 'no_counterpart':
        del extra['no_counterpart']['vs_baseline']
    elif fault == 'transport':
        extra['auto_transport_eht'] = 'serial'   # the JAX name, not the port's
    if fault is None:
        tbench.check_record(record)
    else:
        with pytest.raises(AssertionError):
            tbench.check_record(record)


TINY = dict(zs=(0, 1, 8), canvas_size=3, network_width=16, maxl=2,
            num_cg_levels=2, num_channels_hidden=3, num_channels_per_element=2,
            num_gaussians=3, bag_scale=3, min_max_distance=(0.9, 1.8),
            beta=None)


def test_host_transports_agree_on_the_cpu():
    """The bench's host-reward rollout at a tiny config with the LJ host
    reward: both transports run, from one generator state the same
    trajectory, then a round of each from seeds of their own."""
    res = tbench.host_env_steps(METHOD_LJ, reps=2, device='cpu',
                                agent_kwargs=TINY, formula='H2O',
                                num_envs=4, num_steps=5)
    assert res['same_trajectory']
    for name in ('pipelined', 'serial'):
        readings = res['readings'][name]
        assert len(readings) == 2
        assert len({r['seed'] for r in readings}) == 2
        for r in readings:
            assert r['reward_calls'] == 5 and r['pool_batches'] == 5
            assert 0 < r['reward_share'] < 1 and r['env_steps_per_s'] > 0
        assert res['best'][name] == max(r['env_steps_per_s']
                                        for r in readings)
    seeds = [r['seed'] for rs in res['readings'].values() for r in rs]
    assert len(set(seeds)) == len(seeds) and tbench.SEED not in seeds


def test_auto_transport_chooses_on_the_cpu():
    """The bench's selector at a tiny config with the LJ host reward: four
    probes, two of them timed, then a choice, the faster."""
    res = tbench.auto_transport(METHOD_LJ, device='cpu', agent_kwargs=TINY,
                                formula='H2O', num_envs=4, num_steps=5)
    assert res['calls'] == 4
    assert set(res['probe_ms']) == set(tbench.TRANSPORTS)
    assert res['choice'] == min(res['probe_ms'], key=res['probe_ms'].get)


def test_same_rollout_check_sees_another_trajectory():
    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.calculators.native import NativeBatchCalculator
    from molgym_tpu_torch.calculators.reward_host import (
        TimedBatchCalculator, make_host_reward)
    from molgym_tpu_torch.envs.environment import MolecularEnv
    from molgym_tpu_torch.formula import string_to_formula
    from molgym_tpu_torch.rl.rollout import make_rollout_fn
    from molgym_tpu_torch.spaces import ObservationSpace

    space = ObservationSpace(canvas_size=3, zs=[0, 1, 8])
    calc = TimedBatchCalculator(NativeBatchCalculator(METHOD_LJ))
    env = MolecularEnv(make_host_reward(calc), space,
                       space.bag_from_formula(string_to_formula('H2O'))[None],
                       device='cpu')
    agent = CovariantAC(**TINY, device='cpu')
    rollout = make_rollout_fn(env, agent, 3)
    runs = [tbench.run_transport(rollout, agent, env, calc, 4, seed, 'cpu')
            for seed in (5, 5, 6)]
    tbench.check_same_rollout('same seed', runs[0][1], runs[1][1])
    with pytest.raises(AssertionError, match='another trajectory'):
        tbench.check_same_rollout('other seed', runs[0][1], runs[2][1])
    assert runs[0][0]['reward_calls'] == 3


def test_main_without_a_card_prints_no_metric(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert tbench.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ''
    assert 'no CUDA device' in out.err


def test_import_decides_nothing_about_the_card(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('the card was asked about at import')
    for name in ('is_available', 'device_count', 'current_device', 'init',
                 'get_device_name'):
        monkeypatch.setattr(torch.cuda, name, refuse)
    importlib.reload(tbench)
    assert tbench._SEED_CACHE == {}


def test_bench_is_scanned_and_imports_no_reference():
    """The package scan (tests/test_torch_package.py) covers the bench, and
    the bench imports neither JAX, nor molgym_tpu, nor the root bench.py."""
    from tests.test_torch_package import _imported_modules, _port_files
    path = ROOT / 'molgym_tpu_torch' / 'bench.py'
    assert path in _port_files()
    tops = {name.split('.')[0] for name in _imported_modules(path)}
    assert not tops & {'jax', 'jaxlib', 'flax', 'optax', 'molgym_tpu',
                       'bench'}
    assert tops <= {'__future__', 'argparse', 'inspect', 'json', 'math', 'os',
                    'subprocess', 'sys', 'time', 'typing', 'numpy', 'torch',
                    'molgym_tpu_torch'}
