"""The port's fwd+bwd profiler (molgym_tpu_torch/profile_minibatch.py)
against the JAX system's experiments/perf/profile_minibatch.py, on the CPU:
the batch recipe bit for bit at B = 140 and 560; the script's loss and
agent are bench.py's (tests/test_torch_bench.py holds the port's loss and
gradients against those at a reduced width); the port's own grad program,
its card-against-CPU gate and its FLOP count (exactly 4x from 140 to 560
distinct rows) at a reduced SF6 width (maxl 2, 2 CG levels, hidden 3,
width 16, set on the bench's constants);
the trace summary on made-up profiler events with known durations, counts
and parents; the sweep row against the script's run_sweep with its
timings and FLOPs stubbed; and that without a card the command exits 2
and prints nothing on stdout.

Tolerance: the gate's CPU pass, which takes the CG kernels' backward
formulas, within 1e-5 of each leaf's max |g| of the autograd pass."""
import ast
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from molgym_tpu_torch import bench as tbench
from molgym_tpu_torch import profile_minibatch as prof

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / 'experiments' / 'perf' / 'profile_minibatch.py'
REDUCED = dict(MAXL=2, NUM_LEVELS=2, HIDDEN=3, WIDTH=16)


def _script():
    """experiments/perf/profile_minibatch.py as a module (its top level
    imports numpy only)."""
    spec = importlib.util.spec_from_file_location('jax_profile_minibatch',
                                                  SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def script():
    return _script()


@pytest.fixture
def reduced(monkeypatch):
    """The reduced width on the bench's constants, the port's gates
    emptied."""
    for name, value in REDUCED.items():
        monkeypatch.setattr(tbench, name, value)
    monkeypatch.setattr(prof, '_GATES', {})


@pytest.mark.parametrize('batch', [140, 560])
def test_batch_is_the_scripts(script, batch):
    for ours, theirs in zip(prof.make_batch(batch), script.make_batch(batch)):
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
        assert ours.tobytes() == theirs.tobytes()
    # distinct rows, not the bench's seed rows tiled
    elements, positions, _bag = prof.make_batch(batch)
    assert len({p.tobytes() for p in positions}) == batch


def _function(path, outer, inner=None):
    """The ast of function `outer` in `path`, or of `inner` within it."""
    tree = ast.parse(path.read_text())
    found = next(n for n in ast.walk(tree)
                 if isinstance(n, ast.FunctionDef) and n.name == outer)
    if inner is None:
        return found
    return next(n for n in ast.walk(found)
                if isinstance(n, ast.FunctionDef) and n.name == inner)


def _call(node, name):
    return next(n for n in ast.walk(node) if isinstance(n, ast.Call)
                and getattr(n.func, 'id', None) == name)


def test_loss_and_agent_are_bench_pys():
    """The script's grad program differentiates bench.py's loss over the
    agent bench.py builds (the same statements, the same CovariantAC
    keywords), so tests/test_torch_bench.py's check of the port's loss and
    gradients against bench.py's at a reduced width holds for the script's
    too. (Running the script's build_grad_fn here takes over 80 s of op by
    op JAX on the CPU, most of it its init and act outside jit.)"""
    ours = _function(SCRIPT, 'build_grad_fn', 'loss_fn')
    theirs = _function(ROOT / 'bench.py', 'build_grad_fn', 'loss_fn')
    assert [ast.dump(n) for n in ours.body] == [
        ast.dump(n) for n in theirs.body if not isinstance(n, ast.Expr)]

    def keywords(call):
        return {k.arg: ast.unparse(k.value) for k in call.keywords}
    script_agent = keywords(_call(_function(SCRIPT, 'build_grad_fn'),
                                  'CovariantAC'))
    bench_agent = keywords(_call(_function(ROOT / 'bench.py', 'make_agent'),
                                 'CovariantAC'))
    assert script_agent == bench_agent
    assert 'encoder_dtype' in script_agent
    script, jbench = _script(), importlib.import_module('bench')
    for name in ('CANVAS', 'ZS', 'MAXL', 'NUM_LEVELS', 'HIDDEN', 'CPE',
                 'WIDTH'):
        assert getattr(script, name) == getattr(jbench, name) == getattr(
            tbench, name), name


def test_port_grad_program_gate_and_flops(reduced):
    """The port's own program on the CPU at the reduced width: parameters
    from torch.manual_seed(0), the agent's sampled actions; the gate
    (device 'cpu' stands for the card) passes at float order, its FLOP count comes
    from the CPU pass; the count at 560 distinct rows is 4 times 140's,
    each part of it, so B / 140 times the gate's count is the count."""
    fn, cpu_fn = prof.build_grad_fn(prof.BATCH, None, 'cpu')
    loss, grads = fn()
    cpu_loss, _cpu_grads = cpu_fn()
    assert float(loss) == float(cpu_loss)
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    again, _again_cpu = prof.build_grad_fn(prof.BATCH, None, 'cpu')
    assert float(again()[0]) == float(loss)

    gate = prof.gate('f32', 'cpu')
    # the CPU pass takes the CG kernels' backward formulas
    assert gate['max_grad_err_share'] <= 1e-5
    assert gate['tol'] == tbench.MODEL_TOL
    flops_140 = gate['flops_140']
    assert flops_140['total'] == (flops_140['cg_kernels']
                                  + flops_140['other_matrix_products']) > 0
    _fn, cpu_560 = prof.build_grad_fn(560, None, 'cpu')
    _result, flops_560 = tbench.count_flops(cpu_560)
    assert flops_560 == {k: 4 * v for k, v in flops_140.items()}
    assert prof.flops_at('f32', 560) == flops_560


def test_sweep_row_is_the_scripts(monkeypatch, script, capsys):
    """The script's run_sweep with its grad program, timer and FLOP count
    stubbed by known values: the port's sweep_row gives its ms, MFU% (as
    rounded there) and the GFLOP/s and ms per 140 rows of its lines."""
    ms = {140: 61.25, 560: 70.5, 2240: 108.75}
    flops = {b: 1.3805e11 * b / 140 for b in ms}
    peak = tbench.PEAK_FLOP_PER_S['float32']
    monkeypatch.setattr(script, 'build_grad_fn', lambda batch: (batch, None))
    monkeypatch.setattr(script, 'timed', lambda batch, params: ms[batch])
    monkeypatch.setattr(script, 'cost_flops',
                        lambda batch, params: (flops[batch], {}))
    monkeypatch.setattr(script, 'PEAK_FLOPS', peak)
    rows = script.run_sweep('f32')
    lines = capsys.readouterr().out.splitlines()[2:5]
    assert [r['batch'] for r in rows] == list(prof.SWEEP)
    for row, line in zip(rows, lines):
        ours = prof.sweep_row(row['batch'], ms[row['batch']],
                              flops[row['batch']], peak)
        assert round(ours['ms'], 3) == row['ms']
        assert round(ours['mfu_pct'], 4) == row['mfu_pct']
        assert ours['flops'] == row['flops']
        batch, ms_s, _flops, gflops, mfu, per_140 = line.split()
        assert f'{ours["gflop_per_s"]:.1f}' == gflops
        assert f'{ours["mfu_pct"]:.3f}' == mfu
        assert f'{ours["ms_per_140_rows"]:.3f}' == per_140
    assert prof.sweep_row(2240, 160.0, 16.0e12, 16.0e12)['mfu_pct'] == 625.0


class _Events:
    """Made-up torch.profiler events: host events (operators and CUDA
    runtime calls, a runtime call's CPU parent the operator it is called
    in) and device events, a device event sharing its correlation id with
    the runtime call that launched it."""

    def __init__(self):
        self.events, self.next_id = [], 1000

    def _new(self, **fields):
        self.next_id += 1
        event = SimpleNamespace(**dict(dict(
            id=self.next_id, is_async=False, cpu_parent=None), **fields))
        self.events.append(event)
        return event

    def op(self, name, self_cpu_us):
        return self._new(name=name, device_type=DeviceType.CPU,
                         self_cpu_time_total=self_cpu_us)

    def launch(self, parent, kernel, us, call='cudaLaunchKernel'):
        runtime = self._new(name=call, device_type=DeviceType.CPU,
                            self_cpu_time_total=1.0, cpu_parent=parent)
        self.events.append(SimpleNamespace(
            id=runtime.id, name=kernel, device_type=DeviceType.CUDA,
            is_async=False, cpu_parent=None, self_cpu_time_total=0.0,
            self_device_time_total=us))


LONG = 'void cutlass::Kernel2<cutlass_80_simt_sgemm_' + 'x' * 150 + '>(int)'
SQUARE = 'void (anonymous namespace)::cg_square_kernel<float, 4>(int)'
ELEMENTWISE = 'void at::native::elementwise<4>(int)'


def _events(iters):
    """`iters` steps: aten::mm launching LONG (30 us) and a reduction (4
    us), a custom Function launching cg_square_kernel (6 us), aten::mul
    launching an elementwise kernel twice (1 us each) and a kernel of no
    device time, a memset whose runtime call has no operator around it
    (0.5 us), a kernel whose runtime call is not among the events (2 us),
    and an operator that launches nothing; before them three pad kernels
    (bench.PAD_KERNEL), which the records leave out with their runtime
    calls."""
    ev = _Events()
    for _ in range(3):   # bench.pad_profiler's, left out
        ev.launch(None, 'at::cuda::(anonymous namespace)::spin_kernel(long)',
                  1.0)
    for _ in range(iters):
        mm = ev.op('aten::mm', 20.0)
        ev.launch(mm, LONG, 30.0, call='cuLaunchKernel')
        ev.launch(mm, 'splitKreduce_kernel', 4.0)
        ev.launch(ev.op('_SquareFn', 15.0), SQUARE, 6.0)
        mul = ev.op('aten::mul', 8.0)
        ev.launch(mul, ELEMENTWISE, 1.0)
        ev.launch(mul, ELEMENTWISE, 1.0)
        ev.launch(mul, 'empty_kernel', 0.0)
        ev.op('aten::view', 2.0)
        ev.launch(None, 'Memset (Device)', 0.5, call='cudaMemsetAsync')
        ev.events.append(SimpleNamespace(
            id=1, name='lost_kernel', device_type=DeviceType.CUDA,
            is_async=False, self_cpu_time_total=0.0,
            self_device_time_total=2.0))
    return ev.events


def test_trace_summary_of_made_up_events():
    iters = 4
    kernels, op_cpu, all_cpu, counts = prof.trace_records(_events(iters))
    assert sorted(kernels, key=lambda k: k.name) == sorted([
        prof.KernelRecord(LONG, 30.0 * iters, iters, 'aten::mm'),
        prof.KernelRecord('splitKreduce_kernel', 4.0 * iters, iters,
                          'aten::mm'),
        prof.KernelRecord(SQUARE, 6.0 * iters, iters, '_SquareFn'),
        prof.KernelRecord(ELEMENTWISE, 2.0 * iters, 2 * iters, 'aten::mul'),
        prof.KernelRecord('Memset (Device)', 0.5 * iters, iters, None),
        prof.KernelRecord('lost_kernel', 2.0 * iters, iters, None)],
        key=lambda k: k.name)
    assert op_cpu == {'aten::mm': 20.0 * iters, '_SquareFn': 15.0 * iters,
                      'aten::mul': 8.0 * iters}
    # the operators' 45 us and 7 runtime calls' 1 us each, a step
    assert all_cpu == 52.0 * iters
    assert counts == dict(cpu_events=11 * iters, runtime_calls=7 * iters,
                          device_events=7 * iters)

    s = prof.summarize_trace(kernels, op_cpu, all_cpu, iters,
                             wall_ms=0.5 * iters)
    total = 44.5
    assert s['device_ms_per_step'] == pytest.approx(total / 1e3)
    assert s['wall_ms_per_step'] == 0.5
    assert s['idle_share'] == pytest.approx(1 - total / 500)
    assert s['launches_per_step'] == 7
    assert s['linked_share'] == pytest.approx(5 / 7)
    assert s['grouped_by'] == 'operator, else kernel name prefix'
    assert s['launching_ops_cpu_ms_per_step'] == pytest.approx(0.043)
    assert s['cpu_self_ms_per_step'] == pytest.approx(0.052)
    assert [(r['name'], r['us_per_step'], r['launches_per_step'])
            for r in s['kernels']] == [
        (LONG[:110], 30.0, 1), (SQUARE, 6.0, 1),
        ('splitKreduce_kernel', 4.0, 1), (ELEMENTWISE, 2.0, 2),
        ('lost_kernel', 2.0, 1), ('Memset (Device)', 0.5, 1)]
    assert len(s['kernels'][0]['name']) == 110
    assert sum(r['pct'] for r in s['kernels']) == pytest.approx(100)
    assert s['kernels'][0]['pct'] == pytest.approx(100 * 30 / total)
    assert [(r['group'], r['us_per_step'], r['launches_per_step'],
             r['cpu_us_per_step']) for r in s['rollup']] == [
        ('aten::mm', 34.0, 2, 20.0), ('_SquareFn', 6.0, 1, 15.0),
        ('aten::mul', 2.0, 2, 8.0), ('kernel: lost_kernel', 2.0, 1, 0.0),
        ('kernel: Memset', 0.5, 1, 0.0)]
    assert sum(r['pct'] for r in s['rollup']) == pytest.approx(100)
    assert prof.port_kernel_launches(s)['cg_square_fused_ri'] == 1
    assert prof.port_kernel_launches(s)['cg_square_fused_ri_bwd'] == 0
    lines = prof.trace_lines(s)
    assert lines[0].startswith('total device op time: 0.044 ms per step '
                               f'(x{iters} steps traced)')
    assert lines[2] == f'{30.0:>9.1f} {67.4:>5.1f}% {1:>6}  {LONG[:110]}'


def test_launches_a_step_floor_the_count():
    """A kernel launched 5 times over 2 steps: 2 a step in the table (the
    script's count // iters), 2.5 in the rollup and the total."""
    s = prof.summarize_trace([prof.KernelRecord('k', 10.0, 5, 'aten::add')],
                             {'aten::add': 4.0}, 6.0, 2, 1.0)
    assert s['kernels'][0]['launches_per_step'] == 2
    assert s['rollup'][0]['launches_per_step'] == 2.5
    assert s['launches_per_step'] == 2.5
    assert s['grouped_by'] == 'operator' and s['linked_share'] == 1.0
    assert s['launching_ops_cpu_ms_per_step'] == 0.002
    assert s['cpu_self_ms_per_step'] == 0.003


def test_name_prefix():
    assert prof.name_prefix('void at::native::vectorized_elementwise_kernel<4,'
                            ' at::native::AddFunctor<float>>(int)') == (
        'at::native::vectorized_elementwise_kernel')
    assert prof.name_prefix('Memcpy HtoD (Pageable -> Device)') == (
        'Memcpy HtoD')
    assert prof.name_prefix(SQUARE) == 'cg_square_kernel'
    assert prof.name_prefix('void at::native::(anonymous namespace)::'
                            'CatArrayBatchedCopy<float>(int)') == (
        'at::native::CatArrayBatchedCopy')


def test_main_without_a_card_exits_2_and_prints_nothing(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for argv in ([], ['--sweep', '--trace'], ['--dtype', 'bf16']):
        assert prof.main(argv) == 2
        out = capsys.readouterr()
        assert out.out == ''
        assert 'no CUDA device' in out.err


def test_command_without_a_card_exits_2_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip('a card is visible')
    res = subprocess.run([sys.executable, '-m',
                          'molgym_tpu_torch.profile_minibatch', '--sweep',
                          '--trace'], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 2
    assert res.stdout == ''


def test_no_backend_switch_and_no_reference_import():
    from tests.test_torch_package import _imported_modules, _port_files
    path = ROOT / 'molgym_tpu_torch' / 'profile_minibatch.py'
    assert path in _port_files()
    tops = {name.split('.')[0] for name in _imported_modules(path)}
    assert not tops & {'jax', 'jaxlib', 'flax', 'optax', 'molgym_tpu'}
    options = {a.dest for a in prof.build_parser()._actions}
    assert options == {'help', 'sweep', 'trace', 'batch', 'dtype'}
