"""Package rules of the PyTorch port: it imports nothing of JAX or of
molgym_tpu, and its entry points refuse to run on the CPU unless asked."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'molgym_tpu')


def _port_files():
    files = sorted((ROOT / 'molgym_tpu_torch').rglob('*.py'))
    files.append(ROOT / 'chip_smoke.py')
    return files


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, 'attr', getattr(
                node.func, 'id', None)) in ('import_module', '__import__'):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 20
    bad = []
    for path in files:
        for name in _imported_modules(path):
            top = name.split('.')[0]
            if top in FORBIDDEN:
                bad.append(f'{path.relative_to(ROOT)}: {name}')
    assert not bad, bad


def test_kernel_sources_are_in_the_package():
    from molgym_tpu_torch import cuda_build
    assert set(cuda_build.KERNEL_SOURCES) == {
        'cg_aggregate', 'cg_square', 'cg_aggregate_bwd', 'cg_square_bwd',
        'cg_product', 'cg_product_bwd', 'masked_softmax'}
    assert sorted(p.stem for p in cuda_build.CSRC.glob('*.cu')) == sorted(
        cuda_build.KERNEL_SOURCES)
    for name in cuda_build.KERNEL_SOURCES:
        src = cuda_build.CSRC / f'{name}.cu'
        assert src.exists()
        assert 'extern "C"' in src.read_text()


def test_an_edited_header_builds_anew(tmp_path, monkeypatch):
    """A library's name covers the headers of csrc/ as well as its source,
    so that an edit to a shared header is not served a stale build."""
    from molgym_tpu_torch import cuda_build
    (tmp_path / 'k.cu').write_text('#include "h.cuh"\n')
    (tmp_path / 'h.cuh').write_text('// one\n')
    monkeypatch.setattr(cuda_build, 'CSRC', tmp_path)
    before = cuda_build.library_path('k')
    (tmp_path / 'h.cuh').write_text('// two\n')
    assert cuda_build.library_path('k') != before
    (tmp_path / 'h.cuh').write_text('// one\n')
    assert cuda_build.library_path('k') == before


def test_new_entry_points_are_scanned():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for module in ('rl/ppo.py', 'rl/buffer.py', 'ops/scan_math.py',
                   'tools/driver.py', 'tools/model_io.py', 'tools/util.py',
                   'tools/model_util.py', 'tools/arg_parser.py', 'run.py',
                   'run_stochastic.py', 'ops/fused_cg.py',
                   'ops/fused_softmax.py', 'ops/kernel_common.py',
                   'ops/masked.py', 'ops/zmat.py', 'agents/internal.py',
                   'agents/schnet.py', 'convert.py', 'run_solvation.py',
                   'run_scaffold.py', 'run_qm9.py', 'structures.py',
                   'plot.py', 'equivariance.py', 'envs/vec_env.py',
                   'tools/analysis.py', 'tools/qm9_parser.py',
                   'parallel/mesh.py'):
        assert f'molgym_tpu_torch/{module}' in names


def test_run_experiment_refuses_cpu_without_device(monkeypatch, tmp_path):
    """No device named (or cuda named) and no card: the driver raises
    before it writes anything."""
    from molgym_tpu_torch.tools.arg_parser import build_default_argparser
    from molgym_tpu_torch.tools.driver import run_experiment
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    config = vars(build_default_argparser().parse_args([
        '--name=x', '--formulas=H2O', '--bag_scale=3', '--symbols=X,H,O',
        '--canvas_size=3', '--model=covariant', '--reward=device_lj',
        f'--results_dir={tmp_path / "results"}']))
    assert config['device'] == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        run_experiment(config)
    config.pop('device')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        run_experiment(config)
    assert not (tmp_path / 'results').exists()


def test_entry_points_refuse_cpu_without_device(monkeypatch):
    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.envs.environment import MolecularEnv
    from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
    from molgym_tpu_torch.spaces import ObservationSpace
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        CovariantAC(zs=(0, 1), canvas_size=3, network_width=8, maxl=1,
                    num_cg_levels=1, num_channels_hidden=2,
                    num_channels_per_element=1)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        MolecularEnv(make_lennard_jones_reward(), ObservationSpace(3, [0, 1]),
                     np.array([[0, 2]]))


def test_wrappers_raise_off_cpu_without_a_kernel():
    """A tensor on neither the CPU nor a CUDA card is refused, never
    computed by the plain version."""
    from molgym_tpu_torch.ops import fused_agg
    from molgym_tpu_torch.ops.cg import _fused_cg_table
    table3, _ = _fused_cg_table(2, 2, 1)
    a = torch.zeros(2, 4, device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        fused_agg.cg_square_fused_ri(a, a, table3)


def test_heads_take_the_kernel_route_off_the_cpu(monkeypatch):
    """Off the CPU neither the packed CG product nor the heads' softmax
    nor the fused categorical head reaches its plain version: each goes to
    the kernel wrapper, which refuses a device it has no kernel for."""
    from molgym_tpu_torch.distributions.discrete import (
        categorical_head, masked_categorical_probs)
    from molgym_tpu_torch.ops import cg, fused_cg, fused_softmax

    def fail(*args, **kwargs):
        raise AssertionError('the plain version was called')
    monkeypatch.setattr(fused_cg, 'cg_contract_ri_plain', fail)
    monkeypatch.setattr(fused_softmax, 'masked_softmax_plain', fail)
    monkeypatch.setattr(fused_softmax, 'masked_categorical_plain', fail)
    a = torch.zeros(3, 2, 4, device='meta')
    with pytest.raises(ValueError, match='cg_contract_ri: no kernel'):
        cg.cg_product_packed_ri(a, a, a, a, 2, 2, 1)
    with pytest.raises(ValueError, match='cg_contract_ri: no kernel'):
        cg.cg_product([torch.zeros(3, 2, 1, 2, device='meta')],
                      [torch.zeros(3, 2, 1, 2, device='meta')], 0)
    logits = torch.zeros(3, 5, device='meta')
    with pytest.raises(ValueError, match='masked_softmax: no kernel'):
        masked_categorical_probs(logits, logits > 0)
    # the fused head, in each of its modes
    index = torch.zeros(3, dtype=torch.int64, device='meta')
    for kwargs in (dict(index=index), dict(deterministic=True), {}):
        with pytest.raises(ValueError, match='masked_softmax: no kernel'):
            categorical_head(logits, logits > 0, None, **kwargs)


@pytest.mark.parametrize('model', ['internal', 'mlp'])
def test_internal_agents_refuse_cpu_without_device(monkeypatch, model):
    from molgym_tpu_torch.agents.internal import make_mlp_internal_agent
    from molgym_tpu_torch.agents.schnet import make_schnet_agent
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    build = make_schnet_agent if model == 'internal' else make_mlp_internal_agent
    with pytest.raises(RuntimeError, match='no CUDA device'):
        build(num_zs=3, canvas_size=4, network_width=8)


@pytest.mark.parametrize('model', ['internal', 'mlp'])
def test_internal_heads_take_the_kernel_route_off_the_cpu(monkeypatch, model):
    """Off the CPU the internal agent's heads (focus, element, kappa) never
    reach the plain head: act and evaluate go to the kernel wrapper, which
    refuses a device it has no kernel for."""
    from molgym_tpu_torch.agents.internal import make_mlp_internal_agent
    from molgym_tpu_torch.agents.schnet import make_schnet_agent
    from molgym_tpu_torch.ops import fused_softmax
    from molgym_tpu_torch.spaces import Observation

    def fail(*args, **kwargs):
        raise AssertionError('the plain version was called')
    monkeypatch.setattr(fused_softmax, 'masked_softmax_plain', fail)
    monkeypatch.setattr(fused_softmax, 'masked_categorical_plain', fail)
    build = make_schnet_agent if model == 'internal' else make_mlp_internal_agent
    agent = build(num_zs=3, canvas_size=4, network_width=8, device='meta')
    obs = Observation(
        elements=torch.zeros(2, 4, dtype=torch.int64, device='meta'),
        positions=torch.zeros(2, 4, 3, device='meta'),
        bag=torch.ones(2, 3, dtype=torch.int64, device='meta'))
    with pytest.raises(ValueError, match='masked_softmax: no kernel'):
        agent.act(obs, None)
    with pytest.raises(ValueError, match='masked_softmax: no kernel'):
        agent.act(obs, None, deterministic=True)
    with pytest.raises(ValueError, match='masked_softmax: no kernel'):
        agent.evaluate(obs, torch.zeros(2, 7, device='meta'))


def test_one_registry_counts_every_kernel():
    from molgym_tpu_torch.ops import fused_agg, kernel_common
    assert fused_agg.launch_counts is kernel_common.launch_counts
    encoder = {'cg_aggregate_edge_fused_ri', 'cg_aggregate_edge_fused_ri_bwd',
               'cg_square_fused_ri', 'cg_square_fused_ri_bwd'}
    # the encoder's four kernels also have a bf16 version each
    assert set(kernel_common.launch_counts) == encoder | {
        name + '_bf16' for name in encoder} | {
        'cg_contract_ri', 'cg_contract_ri_bwd', 'masked_softmax',
        'masked_softmax_bwd'}
    kernel_common.launch_counts['masked_softmax'] = 3
    fused_agg.reset_launch_counts()
    assert not any(kernel_common.launch_counts.values())


def test_run_stochastic_refuses_cpu_without_device(monkeypatch, tmp_path):
    from molgym_tpu_torch import run_stochastic
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        run_stochastic.main([
            '--name=x', '--formulas=H2O', '--size_range=2,4', '--bag_scale=3',
            '--symbols=X,H,O', '--canvas_size=3', '--model=covariant',
            '--reward=device_lj', f'--results_dir={tmp_path / "results"}'])
    assert not (tmp_path / 'results').exists()


EXPERIMENTS = ROOT / 'experiments'


@pytest.mark.parametrize('driver', ['run_solvation', 'run_scaffold',
                                    'run_qm9'])
def test_new_drivers_refuse_cpu_without_device(monkeypatch, tmp_path, driver):
    """The solvation, scaffold and QM9 entry points, given no --device and
    no card, raise before they write anything; --device=cpu is the way to
    the CPU."""
    import importlib
    module = importlib.import_module(f'molgym_tpu_torch.{driver}')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    argv = {
        'run_solvation': ['--formulas=H2O', '--symbols=X,H,C,O',
                          '--initial_structure='
                          f'{EXPERIMENTS / "solvation" / "solute.xyz"}'],
        'run_scaffold': ['--formulas=H2O', '--symbols=X,H,O,Ar',
                         '--canvas_size=12', '--scaffold='
                         f'{EXPERIMENTS / "scaffold_pm6" / "cube.xyz"}'],
        'run_qm9': ['--qm9_dataset='
                    f'{EXPERIMENTS / "qm9_pm6" / "qm9_sample.tar.gz"}',
                    '--symbols=X,H,C,N,O,F', '--canvas_size=7'],
    }[driver] + ['--name=x', '--bag_scale=3', '--model=internal',
                 '--reward=device_lj', f'--results_dir={tmp_path / "results"}']
    with pytest.raises(RuntimeError, match='no CUDA device'):
        module.main(argv)
    assert not (tmp_path / 'results').exists()


# -- the host library's sources: the port's own copies ----------------------

PACKAGE = ROOT / 'molgym_tpu_torch'
REPO_CSRC = ROOT / 'csrc'


def _code_strings(path):
    """The string constants of a file's code, its docstrings left out."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docstrings.add(id(first.value))
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docstrings]


def test_host_sources_and_flags_are_the_ports():
    """The host library builds from the package's csrc/host/, with
    csrc/Makefile's CXXFLAGS and -shared and nothing forced in."""
    from molgym_tpu_torch import host_build
    assert host_build.CSRC == PACKAGE / 'csrc' / 'host'
    for name in host_build.SOURCES:
        assert (host_build.CSRC / name).is_file()
        assert PACKAGE in (host_build.CSRC / name).resolve().parents
    makefile = (REPO_CSRC / 'Makefile').read_text()
    flags = next(line.split('?=', 1)[1].split() for line in
                 makefile.splitlines() if line.startswith('CXXFLAGS'))
    assert host_build.CXXFLAGS == tuple(flags) + ('-shared', )
    assert '-include' not in host_build.CXXFLAGS


def test_no_port_module_reads_the_repo_csrc():
    """No module of the port, and not chip_smoke.py, names the repository's
    csrc/ or its libmolgym_host.so as a path: a code string 'csrc' is a
    path part only in modules whose CSRC lies in the package, and every
    other string naming csrc/ names the package's."""
    import importlib
    bad, joins = [], []
    for path in _port_files():
        for text in _code_strings(path):
            if text == 'csrc':
                joins.append(path)
            elif 'csrc/' in text and 'molgym_tpu_torch/csrc/' not in text:
                bad.append(f'{path.relative_to(ROOT)}: {text!r}')
            elif text.endswith('libmolgym_host.so'):
                bad.append(f'{path.relative_to(ROOT)}: {text!r}')
    assert not bad, bad
    assert {p.relative_to(ROOT).as_posix() for p in joins} == {
        'molgym_tpu_torch/cuda_build.py', 'molgym_tpu_torch/host_build.py'}
    for path in joins:
        module = importlib.import_module('molgym_tpu_torch.' + path.stem)
        assert PACKAGE in module.CSRC.parents


def _without_added_includes(copy: str, original: str) -> str:
    """`copy` less the #include lines that `original` does not have."""
    have = set(original.splitlines())
    return ''.join(line for line in copy.splitlines(keepends=True)
                   if not (line.startswith('#include')
                           and line.rstrip('\n') not in have))


# source -> (the original's lines, the port's): the one repair of a copy.
# ThreadPool::run_batch signals the batch's condition variable under its
# mutex, where the original signals after releasing it and the caller may
# already have returned and destroyed both (tests/test_torch_host_pool.py)
REPAIRS = {
    'molgym_host.cpp': (
        '          {\n'
        '            std::unique_lock<std::mutex> dlock(done_mu);\n'
        '            done.fetch_add(1);\n'
        '          }\n'
        '          done_cv.notify_one();\n',
        '          // Signal while holding done_mu: once the caller sees every'
        ' shard\n'
        '          // done it returns, and done_cv, a local of its frame, is'
        ' gone.\n'
        '          std::unique_lock<std::mutex> dlock(done_mu);\n'
        '          done.fetch_add(1);\n'
        '          done_cv.notify_one();\n'),
}


@pytest.mark.parametrize('name', ['molgym_host.cpp', 'eht.cpp', 'nddo.cpp'])
def test_host_source_copies_equal_the_originals(name):
    """Each of the port's C++ sources is its csrc/ original once the
    #include lines it adds are removed, but for its one repair in REPAIRS
    (molgym_host.cpp's thread pool); nddo.cpp adds <cstdio>, which the
    original uses (std::fprintf) without including."""
    from molgym_tpu_torch import host_build
    assert name in host_build.SOURCES
    copy = (host_build.CSRC / name).read_text()
    original = (REPO_CSRC / name).read_text()
    repaired = original
    if name in REPAIRS:
        was, now = REPAIRS[name]
        assert original.count(was) == 1 and now not in original
        repaired = original.replace(was, now)
    assert _without_added_includes(copy, original) == repaired
    added = set(copy.splitlines()) - set(original.splitlines())
    repair_lines = set(REPAIRS[name][1].splitlines()) if name in REPAIRS \
        else set()
    assert all(line.startswith('#include')
               for line in added - repair_lines)
    if name == 'nddo.cpp':
        assert added == {'#include <cstdio>'}


def _after_docstring(path):
    text = path.read_text()
    tree = ast.parse(text)
    doc = tree.body[0]
    assert isinstance(doc, ast.Expr) and isinstance(doc.value, ast.Constant)
    return '\n'.join(text.splitlines()[doc.end_lineno:])


def test_nddo_oracle_equals_the_jax_packages_but_for_its_docstring():
    ours = PACKAGE / 'calculators' / 'nddo_ref.py'
    original = ROOT / 'molgym_tpu' / 'calculators' / 'nddo_ref.py'
    assert _after_docstring(ours) == _after_docstring(original)
    assert 'molgym_tpu_torch/csrc/host/nddo.cpp' in ast.get_docstring(
        ast.parse(ours.read_text()))
