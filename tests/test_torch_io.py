"""The port's copies of the JAX package's host-side helpers, held equal to
the originals on the CPU: the formula helpers, XYZ reading and writing
(the written text byte for byte) on every XYZ file in experiments/, the
QM9 parser on the committed sample and on malformed archives, the QM9 bag
selection, the SO(3) rotation helpers, and the analysis toolkit.

Tolerances: exact equality everywhere but the rotation helpers, which are
float64 numpy in both packages (held to 1e-12), and `apply_wigner`, which
both packages compute in float32 with another summation order (1e-6)."""
import io
import json
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from molgym_tpu import atoms as jatoms
from molgym_tpu import formula as jformula
from molgym_tpu.ops import so3 as jso3
from molgym_tpu.tools import analysis as janalysis
from molgym_tpu.tools import qm9_parser as jqm9
from molgym_tpu_torch import atoms, formula
from molgym_tpu_torch.ops import so3
from molgym_tpu_torch.run_qm9 import select_qm9_formulas
from molgym_tpu_torch.tools import analysis, qm9_parser

ROOT = Path(__file__).resolve().parents[1]
XYZ_FILES = sorted(str(p.relative_to(ROOT))
                   for p in (ROOT / 'experiments').rglob('*.xyz'))
QM9_SAMPLE = str(ROOT / 'experiments' / 'qm9_pm6' / 'qm9_sample.tar.gz')
FORMULAS = ['SF6', 'H2O', 'C2H6O', 'Ca(OH)2', 'CH3NO', 'HCOOH', 'CO2H2',
            'OH2']


@pytest.mark.parametrize('string', FORMULAS)
def test_formula_helpers_match_jax(string):
    f = formula.string_to_formula(string)
    assert f == jformula.string_to_formula(string)
    assert formula.formula_to_string(f) == jformula.formula_to_string(f)
    assert formula.get_formula_size(f) == jformula.get_formula_size(f)
    zs = [z for z, count in f for _ in range(count)][::-1]
    assert formula.zs_to_formula(zs) == jformula.zs_to_formula(zs)
    for z, _count in f:
        assert (formula.remove_atom_from_formula(f, z)
                == jformula.remove_atom_from_formula(f, z))
    with pytest.raises(RuntimeError, match='Could not remove'):
        formula.remove_atom_from_formula(f, 2)   # no He in any of them
    assert (formula.split_formula_strings(f'{string},H2')
            == jformula.split_formula_strings(f'{string},H2'))


def test_xyz_files_are_found():
    assert len(XYZ_FILES) >= 10
    assert 'experiments/solvation/solute.xyz' in XYZ_FILES
    assert 'experiments/scaffold_pm6/cube.xyz' in XYZ_FILES


@pytest.mark.parametrize('path', XYZ_FILES)
def test_xyz_read_and_write_match_jax(path, tmp_path):
    """Every frame of every XYZ file in experiments/ reads as the JAX
    reader reads it, and writes the same text, byte for byte, to a path
    and to an open file."""
    frames = atoms.read_xyz(str(ROOT / path), index=slice(None))
    jframes = jatoms.read_xyz(str(ROOT / path), index=slice(None))
    assert len(frames) == len(jframes) >= 1
    for a, j in zip(frames, jframes):
        assert a.symbols == j.symbols
        np.testing.assert_array_equal(a.positions, j.positions)
        assert a.get_chemical_formula() == j.get_chemical_formula()
        assert repr(a) == repr(j)
    first = atoms.read_xyz(str(ROOT / path))
    assert first.symbols == frames[0].symbols
    assert [x.symbol for x in first[1:]] == first.symbols[1:]
    np.testing.assert_array_equal(first[-1].position, first.positions[-1])

    ours, theirs = tmp_path / 'ours.xyz', tmp_path / 'theirs.xyz'
    atoms.write_xyz(str(ours), frames, comment='frames')
    jatoms.write_xyz(str(theirs), jframes, comment='frames')
    assert ours.read_bytes() == theirs.read_bytes()
    buf, jbuf = io.StringIO(), io.StringIO()
    atoms.write_xyz(buf, frames[0])
    jatoms.write_xyz(jbuf, jframes[0])
    assert buf.getvalue() == jbuf.getvalue()
    again = atoms.read_xyz(str(ours), index=slice(None))
    assert [a.symbols for a in again] == [a.symbols for a in frames]


def _parsed(module, path, **kwargs):
    return [(gdb_id, a.symbols, a.positions, info)
            for gdb_id, a, info in module.parse_dataset(path, **kwargs)]


def test_qm9_parser_matches_jax_on_the_sample():
    ours = _parsed(qm9_parser, QM9_SAMPLE)
    theirs = _parsed(jqm9, QM9_SAMPLE)
    assert len(ours) == len(theirs) == 16
    for (i, s, p, info), (ji, js, jp, jinfo) in zip(ours, theirs):
        assert (i, s, info) == (ji, js, jinfo)
        np.testing.assert_array_equal(p, jp)


def _archive(path, members):
    with tarfile.open(path, 'w') as tar:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize('defect', ['truncated', 'bad_symbol', 'not_ascii',
                                    'empty'])
def test_qm9_parser_skips_and_raises_as_jax(tmp_path, capsys, defect):
    """A malformed record between two good ones of the sample: skipped and
    reported (non-strict), or ParserError (strict), in both packages; the
    `*^` exponent of a coordinate is read as E."""
    with tarfile.open(QM9_SAMPLE) as tar:
        good = [(m.name, tar.extractfile(m).read()) for m in tar][:2]
    name, data = good[0]
    lines = data.splitlines()
    bad = {'truncated': b'\n'.join(lines[:3]) + b'\n',
           'bad_symbol': data.replace(lines[2].split()[0] + b'\t', b'Qq\t', 1),
           'not_ascii': b'\xff\xfe' + data[2:], 'empty': b''}[defect]
    coords = lines[2].split()
    fixed = data.replace(coords[1], coords[1] + b'*^0', 1)
    path = str(tmp_path / 'mixed.tar')
    _archive(path, [('a.xyz', fixed), ('bad.xyz', bad), good[1]])
    ours = _parsed(qm9_parser, path)
    out = capsys.readouterr().out
    theirs = _parsed(jqm9, path)
    assert out == capsys.readouterr().out
    assert out.count('Could not parse: bad.xyz') == 1
    assert [o[0] for o in ours] == [t[0] for t in theirs]
    assert len(ours) == 2
    np.testing.assert_array_equal(ours[0][2], theirs[0][2])
    with pytest.raises(qm9_parser.ParserError):
        _parsed(qm9_parser, path, strict=True)
    with pytest.raises(jqm9.ParserError):
        _parsed(jqm9, path, strict=True)


def test_qm9_selection_gives_the_recorded_bag_set():
    """The recorded QM9 runs' flags (qm9pm6_run-1.json) select
    CNH,COH2,CFH3,CO2H2 in both packages, whatever the run's --seed; a
    symbol set without F excludes CFH3, and one that fits nothing raises."""
    from scripts.run_qm9 import select_qm9_formulas as jax_select
    recorded = json.loads((ROOT / 'experiments' / 'qm9_pm6' / 'logs' /
                           'qm9pm6_run-1.json').read_text())['formulas']
    assert recorded == 'CNH,COH2,CFH3,CO2H2'
    args = (QM9_SAMPLE, 'X,H,C,N,O,F', 7, 4, 0)
    assert ','.join(select_qm9_formulas(*args)) == recorded
    assert select_qm9_formulas(*args) == jax_select(*args)
    for symbols, canvas, num, seed in (('X,H,C,N,O', 7, 99, 0),
                                       ('X,H,C,N,O,F', 5, 3, 7),
                                       ('X,H,C,N,O,F', 9, 6, 1)):
        args = (QM9_SAMPLE, symbols, canvas, num, seed)
        assert select_qm9_formulas(*args) == jax_select(*args)
    assert all('F' not in f for f in select_qm9_formulas(
        QM9_SAMPLE, 'X,H,C,N,O', 7, 99, 0))
    with pytest.raises(RuntimeError, match='no QM9 molecules'):
        select_qm9_formulas(QM9_SAMPLE, 'X,H', 2, 4, 0)


def test_spherical_coordinates_match_jax():
    rng = np.random.RandomState(0)
    pos = rng.randn(50, 3)
    tp = so3.cartesian_to_spherical(pos)
    np.testing.assert_array_equal(tp, jso3.cartesian_to_spherical(pos))
    np.testing.assert_array_equal(so3.spherical_to_cartesian(tp),
                                  jso3.spherical_to_cartesian(tp))
    unit = pos / np.linalg.norm(pos, axis=-1, keepdims=True)
    np.testing.assert_allclose(so3.spherical_to_cartesian(tp), unit,
                               atol=1e-12)
    np.testing.assert_array_equal(so3.generate_fibonacci_grid(100),
                                  jso3.generate_fibonacci_grid(100))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_rotation_helpers_match_jax(seed):
    """gen_rot draws the same rotation from the same RandomState; its
    Wigner-D matrices are unitary, D^1 is the rotation matrix in the
    spherical basis, and apply_wigner rotates as the JAX one does."""
    ds, rot, angles = so3.gen_rot(4, np.random.RandomState(seed))
    jds, jrot, jangles = jso3.gen_rot(4, np.random.RandomState(seed))
    assert angles == jangles
    np.testing.assert_allclose(rot, jrot, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-12)
    for l, (d, jd) in enumerate(zip(ds, jds)):
        np.testing.assert_allclose(d, jd, rtol=0, atol=1e-12)
        np.testing.assert_allclose(d @ d.conj().T, np.eye(2 * l + 1),
                                   atol=1e-12)
        np.testing.assert_allclose(so3.wigner_d_small(l, angles[1]),
                                   jso3.wigner_d_small(l, angles[1]),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(so3.rotation_matrix(*angles), rot, atol=1e-12)

    rng = np.random.RandomState(seed + 10)
    a_lms = [rng.randn(3, 2, 2 * l + 1, 2).astype(np.float32)
             for l in range(5)]
    got = so3.apply_wigner([torch.from_numpy(a) for a in a_lms], ds)
    want = jso3.apply_wigner([jso3.jnp.asarray(a) for a in a_lms], jds)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    # the rotation keeps each l's norm and the invariants
    for g, a in zip(got, a_lms):
        np.testing.assert_allclose((g ** 2).sum((-2, -1)).numpy(),
                                   (a ** 2).sum((-2, -1)), rtol=1e-5)


def _write_streams(directory):
    for seed, returns in [(1, [0.0, 1.0]), (2, [0.5, 1.5])]:
        rows = [{'total_num_steps': 128 * (i + 1), 'return_mean': r}
                for i, r in enumerate(returns)]
        (directory / f'exp_run-{seed}_eval.txt').write_text(
            '\n'.join(json.dumps(r) for r in rows) + '\n')
    (directory / 'exp_run-1_train.txt').write_text('{"a": 1}\n\n{"a": 2}\n')
    (directory / 'exp_run-1_steps-128_eval.pkl').write_bytes(b'')
    (directory / 'exp_run-3_steps-256_rank-2_train.pkl').write_bytes(b'')
    (directory / 'exp_run-1_steps-256.model').write_bytes(b'')
    (directory / 'notes.md').write_text('')


def test_analysis_matches_jax(tmp_path):
    _write_streams(tmp_path)
    d = str(tmp_path)
    for mode, ext in ((None, None), ('eval', None), ('train', 'pkl'),
                      (None, 'model'), ('eval', 'txt')):
        assert (list(analysis.iter_artifacts(d, mode=mode, ext=ext))
                == [analysis.RunArtifact(**vars(a)) for a in
                    janalysis.iter_artifacts(d, mode=mode, ext=ext)])
    art = analysis.parse_artifact('exp_run-3_steps-256_rank-2_train.pkl')
    assert (art.seed, art.steps, art.rank, art.mode, art.tag) == (
        3, 256, 2, 'train', 'exp_run-3')
    with pytest.raises(ValueError):
        analysis.parse_artifact('notes.md')
    path = str(tmp_path / 'exp_run-1_train.txt')
    assert analysis.read_jsonl(path) == janalysis.read_jsonl(path) == [
        {'a': 1}, {'a': 2}]
    assert analysis.parse_json_lines_file(path) == analysis.read_jsonl(path)
    for name in ('exp_run-3_steps-1280_eval.pkl',
                 'exp_run-3_steps-1280_rank-2_train.pkl'):
        assert (analysis.parse_buffer_filename(name)
                == janalysis.parse_buffer_filename(name))
    assert (analysis.parse_results_filename('exp_run-1_train.txt')
            == janalysis.parse_results_filename('exp_run-1_train.txt'))
    for fn in (analysis.parse_buffer_filename,
               analysis.parse_results_filename):
        with pytest.raises(RuntimeError, match='Cannot parse'):
            fn('garbage.pkl')
    assert (analysis.collect_results_paths(d, 'eval')
            == janalysis.collect_results_paths(d, 'eval'))
    assert (analysis.collect_buffer_paths(d, 'train')
            == janalysis.collect_buffer_paths(d, 'train'))

    frame = analysis.load_metrics(d, 'eval')
    assert frame.equals(janalysis.load_metrics(d, 'eval'))
    agg = analysis.aggregate_over_seeds(frame)
    assert agg.equals(janalysis.aggregate_over_seeds(frame))
    assert list(agg['mean']) == [0.25, 1.25]
    with pytest.raises(RuntimeError, match='opt'):
        analysis.load_metrics(d, 'opt')
