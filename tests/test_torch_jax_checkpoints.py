"""The JAX package's trained checkpoints through the port's own load path:
the portable archives under molgym_tpu_torch/checkpoints/ (made by
tests/torch_export_checkpoints.py) against the orbax checkpoints of
experiments/ they were made from, the port's legacy-layout migration
against molgym_tpu's, `ModelIO.load` of an orbax path against the tests'
route (molgym_tpu's restore and migration, then convert.py), its refusals,
`load_latest`, and the driver's load branch: an evaluation and a resume.

Every comparison is bit for bit but the greedy evaluation's, which
tests/test_torch_checkpoint.py states: port 0.973328 within 1e-4. The file
reads experiments/ and writes nothing there."""
import glob
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from molgym_tpu.rl.ppo import PPOConfig as JaxPPOConfig
from molgym_tpu.rl.ppo import make_optimizer as jax_make_optimizer
from molgym_tpu.spaces import ActionSpace as JaxActionSpace
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu.tools import model_io as jax_model_io
from molgym_tpu.tools.model_util import build_model as jax_build_model
from molgym_tpu_torch.convert import (FAMILY_MAPS, flatten_tree,
                                      optimizer_state_from_jax)
from molgym_tpu_torch.formula import string_to_formula
from molgym_tpu_torch.rl.ppo import make_optimizer
from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
from molgym_tpu_torch.tools import driver, model_io
from molgym_tpu_torch.tools.model_io import (HASHED_FILES, METADATA_KEY,
                                             ModelIO)
from molgym_tpu_torch.tools.model_io import \
    read_archive_metadata as metadata
from molgym_tpu_torch.tools.model_util import build_model

from .test_torch_checkpoint import RUNS, _restore, _torch_eval
from .torch_export_checkpoints import ARCHIVES, flatten, restore_raw, sha256

ROOT = Path(__file__).resolve().parents[1]
ARCHIVE_PATHS = sorted(glob.glob(str(ARCHIVES / '*' / '*.npz')))


def _archive_id(path):
    """The experiment's name; with its run's tag where the experiment has
    more than one archive."""
    path = Path(path)
    if len(list(path.parent.glob('*.npz'))) == 1:
        return path.parent.name
    return f'{path.parent.name}-{path.stem.split("_steps-")[0]}'


IDS = [_archive_id(p) for p in ARCHIVE_PATHS]
# the run-1 checkpoints of thirteen experiments and stochastic_pm6's run-2
# (its greedy episode ends short); sf6_pm6's keeps its optimizer state for
# the resume
EXPORTED = {'stochastic', 'sf6_bf16', 'sf6_pm6', 'sf6_internal',
            'sf6_internal_pm6', 'solvation', 'scaffold_pm6', 'qm9_pm6',
            'organics', 'halides_pm6', 'organics_pm6', 'solvation_pm6',
            'stochastic_pm6-stochpm6_run-1', 'stochastic_pm6-stochpm6_run-2'}
WITH_OPT_STATE = {'sf6_pm6'}
LEGACY = ('organics', 'stochastic')
ARCHIVE_BYTES_LIMIT = 12 * 2 ** 20


def _jax_agent(config):
    zs = symbols_to_zs(config['symbols'])
    jspace = JaxObservationSpace(config['canvas_size'], zs)
    return jax_build_model(config, jspace, JaxActionSpace(zs)), jspace


def _port_agent(config):
    space = ObservationSpace(config['canvas_size'],
                             symbols_to_zs(config['symbols']))
    return build_model(config, space, device='cpu')


def test_the_archives_are_the_ten_run_1_checkpoints():
    """The committed archives are EXPORTED's fourteen, together under the
    12 MiB cap."""
    assert set(IDS) == EXPORTED and len(IDS) == len(EXPORTED)
    assert sum(Path(p).stat().st_size for p in ARCHIVE_PATHS) \
        < ARCHIVE_BYTES_LIMIT


@pytest.mark.parametrize('path', ARCHIVE_PATHS, ids=IDS)
def test_archive_equals_its_orbax_checkpoint(path):
    """Every key, dtype and bit of the raw restore (params, and the
    optimizer state where the archive keeps it), the empty nodes, the
    recorded configuration and the checkpoint files' sha256."""
    meta = metadata(path)
    source = ROOT / meta['source']
    assert source.name == Path(path).stem + '.model'
    assert source.parent.parent.name == Path(path).parent.name
    assert meta['steps'] == int(source.stem.rsplit('-', 1)[1])
    assert meta['config'] == json.loads(
        (source.parent.parent / 'logs' / f'{meta["tag"]}.json').read_text())
    assert meta['sha256'] == {f: sha256(source / f) for f in HASHED_FILES}

    raw = restore_raw(source)
    if Path(path).parent.name not in WITH_OPT_STATE:
        raw = {'params': raw['params']}
    leaves, nones = flatten(raw)
    assert meta['none'] == nones
    with np.load(path, allow_pickle=False) as archive:
        stored = {k: archive[k] for k in archive.files if k != METADATA_KEY}
    assert set(stored) == set(leaves)
    for key, leaf in leaves.items():
        if key in meta['bfloat16']:
            leaf = leaf.view(np.uint16)
        assert stored[key].dtype == leaf.dtype, key
        assert stored[key].shape == leaf.shape, key
        np.testing.assert_array_equal(stored[key], leaf, err_msg=key)


@pytest.mark.parametrize('name', LEGACY)
def test_legacy_migration_equals_the_jax_migration(name):
    """organics_run-1 and stoch_run-1 are round-1 covariant checkpoints: the
    port's migration of the flat raw restore, templated by the port's
    agent, equals molgym_tpu's of the tree, templated by the JAX agent's
    and its optimizer's traced shapes, bit for bit, in the params and in
    the optimizer's moments."""
    path = ARCHIVE_PATHS[IDS.index(name)]
    meta = metadata(path)
    config = meta['config']
    raw = restore_raw(ROOT / meta['source'])
    assert jax_model_io.is_legacy_covariant_tree(raw)
    flat, _nones = flatten(raw)
    assert model_io.is_legacy_covariant_tree(flat)

    jagent, jspace = _jax_agent(config)
    obs = jax.tree.map(lambda x: x[None], jspace.build(
        (), string_to_formula(config['formulas'].split(',')[0])))
    key = jax.random.PRNGKey(0)
    params_shape = jax.eval_shape(
        lambda o, k: jagent.init(k, o, k, method=jagent.act), obs, key)
    optimizer = jax_make_optimizer(JaxPPOConfig())
    opt_shape = jax.eval_shape(optimizer.init, params_shape)
    jparams = jax_model_io.migrate_legacy_covariant(raw['params'],
                                                    params_shape)
    jopt = jax_model_io.migrate_legacy_covariant(raw['opt_state'], opt_shape)

    ported = model_io.migrate_legacy_covariant(
        flat, _port_agent(config).state_dict())
    assert not model_io.is_legacy_covariant_tree(ported)
    want = {'params/' + k: v
            for k, v in flatten_dict(jparams, sep='/').items()}
    adam = jopt[1][0]
    assert int(ported['opt_state/1/0/count']) == int(adam.count)
    for moment in ('mu', 'nu'):
        want.update({f'opt_state/1/0/{moment}/{k}': v for k, v in
                     flatten_dict(getattr(adam, moment), sep='/').items()})
    got = {k: v for k, v in ported.items()
           if k.startswith(('params/', 'opt_state/1/0/mu/',
                            'opt_state/1/0/nu/'))}
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize('path', ARCHIVE_PATHS, ids=IDS)
def test_load_equals_the_test_route(path):
    """ModelIO.load of the experiments/ orbax path gives the state_dict
    that molgym_tpu's restore (and migration) and convert.py give, bit for
    bit, at the steps of its name; sf6_pm6's optimizer state too, which
    the others lack."""
    meta = metadata(path)
    config = meta['config']
    agent = _port_agent(config)
    state, steps = ModelIO(str(ROOT), 'unused').load(
        str(ROOT / meta['source']), 'cpu', family=config['model'],
        template=agent.state_dict())
    assert steps == meta['steps'] == state['num_steps']

    jagent, jspace = _jax_agent(config)
    run = dict(model=str(Path(meta['source']).relative_to('experiments')),
               formula=config['formulas'].split(',')[0])
    params = _restore(run, jagent, jspace)
    params_map = FAMILY_MAPS[config['model']]
    want = params_map({k: np.asarray(v)
                       for k, v in flatten_dict(params, sep='/').items()})
    assert set(state['model']) == set(want) == set(agent.state_dict())
    for k, v in want.items():
        assert torch.equal(state['model'][k], v), k

    if Path(path).parent.name not in WITH_OPT_STATE:
        assert 'optimizer' not in state
        return
    raw = restore_raw(ROOT / meta['source'])
    want = optimizer_state_from_jax(raw['opt_state'], params_map)
    assert state['optimizer']['count'] == want['count'] > 0
    for moment in ('mu', 'nu'):
        assert set(state['optimizer'][moment]) == set(want[moment])
        for k, v in want[moment].items():
            assert torch.equal(state['optimizer'][moment][k], v), (moment, k)


@pytest.mark.parametrize('case', ['moved', 'no_archive', 'hash_mismatch'])
def test_load_finds_the_archive_by_name_and_hashes(case, tmp_path):
    """A checkpoint directory is found by its name and its hashed files:
    moved elsewhere it still loads; with no archive of its name, or files
    that match no archive's hashes, load raises and names the export
    command."""
    source = (ROOT / 'experiments' / 'sf6_internal' / 'models'
              / 'sf6int_run-1_steps-14000.model')
    name = ('sf6int_run-9_steps-14000.model' if case == 'no_archive'
            else source.name)
    copy = tmp_path / 'models' / name
    copy.mkdir(parents=True)
    for f in HASHED_FILES:
        shutil.copy(source / f, copy / f)
    if case == 'hash_mismatch':
        with open(copy / '_METADATA', 'ab') as f:
            f.write(b' ')
    handler = ModelIO(str(tmp_path / 'models'), 'unused')
    if case == 'moved':
        state, steps = handler.load(str(copy), 'cpu', family='internal')
        assert steps == 14000 and 'encoder.embedding.weight' in state['model']
        return
    error = FileNotFoundError if case == 'no_archive' else ValueError
    with pytest.raises(error, match='tests.torch_export_checkpoints'):
        handler.load(str(copy), 'cpu', family='internal')


def test_load_latest_finds_a_jax_checkpoint(tmp_path):
    """load_latest lists the port's files and the JAX directories of a
    tag alike, and loads the one of the most steps."""
    models = tmp_path / 'models'
    models.mkdir()
    source = ROOT / 'experiments' / 'sf6_internal' / 'models'
    older = models / 'sf6int_run-1_steps-140.model'
    torch.save({'model': {}, 'num_steps': 140}, older)
    (models / 'sf6int_run-1_steps-14000.model').symlink_to(
        source / 'sf6int_run-1_steps-14000.model')
    state, steps = ModelIO(str(models), 'sf6int_run-1').load_latest(
        'cpu', family='internal')
    assert steps == 14000 and state['format'] == 'JAX'
    assert state['model']['encoder.embedding.weight'].shape == (3, 64)


def _config(experiment, tag, **overrides):
    config = json.loads((ROOT / 'experiments' / experiment / 'logs'
                         / f'{tag}.json').read_text())
    config.update(overrides)
    return config


def test_driver_load_branch_evaluates_as_recorded(tmp_path):
    """--load_model of sf6int_run-1's orbax directory through the driver's
    load branch: an agent whose greedy evaluation is
    tests/test_torch_checkpoint.py's (port 0.973328, gate 1e-4), and a
    fresh optimizer, as the archive holds no optimizer state."""
    model = str(ROOT / 'experiments' / 'sf6_internal' / 'models'
                / 'sf6int_run-1_steps-14000.model')
    config = _config('sf6_internal', 'sf6int_run-1', load_model=model)
    agent = _port_agent(config)
    optimizer = make_optimizer(driver.ppo_config_from(config), agent)
    steps = driver.load_checkpoint(config, ModelIO(str(tmp_path), 'unused'),
                                   agent, optimizer, torch.device('cpu'))
    assert steps == 14000 and optimizer.count == 0
    returns = _torch_eval(RUNS['sf6_internal'], agent)
    assert abs(float(returns.mean()) - 0.973328) <= 1e-4, returns


def test_driver_load_branch_resumes_the_optimizer(tmp_path):
    """--load_model of sf6pm6_run-1 (its archive keeps the optimizer
    state): the driver resumes at 15,120 steps with the checkpoint's adam
    count and moments."""
    model = str(ROOT / 'experiments' / 'sf6_pm6' / 'models'
                / 'sf6pm6_run-1_steps-15120.model')
    config = _config('sf6_pm6', 'sf6pm6_run-1', load_model=model)
    agent = _port_agent(config)
    optimizer = make_optimizer(driver.ppo_config_from(config), agent)
    steps = driver.load_checkpoint(config, ModelIO(str(tmp_path), 'unused'),
                                   agent, optimizer, torch.device('cpu'))
    raw = restore_raw(Path(model))
    adam = raw['opt_state'][1][0]
    assert steps == 15120 and optimizer.count == int(adam['count']) > 0
    nu = flatten_tree(adam['nu'])['params/cg_mix/cat_mix/w_r_l2_s1']
    np.testing.assert_array_equal(
        optimizer.nu['cg_mix.cat_mix.w_r_l2_s1'].numpy(), nu)
