"""molgym_tpu_torch/tools/diagnose_greedy.py on the CPU, against the JAX
package's greedy act, on two trained checkpoints read through their
committed archives: stochpm6_run-2 (PM6, maxl 4, 3 CG levels), whose greedy
episode the reference reports ending at its third action
(experiments/stochastic_pm6/README.md), and stoch_run-1 (device LJ, maxl
3, 2 CG levels), whose greedy episode places all 9 atoms.

The greedy decomposition is held step by step: at each state of the
port's greedy rollout the JAX package's greedy act, from 8 keys, picks the
same focus and element (argmaxes of the same probabilities; no draw), and
the port's distance, the best of 128 draws of the mixture, lies within
twice the range of the 8 JAX distances of their median (measured: within
0.0047 of the median, the ranges 0.0020-0.0085). The greedy mean over 8
envs is the protocol of tests/test_torch_checkpoint.py and chip_smoke.py's
phase 14: 1.2443466 for stoch_run-1 (within 1e-4, the rounding of another
host). The file reads experiments/ and writes nothing there."""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molgym_tpu.spaces import ActionSpace as JaxActionSpace
from molgym_tpu.spaces import Observation as JaxObservation
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu.tools.model_util import build_model as jax_build_model
from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
from molgym_tpu_torch.tools import diagnose_greedy
from molgym_tpu_torch.tools.model_io import ModelIO
from molgym_tpu_torch.tools.model_util import build_model

from .test_torch_checkpoint import _restore
from .test_torch_host_reward import \
    jax_library_built_from_csrc  # noqa: F401  (module fixture)

EXPERIMENTS = Path(__file__).resolve().parents[1] / 'experiments'
MODELS = {
    'stochpm6_run-2': 'stochastic_pm6/models/stochpm6_run-2_steps-7000.model',
    'stoch_run-1': 'stochastic/models/stoch_run-1_steps-7000.model',
}
JAX_KEYS = 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize('name', list(MODELS))
def test_greedy_decomposition_matches_the_jax_act(name):
    path = str(EXPERIMENTS / MODELS[name])
    config, env, agent, steps = diagnose_greedy.load_run(path, 'cpu')
    assert steps == 7000
    zs = symbols_to_zs(config['symbols'])
    episodes, traj = diagnose_greedy.play(env, agent, 4, 1, True, 1, zs,
                                          config['model'])

    jspace = JaxObservationSpace(config['canvas_size'], zs)
    jagent = jax_build_model(config, jspace, JaxActionSpace(zs))
    params = _restore(dict(model=MODELS[name], formula=config['formulas']),
                      jagent, jspace)
    act = jax.jit(lambda p, o, k: jagent.apply(
        p, o, k, True, method=jagent.act).action_flat)
    for t in range(traj.actions.shape[0]):
        obs = JaxObservation(*(jnp.asarray(x[t].numpy().astype(dtype))
                               for x, dtype in (
                                   (traj.obs.elements, np.int32),
                                   (traj.obs.positions, np.float32),
                                   (traj.obs.bag, np.int32))))
        jactions = np.stack([np.asarray(act(params, obs,
                                            jax.random.PRNGKey(k)))
                             for k in range(JAX_KEYS)])
        actions = traj.actions[t].numpy()
        # focus and element
        np.testing.assert_array_equal(
            jactions[..., :2], np.broadcast_to(actions[:, :2],
                                               jactions[..., :2].shape))
        distances = jactions[..., 2]
        spread = distances.max(axis=0) - distances.min(axis=0)
        off = np.abs(actions[:, 2] - np.median(distances, axis=0))
        assert (off <= 2 * spread).all(), (t, off, spread)

    if name == 'stochpm6_run-2':
        # the third action ends every greedy episode: an O placed within
        # 0.1 A of an atom (the reference's 0.077 A), which the env refuses
        for (episode, ) in episodes:
            assert episode['length'] == 3 and episode['atoms'] == 2
            assert not episode['complete']
            assert episode['closest_contact'] < 0.1
    else:
        for (episode, ) in episodes:
            assert episode['complete'] and episode['atoms'] == 9


def test_report_prints_the_short_episode_and_the_sampled_summary():
    """stochpm6_run-2: the report names the short greedy episode's closest
    contact and prints its steps, the last step refused; the sampled
    summary comes from the generator seeded with --seed (the same seed, the
    same numbers), and it places every atom in some episodes."""
    path = str(EXPERIMENTS / MODELS['stochpm6_run-2'])
    kwargs = dict(num_sampled=6, device='cpu')
    result = diagnose_greedy.diagnose(path, seed=3, **kwargs)
    lines = diagnose_greedy.report_lines(result)
    short = [line for line in lines if line.startswith('greedy episode:')]
    assert len(short) == 8 and all('closest contact 0.0' in line
                                   for line in short)
    steps = [line for line in lines if line.startswith('  step 3:')]
    assert len(steps) == 8 and all('element O' in line and 'done True' in line
                                   and 'placed False' in line
                                   for line in steps)
    assert json.loads(lines[-1])['diagnose_greedy']['greedy']['mean'] \
        == result['greedy']['mean'] < 0
    sampled = result['sampled']
    assert sampled['best'] >= sampled['mean']
    assert 0 < sampled['complete_fraction'] <= 1
    assert diagnose_greedy.diagnose(path, seed=3, **kwargs)['sampled'] \
        == sampled
    assert diagnose_greedy.diagnose(path, seed=4, **kwargs)['sampled'] \
        != sampled


def test_greedy_mean_is_the_phase_14_protocol():
    """stoch_run-1's greedy mean over 8 envs is the CPU port's value of
    tests/test_torch_checkpoint.py's protocol."""
    result = diagnose_greedy.diagnose(
        str(EXPERIMENTS / MODELS['stoch_run-1']), num_sampled=2,
        device='cpu')
    assert abs(result['greedy']['mean'] - 1.2443466) <= 1e-4
    assert all(e['complete'] for env_eps in result['greedy']['episodes']
               for e in env_eps)


def test_the_command_reads_a_port_checkpoint_and_its_run_config(
        tmp_path, capsys):
    """The port's own checkpoint file: the configuration from
    <run>/logs/<tag>.json, an asset recorded by a path that does not exist
    found in the run's directory by its name (the solvation's solute), and
    the report printed by the command, the JSON line last."""
    config = json.loads((EXPERIMENTS / 'solvation' / 'logs'
                         / 'solv_run-1.json').read_text())
    config.update(network_width=16, num_interactions=1, seed=5,
                  initial_structure='/elsewhere/solute.xyz', name='tiny')
    (tmp_path / 'logs').mkdir()
    (tmp_path / 'models').mkdir()
    (tmp_path / 'solute.xyz').write_text(
        (EXPERIMENTS / 'solvation' / 'solute.xyz').read_text())
    (tmp_path / 'logs' / 'tiny_run-5.json').write_text(json.dumps(config))
    agent = build_model(config, ObservationSpace(
        config['canvas_size'], symbols_to_zs(config['symbols'])),
        device='cpu')
    path = ModelIO(str(tmp_path / 'models'), 'tiny_run-5').save(
        agent, num_steps=70)
    result = diagnose_greedy.main([path, '--num_sampled=2', '--device=cpu'])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.dumps(json.loads(out[-1])) == json.dumps(
        {'diagnose_greedy': result})
    assert result['steps'] == 70 and result['model'] == 'internal'
    assert np.isfinite(result['greedy']['mean'])
    assert out[0].startswith('diagnose_greedy: ' + path)
