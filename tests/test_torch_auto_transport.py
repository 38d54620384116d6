"""--host_reward_mode=auto in the port: the measured choice between the
pipelined host loop and the in-step transport (rl/rollout.py's
AutoTransportRollout), held against the JAX package's selector on the same
stubs (tests/test_host_loop.py's TestAutoTransportRollout: the same call
order, choice, lock-in and current transport, the JAX `serial` being the
port's `in_step`), the evaluation following the choice, and a tiny PM6 run
of 6 iterations through the driver under auto against the same run under
loop and under loop_serial: every record equal, the timings, the
transport and the pipelined transport's recomputes aside (the transports
give the same bits). The W = 2 case is tests/test_torch_parallel.py's
test_auto_transport_at_w2."""
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from molgym_tpu.rl.rollout import AutoTransportRollout as JaxAuto
from molgym_tpu_torch import run
from molgym_tpu_torch.curve_summary import selector_probes
from molgym_tpu_torch.rl.ppo import _Following
from molgym_tpu_torch.rl.rollout import AutoTransportRollout
from molgym_tpu_torch.tools.driver import host_transport

# the port's name of each JAX transport
PORT_NAME = {'pipelined': 'pipelined', 'serial': 'in_step'}
# the JAX test's delays, and the same reversed
DELAYS = [{'pipelined': 0.08, 'serial': 0.002},
          {'pipelined': 0.002, 'serial': 0.08}]
UNTIMED = ('time', 'iteration_time', 'reward_time', 'transport',
           'recomputes')
TINY_PM6 = ['--name=auto', '--formulas=H2O', '--canvas_size=3',
            '--symbols=X,H,O', '--bag_scale=3', '--model=mlp',
            '--network_width=16', '--reward=pm6', '--num_envs=4',
            '--num_steps_per_iter=8', '--mini_batch_size=8',
            '--max_num_train_iters=2', '--num_steps=48', '--eval_freq=1',
            '--save_rollouts=none', '--seed=1', '--device=cpu']


def _stubs(delays, calls, traj):
    def make(name, delay):
        def fn(params, states, rng):
            calls.append(name)
            time.sleep(delay)
            return states, traj
        return fn
    return {name: make(name, delay) for name, delay in delays.items()}


@pytest.mark.parametrize('delays', DELAYS, ids=['serial-faster',
                                                'pipelined-faster'])
def test_selector_matches_jax_on_stubs(delays):
    """Both packages' selectors over stubs with the same delays: the same
    calls in the same order (pipelined, then the serial transport, twice
    each, then the faster), the same choice and lock-in, the same current
    transport at every call; the port's evaluation follows the choice,
    pipelined until there is one."""
    jax_calls, calls = [], []
    ref = JaxAuto(_stubs(delays, jax_calls, {'rewards': np.zeros(3)}))
    auto = AutoTransportRollout(_stubs(
        {PORT_NAME[n]: d for n, d in delays.items()}, calls,
        SimpleNamespace(rewards=torch.zeros(3))))
    evals = []
    follow = _Following(auto, lambda pipelined: evals.append(pipelined) or (
        lambda p, s, g: (s, None)))
    winner = min(delays, key=delays.get)
    for i in range(7):
        assert auto.current_transport() == PORT_NAME[ref.current_transport()]
        assert auto.transport == auto.current_transport()
        assert follow.transport == (PORT_NAME[ref.choice] if ref.choice
                                    else 'pipelined')
        ref(None, None, None)
        auto(None, None, None)
        follow(None, None, None)
        assert (auto.choice is None) == (ref.choice is None) == (i < 3)
    assert jax_calls[:4] == ['pipelined', 'serial', 'pipelined', 'serial']
    assert jax_calls[4:] == [winner] * 3
    assert calls == [PORT_NAME[n] for n in jax_calls]
    assert ref.choice == winner and auto.choice == PORT_NAME[winner]
    assert set(auto.times) == {'pipelined', 'in_step'}
    assert auto.times[PORT_NAME[winner]] < delays[
        'serial' if winner == 'pipelined' else 'pipelined']
    # the evaluation built the pipelined transport first, then the choice's
    assert evals == ([True] if winner == 'pipelined' else [True, False])


def test_selector_exposes_the_last_calls_recomputes():
    """recomputes is the pipelined function's after a pipelined call, None
    after an in-step call (which computes no forward again)."""
    traj = SimpleNamespace(rewards=torch.zeros(2))

    def pipelined(p, s, g):
        pipelined.recomputes += 1
        return s, traj
    pipelined.recomputes = 0
    auto = AutoTransportRollout({'pipelined': pipelined,
                                 'in_step': lambda p, s, g: (s, traj)})
    seen = []
    for _ in range(4):
        auto(None, None, None)
        seen.append(auto.recomputes)
    assert seen == [1, None, 2, None]
    with pytest.raises(ValueError):
        AutoTransportRollout({'pipelined': pipelined})


def test_host_transport_of_each_mode():
    """--host_reward_mode for batch_ppo: auto measures, loop is pipelined,
    loop_serial and callback step in the env; a device reward (no host
    calculator) has nothing to choose."""
    calc = object()
    assert host_transport('auto', calc) == dict(
        host_loop_calculator=calc, host_loop_pipelined='auto')
    assert host_transport('loop', calc) == dict(
        host_loop_calculator=calc, host_loop_pipelined=True)
    for mode in ('loop_serial', 'callback'):
        assert host_transport(mode, calc) == dict(host_loop_calculator=None)
    for mode in ('auto', 'loop'):
        assert host_transport(mode, None) == dict(host_loop_calculator=None)


def _run(tmp_path, mode):
    dirs = [f'--{d}_dir={tmp_path / mode / d}'
            for d in ('log', 'model', 'data', 'results')]
    run.main(TINY_PM6 + dirs + [f'--host_reward_mode={mode}'])
    results = tmp_path / mode / 'results'
    streams = {s: [json.loads(line) for line in
                   (results / f'auto_run-1_{s}.txt').read_text().splitlines()]
               for s in ('train', 'opt', 'eval')}
    probes = selector_probes(str(tmp_path / mode / 'log' / 'auto_run-1.log'))
    return streams, probes


def _untimed(streams):
    return {s: [{k: v for k, v in r.items() if k not in UNTIMED}
                for r in recs] for s, recs in streams.items()}


def test_auto_run_matches_loop_and_loop_serial(tmp_path):
    """A tiny PM6 run of 6 iterations under auto: the training transports
    read pipelined, in_step, pipelined, in_step, then the choice, which is
    the faster of the two timed probes in the log
    (curve_summary.selector_probes); each evaluation steps
    in the choice, pipelined until there is one; every record equals the
    loop and loop_serial runs' but for the timings, the transport and the
    recomputes."""
    auto, probes = _run(tmp_path, 'auto')
    choice, ms = probes['choice'], probes['probe_ms']
    assert set(ms) == {'pipelined', 'in_step'}
    assert choice == min(ms, key=ms.get)
    transports = [r['transport'] for r in auto['train']]
    assert transports == ['pipelined', 'in_step'] * 2 + [choice] * 2
    assert [r['transport'] for r in auto['eval']] == (
        ['pipelined'] * 3 + [choice] * 3)
    for rec in auto['train'] + auto['eval']:
        assert ('recomputes' in rec) == (rec['transport'] == 'pipelined')
    assert all(r['reward_time'] > 0 for r in auto['train'])
    loop, none = _run(tmp_path, 'loop')
    serial, _ = _run(tmp_path, 'loop_serial')
    assert none is None
    assert {r['transport'] for r in loop['train'] + loop['eval']} == {
        'pipelined'}
    assert {r['transport'] for r in serial['train'] + serial['eval']} == {
        'in_step'}
    assert len(auto['opt']) == 6
    assert _untimed(auto) == _untimed(loop) == _untimed(serial)
