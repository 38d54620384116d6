"""The plain reference against the port's plain path (its CPU versions of
every kernel) at a tiny size: the policy's log-probs, entropies and
values, the env's step, and GAE."""
import json

import numpy as np
import pytest
import torch

from conftest import BENCH, TINY_CONFIG
from reference import covariant, env as ref_env, ppo as ref_ppo


def _port(config_name: str, num_envs: int = 12):
    from molgym_tpu_torch.rl.rollout import make_rollout_fn
    from molgym_tpu_torch.spaces import ObservationSpace, symbols_to_zs
    from molgym_tpu_torch.tools.driver import make_reward_fn
    from molgym_tpu_torch.tools.model_util import build_model
    from harness.program import _resolve

    config = json.loads((BENCH / 'configs' / f'{config_name}.json').read_text())
    config.update(TINY_CONFIG)
    space = ObservationSpace(canvas_size=config['canvas_size'],
                             zs=symbols_to_zs(config['symbols']))
    reward_fn, _host = make_reward_fn(config)
    env, _e = _resolve(config['env_builder'])(config, space, reward_fn, 'cpu')
    torch.manual_seed(5)
    agent = build_model(config, space, device='cpu')
    gen = torch.Generator().manual_seed(11)
    rollout = make_rollout_fn(env, agent, 4)
    _states, traj = rollout(agent, env.init_states(num_envs, gen), gen)
    return config, env, agent, traj


@pytest.mark.parametrize('config_name', ['sf6_cov', 'stoch_cov'])
def test_policy_matches_the_port(config_name):
    config, _env, agent, traj = _port(config_name)
    flat = {k: getattr(traj.obs, k).flatten(0, 1)
            for k in ('elements', 'positions', 'bag')}
    acts = traj.actions.flatten(0, 1)
    params = {k: v.detach() for k, v in agent.named_parameters()}
    logp, ent, v = covariant.evaluate(params, covariant.settings(config),
                                      flat['elements'], flat['positions'],
                                      flat['bag'], acts)
    with torch.no_grad():
        from molgym_tpu_torch.spaces import Observation
        p_logp, p_ent, p_v = agent.evaluate(Observation(**flat), acts)
    torch.testing.assert_close(logp, p_logp, rtol=0, atol=2e-5)
    torch.testing.assert_close(ent, p_ent, rtol=0, atol=2e-5)
    torch.testing.assert_close(v, p_v, rtol=0, atol=2e-5)
    torch.testing.assert_close(logp, traj.logps.flatten(), rtol=0, atol=2e-5)


@pytest.mark.parametrize('config_name', ['sf6_cov', 'stoch_cov'])
def test_env_step_matches_the_port(config_name):
    config, env, _agent, traj = _port(config_name)
    es = ref_env.settings(config)
    flat = {k: getattr(traj.obs, k).flatten(0, 1)
            for k in ('elements', 'positions', 'bag')}
    got = ref_env.transition(es, flat['elements'], flat['positions'], flat['bag'],
                             traj.actions.flatten(0, 1))
    assert torch.equal(got['done'], traj.terminals.flatten())
    assert torch.equal(got['elements'], traj.next_obs.elements.flatten(0, 1))
    assert torch.equal(got['bag'], traj.next_obs.bag.flatten(0, 1))
    torch.testing.assert_close(got['reward'], traj.rewards.flatten(), rtol=0,
                               atol=1e-6)
    assert bool(ref_env.reset_ok(es, traj.obs.elements[0], traj.obs.positions[0],
                                 traj.obs.bag[0]).all())


def test_gae_matches_the_port():
    from molgym_tpu_torch.ops.scan_math import gae_advantages
    g = torch.Generator().manual_seed(3)
    r, v = torch.randn(6, 5, generator=g), torch.randn(6, 5, generator=g)
    done = torch.rand(6, 5, generator=g) < 0.3
    boot = torch.randn(5, generator=g)
    adv, ret = ref_ppo.gae(r, v, done, boot, 0.99, 0.95)
    p_adv, p_ret = gae_advantages(r, v, done, boot, 0.99, 0.95)
    p_adv = p_adv.flatten()
    p_adv = (p_adv - p_adv.mean()) / p_adv.std(correction=0)
    torch.testing.assert_close(adv, p_adv)
    torch.testing.assert_close(ret, p_ret.flatten())


def test_cg_tables_match_the_port():
    from molgym_tpu_torch.ops import cg
    from reference import so3
    for n1, n2, maxl in ((5, 1, 4), (5, 5, 4), (1, 4, 3), (4, 4, 3)):
        ours, slices = so3.product_table(n1, n2, maxl)
        theirs, their_slices = cg._fused_cg_table(n1, n2, maxl)
        np.testing.assert_array_equal(ours, theirs)
        assert slices == their_slices
