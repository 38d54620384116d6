"""The port's PPO update against molgym_tpu's: GAE and the PPO data, the
episode statistics, the loss and its gradient, the optimizer against optax,
one train() call against make_train_fn, and the optimizer state carried over
from optax. Inputs are made with numpy and handed to both frameworks; the
agents share one Flax init, carried over by convert.py.

Tolerances (float32, another summation order): the time-axis math 1e-5;
losses 1e-4 relative; gradients within 1e-4 of each leaf's largest |g|;
optimizer updates 1e-6. Parameters after training steps: Adam's first
update is lr * sign(g), so an element whose gradient sits at the float32
noise floor can move by up to 2 lr more in one framework than in the other;
such elements are counted, and the rest held at 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from molgym_tpu.ops import scan_math as jscan
from molgym_tpu.rl import buffer as jbuffer
from molgym_tpu.rl import ppo as jppo
from molgym_tpu.spaces import Observation as JaxObservation
from molgym_tpu_torch.convert import (covariant_params_from_jax,
                                      optimizer_state_from_jax)
from molgym_tpu_torch.ops import scan_math
from molgym_tpu_torch.rl import buffer, ppo
from molgym_tpu_torch.spaces import Observation
from tests.test_torch_covariant import (SF6, SMALL, Pair, jax_obs, make_batch,
                                        torch_obs)

GRAD_TOL = 1e-4


def _torch_grads(jgrads) -> dict:
    flat = {k: np.asarray(v) for k, v in flatten_dict(jgrads, sep='/').items()}
    return covariant_params_from_jax(flat)


def assert_grads_close(agent, jgrads, tol):
    """Each leaf within `tol` of its largest |g|; a leaf whose gradient is
    below 1e-3 of the largest leaf's (structurally zero, e.g. the mixer
    weights of a rep that is all zeros, left at the f32 noise floor) is
    held against 1e-3 of the largest leaf's instead."""
    ref = _torch_grads(jgrads)
    floor = 1e-3 * max(float(g.abs().max()) for g in ref.values())
    for name, p in agent.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = max(float(ref[name].abs().max()), floor)
        err = float((g - ref[name]).abs().max())
        assert err <= tol * scale, (name, err, scale)


def _trajectory_arrays(T, B, seed, cfg=SMALL):
    rng = np.random.RandomState(seed)
    elements, positions, bag = make_batch(cfg, T * B, seed)
    return dict(
        elements=elements.reshape(T, B, -1), positions=positions.reshape(T, B, -1, 3),
        bag=bag.reshape(T, B, -1), actions=rng.randn(T, B, 6).astype(np.float32),
        rewards=rng.randn(T, B).astype(np.float32),
        terminals=rng.rand(T, B) < 0.3,
        values=rng.randn(T, B).astype(np.float32),
        logps=rng.randn(T, B).astype(np.float32),
        bootstrap_value=rng.randn(B).astype(np.float32))


def _jax_traj(a):
    obs = JaxObservation(jnp.asarray(a['elements']), jnp.asarray(a['positions']),
                         jnp.asarray(a['bag']))
    return jbuffer.Trajectory(obs=obs, next_obs=obs, **{
        k: jnp.asarray(a[k]) for k in ('actions', 'rewards', 'terminals',
                                       'values', 'logps', 'bootstrap_value')})


def _torch_traj(a):
    obs = Observation(torch.from_numpy(a['elements'].astype(np.int64)),
                      torch.from_numpy(a['positions']),
                      torch.from_numpy(a['bag'].astype(np.int64)))
    return buffer.Trajectory(obs=obs, next_obs=obs, **{
        k: torch.from_numpy(np.asarray(a[k])) for k in (
            'actions', 'rewards', 'terminals', 'values', 'logps',
            'bootstrap_value')})


@pytest.mark.parametrize('gamma,lam', [(1.0, 0.97), (0.9, 0.5)])
def test_gae_and_discount_cumsum_match_jax(gamma, lam):
    a = _trajectory_arrays(9, 5, seed=int(gamma * 10))
    adv, ret = scan_math.gae_advantages(
        *(torch.from_numpy(np.asarray(a[k])) for k in (
            'rewards', 'values', 'terminals', 'bootstrap_value')), gamma, lam)
    jadv, jret = jscan.gae_advantages(
        *(jnp.asarray(a[k]) for k in ('rewards', 'values', 'terminals',
                                      'bootstrap_value')), gamma, lam)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), rtol=1e-5, atol=1e-5)
    x = a['rewards']
    np.testing.assert_allclose(
        scan_math.discount_cumsum(torch.from_numpy(x), gamma).numpy(),
        np.asarray(jscan.discount_cumsum(jnp.asarray(x), gamma)), rtol=1e-5,
        atol=1e-5)


def test_ppo_data_and_stats_match_jax():
    a = _trajectory_arrays(6, 4, seed=3)
    data = buffer.compute_ppo_data(_torch_traj(a), 1.0, 0.97)
    jdata = jbuffer.compute_ppo_data(_jax_traj(a), 1.0, 0.97)
    for key in ('act', 'ret', 'adv', 'logp'):
        np.testing.assert_allclose(data[key].numpy(), np.asarray(jdata[key]),
                                   rtol=1e-5, atol=1e-5)
    # population std, as jnp.std
    assert abs(float(data['adv'].std(correction=0)) - 1.0) < 1e-5
    for t, j in ((data['obs'].elements, jdata['obs'].elements),
                 (data['obs'].positions, jdata['obs'].positions),
                 (data['obs'].bag, jdata['obs'].bag)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert buffer.buffer_stats(_torch_traj(a)) == pytest.approx(
        jbuffer.buffer_stats(_jax_traj(a)), rel=1e-6)
    rng = np.random.default_rng(0)
    for gamma in (1.0, 0.9):
        rewards = rng.normal(size=(11, 4))
        terminals = rng.random((11, 4)) < 0.3
        assert buffer.episode_stats(rewards, terminals, gamma) == \
            jbuffer.episode_stats(rewards, terminals, gamma)


# ---------------------------------------------------------------------------
# loss, gradients, optimizer and train() on the small covariant config
# ---------------------------------------------------------------------------

class Setup:
    """One Flax init of the small covariant agent, carried over, and a batch
    of PPO data: actions sampled by JAX, scored by JAX for the old log-probs
    (plus noise), random advantages and returns."""

    def __init__(self, n=8, seed=3):
        self.pair = Pair(SMALL, make_batch(SMALL, 3, seed=3))
        jagent = self.pair.jagent
        self.arrays = make_batch(SMALL, n, seed=seed)
        jout = jax.jit(lambda prm, o, k: jagent.apply(
            prm, o, k, False, method=jagent.act))(
                self.pair.params, jax_obs(self.arrays), jax.random.PRNGKey(seed))
        rng = np.random.RandomState(seed)
        self.act = np.array(jout.action_flat)
        self.logp = (np.array(jout.logp) +
                     0.05 * rng.randn(n)).astype(np.float32)
        self.adv = rng.randn(n).astype(np.float32)
        self.ret = rng.randn(n).astype(np.float32)
        self.n = n

    def jax_data(self):
        return dict(obs=jax_obs(self.arrays), act=jnp.asarray(self.act),
                    logp=jnp.asarray(self.logp), adv=jnp.asarray(self.adv),
                    ret=jnp.asarray(self.ret))

    def torch_data(self):
        return dict(obs=torch_obs(self.arrays), act=torch.from_numpy(self.act),
                    logp=torch.from_numpy(self.logp),
                    adv=torch.from_numpy(self.adv), ret=torch.from_numpy(self.ret))

    def fresh_agent(self):
        from molgym_tpu_torch.agents.covariant import CovariantAC
        agent = CovariantAC(**SMALL, device='cpu')
        agent.load_state_dict(self.pair.agent.state_dict())
        return agent


CONFIG = ppo.PPOConfig(gamma=1.0, entropy_coef=0.01, learning_rate=3e-4,
                       mini_batch_size=4, max_num_train_iters=3,
                       target_kl=1e9)


@pytest.fixture(scope='module')
def setup():
    setup = Setup()
    # jitted once for the tests that share CONFIG's loss
    setup.jax_grad = jax.jit(jax.grad(
        jppo.make_loss_fn(setup.pair.jagent, CONFIG), has_aux=True))
    return setup


def test_loss_and_gradients_match_jax(setup):
    weights = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    jd = setup.jax_data()
    jgrads, jinfo = setup.jax_grad(
        setup.pair.params, jd['obs'], jd['act'], jd['logp'], jd['adv'],
        jd['ret'], jnp.asarray(weights))
    agent = setup.fresh_agent()
    td = setup.torch_data()
    loss, info = ppo.make_loss_fn(agent, CONFIG)(
        td['obs'], td['act'], td['logp'], td['adv'], td['ret'],
        torch.from_numpy(weights))
    loss.backward()
    for key in ppo.INFO_KEYS:
        np.testing.assert_allclose(float(info[key]), float(jinfo[key]),
                                   rtol=1e-4, atol=1e-6)
    assert_grads_close(agent, jgrads, GRAD_TOL)


def test_sf6_width_loss_gradients_match_jax():
    """The PPO loss of the full-width SF6 agent (the canonical run's
    config) and every parameter's gradient, within 1e-3 of the leaf's
    largest |g|."""
    config = CONFIG._replace(entropy_coef=0.01, vf_coef=0.5)
    pair = Pair(SF6, make_batch(SF6, 3, seed=4))
    arrays = make_batch(SF6, 6, seed=5)
    jagent = pair.jagent
    act = np.array(jax.jit(lambda prm, o, k: jagent.apply(
        prm, o, k, False, method=jagent.act).action_flat)(
            pair.params, jax_obs(arrays), jax.random.PRNGKey(1)))
    rng = np.random.RandomState(6)
    logp, adv, ret = (rng.randn(6).astype(np.float32) for _ in range(3))
    weights = np.ones(6, np.float32)
    jgrads, jinfo = jax.jit(jax.grad(jppo.make_loss_fn(jagent, config),
                                     has_aux=True))(
        pair.params, jax_obs(arrays), *map(jnp.asarray, (act, logp, adv, ret,
                                                         weights)))
    loss, info = ppo.make_loss_fn(pair.agent, config)(
        torch_obs(arrays), *map(torch.from_numpy, (act, logp, adv, ret,
                                                   weights)))
    pair.agent.zero_grad(set_to_none=True)
    loss.backward()
    for key in ppo.INFO_KEYS:
        np.testing.assert_allclose(float(info[key]), float(jinfo[key]),
                                   rtol=1e-4, atol=1e-6)
    assert_grads_close(pair.agent, jgrads, 1e-3)


def _random_tree(rng, shapes, scale):
    return {k: (scale * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize('amsgrad', [False, True])
def test_optimizer_matches_optax(amsgrad):
    """Five steps on the same gradients, large enough that the global-norm
    clip engages on some steps and not on others."""
    rng = np.random.RandomState(int(amsgrad))
    shapes = {'a': (3, 4), 'b': (5, ), 'c': (2, 2, 2)}
    params = _random_tree(rng, shapes, 1.0)
    config = ppo.PPOConfig(learning_rate=1e-2, gradient_clip=0.5,
                           amsgrad=amsgrad)
    jopt = jppo.make_optimizer(config)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    topt = ppo.Optimizer(tparams.items(), config.learning_rate,
                         config.gradient_clip, amsgrad=amsgrad)
    for step in range(5):
        grads = _random_tree(rng, shapes, [0.05, 1.0, 0.02, 3.0, 0.1][step])
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in grads.items()},
                                      jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.step({k: torch.from_numpy(v) for k, v in grads.items()})
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=0, atol=1e-6)
    carried = optimizer_state_from_jax(jstate)
    assert carried['count'] == topt.count == 5
    assert ('nu_max' in carried) == amsgrad


def assert_params_close(agent, jparams, lr, steps):
    """Held at 1e-5, except elements whose update sign flips between the
    frameworks (a gradient at the f32 noise floor); at most 1% of the
    elements may do that, and by no more than 2 lr per step."""
    ref = covariant_params_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(jparams, sep='/').items()})
    n_total = n_off = 0
    for name, p in agent.named_parameters():
        diff = (p.detach() - ref[name]).abs()
        assert float(diff.max()) <= 2 * lr * steps + 1e-5, name
        n_off += int((diff > 1e-5).sum())
        n_total += diff.numel()
    assert n_off <= 0.01 * n_total, (n_off, n_total)


def test_train_matches_make_train_fn(setup):
    """mini_batch_size divides num_samples: the epoch's summed gradient does
    not depend on the permutation, so the two frameworks' different random
    streams give the same update (up to f32 order)."""
    jopt = jppo.make_optimizer(CONFIG)
    jtrain = jppo.make_train_fn(setup.pair.jagent, jopt, CONFIG, setup.n)
    jparams, _jstate, jinfo = jtrain(setup.pair.params,
                                     jopt.init(setup.pair.params),
                                     setup.jax_data(), jax.random.PRNGKey(0))
    agent = setup.fresh_agent()
    train = ppo.make_train_fn(agent, ppo.make_optimizer(CONFIG, agent), CONFIG,
                              setup.n)
    info = train(setup.torch_data(), torch.Generator().manual_seed(0))
    assert info['num_opt_steps'] == int(jinfo['num_opt_steps']) == 3
    assert info['num_grad_passes'] == 3
    for key in ppo.INFO_KEYS + ('grad_norm', ):
        np.testing.assert_allclose(info[key], float(jinfo[key]), rtol=1e-4,
                                   atol=1e-6)
    assert_params_close(agent, jparams, CONFIG.learning_rate, 3)
    assert all(p.grad is None for p in agent.parameters())


def test_padded_remainder_gives_finite_values(setup):
    config = CONFIG._replace(mini_batch_size=3, max_num_train_iters=2)
    agent = setup.fresh_agent()
    before = {k: v.clone() for k, v in agent.state_dict().items()}
    train = ppo.make_train_fn(agent, ppo.make_optimizer(config, agent), config,
                              setup.n)
    info = train(setup.torch_data(), torch.Generator().manual_seed(1))
    assert all(np.isfinite(v) for v in info.values())
    assert info['num_opt_steps'] == 2
    assert any(not torch.equal(before[k], v) for k, v in agent.state_dict().items())


def test_tiny_target_kl_stops_after_one_step(setup):
    """Every advantage negative, old log-probs at the current parameters:
    the first epoch's approx-KL is at the noise floor and it steps; the step
    lowers every sampled action's log-prob, so the second epoch's approx-KL
    exceeds 1.5 * target_kl and the loop stops before stepping."""
    config = CONFIG._replace(target_kl=1e-4, learning_rate=1e-2, vf_coef=0.0,
                             entropy_coef=0.0, mini_batch_size=setup.n)
    jd = setup.jax_data()
    jlogp, _e, _v = setup.pair.evaluate(setup.pair.params, jd['obs'], jd['act'])
    jd.update(logp=jlogp, adv=-jnp.ones(setup.n))
    jopt = jppo.make_optimizer(config)
    jtrain = jppo.make_train_fn(setup.pair.jagent, jopt, config, setup.n)
    _p, _s, jinfo = jtrain(setup.pair.params, jopt.init(setup.pair.params), jd,
                           jax.random.PRNGKey(0))
    agent = setup.fresh_agent()
    td = setup.torch_data()
    with torch.no_grad():
        td['logp'], _e, _v = agent.evaluate(td['obs'], td['act'])
    td['adv'] = -torch.ones(setup.n)
    info = ppo.make_train_fn(agent, ppo.make_optimizer(config, agent), config,
                             setup.n)(td, torch.Generator().manual_seed(0))
    assert int(jinfo['num_opt_steps']) == info['num_opt_steps'] == 1
    assert info['num_grad_passes'] == 2


def test_optimizer_state_carries_over_from_optax(setup):
    """One JAX step, then params and optax state carried across with
    convert.py; one more step in each framework gives the same params."""
    config = CONFIG._replace(learning_rate=1e-3)
    weights = jnp.ones(setup.n)
    jd = setup.jax_data()
    jopt = jppo.make_optimizer(config)

    def jax_step(params, state):
        grads, _info = setup.jax_grad(params, jd['obs'], jd['act'], jd['logp'],
                               jd['adv'], jd['ret'], weights)
        updates, state = jopt.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    jparams, jstate = jax_step(setup.pair.params,
                               jopt.init(setup.pair.params))
    agent = setup.fresh_agent()
    agent.load_state_dict(covariant_params_from_jax(
        {k: np.asarray(v) for k, v in flatten_dict(jparams, sep='/').items()}))
    opt = ppo.make_optimizer(config, agent)
    opt.load_state_dict(optimizer_state_from_jax(jstate))
    assert opt.count == 1
    jparams, _jstate = jax_step(jparams, jstate)

    td = setup.torch_data()
    loss, _info = ppo.make_loss_fn(agent, config)(
        td['obs'], td['act'], td['logp'], td['adv'], td['ret'],
        torch.ones(setup.n))
    loss.backward()
    opt.step({k: p.grad for k, p in agent.named_parameters()})
    assert_params_close(agent, jparams, config.learning_rate, 1)
