"""The internal agent at the TPU's default matmul precision
(molgym_tpu_torch/tools/tpu_precision.py) against the JAX package run at
that precision by a jaxpr interpreter, at the solvation record's
configuration (experiments/solvation/logs/solv_run-1.json: canvas 12,
X,H,C,O, the solute, the device LJ with its solvation penalty) with the
width cut to WIDTH and INTERACTIONS.

  * unit: each op the context catches, and the focus row's hook, forward
    and backward, against the float64 product of the bf16-rounded operands
    (the incoming gradient rounded too) within UNIT_TOL of the largest
    |ref|, f32 accumulation's error; outside the context the same bits as
    the plain op; and somewhere more than 1e-3 relative from f32 (teeth);
  * inventory: the products of the JAX agent's sampled act, its
    `evaluate` and the PPO loss's value and gradient (jax.make_jaxpr,
    sub-jaxprs walked) equal the table of the tool's docstring at this
    width, shapes and dimension numbers, every precision DEFAULT; the env
    step, the reward, the reset and GAE hold none; the port's env step,
    reward and GAE under the context give the same bits as outside it;
  * against the JAX package: `interpret` evaluates the JAX package's
    closed jaxprs, rounding each DEFAULT dot_general's f32 operands to
    bf16 (round to nearest even, by integer arithmetic on the bits, which
    no compiler folds) and accumulating in f32: on this CPU, JAX ignores
    `jax.default_matmul_precision`. One Flax parameter tree is the port's
    (convert.internal_params_from_jax names each leaf). Held: `evaluate`'s
    logp, ent and v at SAMPLES observations and actions, and each sample's
    PPO loss gradient (the minibatch's gradient is their weighted sum).

Tolerance. Both sides multiply the same rounded operands; only the f32
summation order differs, by an ulp or two of f32. Where an intermediate
lies that close to a bf16 rounding boundary the two sides round it apart,
one bf16 ulp (2^-8 relative), and the difference grows through every
later rounding of that sample to the size of the f32-to-bf16 difference
itself. So the bulk is held and the maximum is bounded: at least
EVAL_BULK of the samples' logp, ent and v within BULK_TOL of the quantity's
RMS over the samples, at least GRAD_BULK of the samples' gradients within
BULK_TOL of their norm (the flattened leaves), every one within MAX_ULPS
bf16 ulps (MAX_ULPS x 2^-8) of that scale. Measured here: the samples
within BULK_TOL 95-100% (logp and the gradients 95%, v 98%), the largest
difference 0.0095 of v's RMS. The same check rejects the f32 port (logp,
v and the gradients: at most NONE_WITHIN of the samples within BULK_TOL;
measured 2%, 0% and 0%) and the emulated port without the focus hook (no
sample's gradient within BULK_TOL; its forward is unchanged, as the
rounded row feeds only Dense layers that round it again).

Seconds: about 31 alone with `-n 0` (imports of JAX and the drivers about
10, the interpreted JAX package's compiles about 8).
"""
from __future__ import annotations

import collections
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from jax import lax
from jax.extend import core as jcore
from torch.nn import functional as F

import scripts.run_solvation as jax_run_solvation
from molgym_tpu.rl import buffer as jbuffer
from molgym_tpu.rl import ppo as jppo
from molgym_tpu.spaces import Observation as JaxObservation
from molgym_tpu.spaces import ObservationSpace as JaxObservationSpace
from molgym_tpu.tools import driver as jax_driver
from molgym_tpu.tools.model_util import build_model as jax_build_model
from molgym_tpu_torch.agents import internal
from molgym_tpu_torch.convert import internal_params_from_jax
from molgym_tpu_torch.rl import buffer, ppo
from molgym_tpu_torch.rl.rollout import make_rollout_fn
from molgym_tpu_torch.spaces import (Observation, ObservationSpace,
                                     symbols_to_zs)
from molgym_tpu_torch.tools import head_draws, recorded_run
from molgym_tpu_torch.tools import tpu_precision as tp
from molgym_tpu_torch.tools.model_util import build_model

RECORD = 'experiments/solvation/logs/solv_run-1.json'
WIDTH = 20          # F = 10, Lb = 5, L = 15: no two of the dimensions equal
INTERACTIONS = 2
INVENTORY_BATCH = 7
SAMPLES = 64
UNIT_TOL = 1e-6     # of the largest |ref|
BULK_TOL = 1e-5
EVAL_BULK = 0.9
GRAD_BULK = 0.8
NONE_WITHIN = 0.1
MAX_ULPS = 8
BF16_ULP = 2.0 ** -8


# ---------------------------------------------------------------- unit

def bf16_reference(x: np.ndarray) -> np.ndarray:
    """float32 -> bf16 by round to nearest even on the bits, back to
    float32."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def test_round_bf16_is_round_to_nearest_even():
    rng = np.random.RandomState(0)
    x = np.concatenate([
        (rng.randn(10000) * 10.0 ** rng.randint(-6, 6, 10000)).astype(
            np.float32),
        # ties: the bits below bf16's are exactly 0x8000
        (np.arange(1, 200, dtype=np.uint32) << 16 | 0x3F800000
         | 0x8000).view(np.float32)])
    got = tp.round_bf16(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  bf16_reference(x).view(np.uint32))
    ints = torch.arange(5)
    assert tp.round_bf16(ints) is ints


def _r64(t: torch.Tensor) -> torch.Tensor:
    return tp.round_bf16(t.detach()).double()


# case -> (operand shapes, the op as the port calls it, the float64
# reference of the rounded operands: the product and a bias added after it)
UNIT_CASES = {
    'linear': ([(6, 5, 9), (4, 9), (4, )],
               lambda x, w, b: F.linear(x, w, b),
               lambda x, w, b: x @ w.T + b),
    'linear_no_bias': ([(6, 9), (4, 9)], lambda x, w: F.linear(x, w),
                       lambda x, w: x @ w.T),
    'cfconv_einsum': ([(3, 5, 5, 7), (3, 5, 7)],
                      lambda w, y: torch.einsum('bijf,bjf->bif', w, y),
                      lambda w, y: torch.einsum('bijf,bjf->bif', w, y)),
    'einsum_list': ([(3, 5), (3, 5, 7)],
                    lambda a, b: torch.einsum('bn,bnl->bl', [a, b]),
                    lambda a, b: torch.einsum('bn,bnl->bl', a, b)),
    'matmul': ([(2, 3, 5), (5, 4)], torch.matmul, lambda a, b: a @ b),
    'matmul_operator': ([(3, 5), (5, 4)], lambda a, b: a @ b,
                        lambda a, b: a @ b),
    'tensor_matmul': ([(4, 3, 5), (4, 5, 6)], lambda a, b: a.matmul(b),
                      lambda a, b: a @ b),
    'mm': ([(3, 5), (5, 4)], torch.mm, lambda a, b: a @ b),
    'bmm': ([(2, 3, 5), (2, 5, 4)], torch.bmm, lambda a, b: a @ b),
}


def _leaves(shapes, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).requires_grad_() for s in shapes]


def _run(fn, leaves, grad):
    out = fn(*leaves)
    return (out.detach(), ) + torch.autograd.grad(out, leaves, grad)


@pytest.mark.parametrize('case', sorted(UNIT_CASES) + ['focus_hook'])
def test_caught_ops_round_their_operands(case):
    if case == 'focus_hook':
        shapes = [(6, 15)]
        op = (lambda row: internal.focus_select_hook(row)
              if internal.focus_select_hook is not None else row)
        ref = (lambda row: row)
        bias = False
    else:
        shapes, op, ref = UNIT_CASES[case]
        bias = case == 'linear'
    leaves = _leaves(shapes, seed=len(case))
    grad = torch.randn(op(*leaves).shape,
                       generator=torch.Generator().manual_seed(1))
    plain = _run(op, leaves, grad)
    with tp.tpu_default_precision():
        got = _run(op, leaves, grad)

    # the float64 reference: the rounded operands, the incoming gradient
    # rounded; a bias and its gradient (a sum, not a product) as they are
    ref_leaves = [(t.detach().double() if bias and i == 2 else _r64(t)
                   ).requires_grad_() for i, t in enumerate(leaves)]
    want = _run(ref, ref_leaves, _r64(grad))
    if bias:
        want = want[:3] + (grad.double().sum(dim=(0, 1)), )
    if case == 'focus_hook':   # the row itself rounded
        want = (_r64(leaves[0]), _r64(grad))
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        assert (g.double() - w).abs().max().item() <= UNIT_TOL * scale
    # after the context: the bits from before it
    for p, a in zip(plain, _run(op, leaves, grad)):
        assert torch.equal(p, a)
    if case != 'focus_hook':
        exact = _run(ref, [t.detach().double().requires_grad_()
                           for t in leaves], grad.double())
        for p, e in zip(plain, exact):
            assert ((p.double() - e).abs().max().item()
                    <= UNIT_TOL * e.abs().max().item())
    # teeth: the emulation is not f32
    assert max(((g - p).abs().max() / p.abs().max()).item()
               for g, p in zip(got, plain)) > 1e-3
    assert internal.focus_select_hook is None


def test_products_the_emulation_does_not_round_raise():
    a, b = torch.randn(3, 4), torch.randn(4, 5)
    with tp.tpu_default_precision():
        for call in (lambda: torch.addmm(torch.zeros(3, 5), a, b),
                     lambda: torch.outer(a[0], b[0]),
                     lambda: torch.tensordot(a, b, 1),
                     lambda: torch.einsum('ij,jk,kl->il', a, b, b.T),
                     lambda: torch.matmul(a, b, out=torch.empty(3, 5))):
            with pytest.raises(NotImplementedError):
                call()
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('high')
    try:
        with pytest.raises(RuntimeError, match='TF32'):
            with tp.tpu_default_precision():
                pass
    finally:
        torch.set_float32_matmul_precision(previous)
    assert internal.focus_select_hook is None


# -------------------------------------------- the two packages' agents

def _config():
    module, argv = recorded_run.recorded_argv(RECORD)
    return vars(recorded_run.parser_of(module).parse_args(
        argv + [f'--network_width={WIDTH}',
                f'--num_interactions={INTERACTIONS}', '--device=cpu']))


def random_canvases(canvas: int, num_zs: int, batch: int, seed: int):
    """Canvases of 1 to `canvas` atoms along a random walk of steps 0.9-1.8
    A, and bags, as numpy (elements, positions, bag)."""
    rng = np.random.RandomState(seed)
    n_atoms = 1 + np.arange(batch) % canvas
    elements = np.zeros((batch, canvas), np.int64)
    positions = np.zeros((batch, canvas, 3), np.float32)
    bag = np.zeros((batch, num_zs), np.int64)
    for b, k in enumerate(n_atoms):
        elements[b, :k] = rng.randint(1, num_zs, size=k)
        steps = rng.randn(k, 3)
        steps *= rng.uniform(0.9, 1.8, (k, 1)) / np.linalg.norm(
            steps, axis=-1, keepdims=True)
        positions[b, :k] = np.cumsum(steps, axis=0) - steps[:1]
        bag[b, 1:] = rng.randint(0, 3, size=num_zs - 1)
        bag[b, 1] += 1
    return elements, positions, bag


class Setup:
    """The solvation configuration at WIDTH: both packages' agents with the
    port's parameters, the JAX env, SAMPLES observations and the port's
    sampled actions there, and the PPO loss's other inputs."""

    def __init__(self):
        self.config = config = _config()
        zs = symbols_to_zs(config['symbols'])
        self.space = ObservationSpace(config['canvas_size'], zs)
        jspace = JaxObservationSpace(config['canvas_size'], zs)
        self.jreward = jax_driver.make_reward_fn(config, True)[0]
        self.jenv = jax_run_solvation.solvation_envs(config, jspace,
                                                     self.jreward)[0]
        torch.manual_seed(3)
        self.agent = build_model(config, self.space, device='cpu')
        self.jagent = jagent = jax_build_model(config, jspace, None)
        arrays = random_canvases(config['canvas_size'], len(zs), SAMPLES,
                                 seed=0)
        self.obs = Observation(*(torch.from_numpy(a) for a in arrays))
        self.jobs = self.jax_obs(arrays)
        with torch.no_grad():
            self.act = self.agent.act(
                self.obs, torch.Generator().manual_seed(0)).action_flat
            logp = self.agent.evaluate(self.obs, self.act)[0]
        rng = np.random.RandomState(1)
        self.old_logp = logp.numpy() + rng.normal(0, 0.05, SAMPLES).astype(
            np.float32)
        self.adv = rng.normal(0, 1, SAMPLES).astype(np.float32)
        self.ret = rng.normal(0, 1, SAMPLES).astype(np.float32)
        shapes = jax.eval_shape(
            lambda o, k: jagent.init(k, o, k, method=jagent.act),
            self.jobs, jax.random.PRNGKey(0))
        state = self.agent.state_dict()
        self.names, flat = {}, {}
        for key, leaf in flatten_dict(shapes, sep='/').items():
            name, = internal_params_from_jax(
                {key: np.zeros(leaf.shape, leaf.dtype)})
            self.names[key] = name
            value = state[name].numpy()
            flat[key] = jnp.asarray(value.T if key.endswith('/kernel')
                                    else value)
        self.params = unflatten_dict(flat, sep='/')
        self.loss = jax.value_and_grad(
            jppo.make_loss_fn(jagent, jppo.PPOConfig()), has_aux=True)
        self.port_loss = ppo.make_loss_fn(self.agent, ppo.PPOConfig())

    @functools.cached_property
    def evaluate_jaxpr(self):
        """The JAX `evaluate`'s closed jaxpr at the SAMPLES rows."""
        jagent = self.jagent
        return jax.make_jaxpr(lambda prm, o, a: jagent.apply(
            prm, o, a, method=jagent.evaluate))(
                *self.loss_args(slice(0, SAMPLES))[:3])

    @functools.cached_property
    def loss_jaxpr(self):
        """The JAX PPO loss's value and gradient, a closed jaxpr at one
        sample."""
        return jax.make_jaxpr(self.loss)(*self.loss_args(slice(0, 1)))

    @staticmethod
    def jax_obs(arrays) -> JaxObservation:
        return JaxObservation(*(jnp.asarray(a.astype(np.int32)
                                            if a.dtype == np.int64 else a)
                                for a in arrays))

    def loss_args(self, rows):
        """The JAX loss's arguments at the sample rows `rows`."""
        return (self.params, jax.tree.map(lambda x: x[rows], self.jobs),
                jnp.asarray(self.act.numpy()[rows]),
                jnp.asarray(self.old_logp[rows]), jnp.asarray(self.adv[rows]),
                jnp.asarray(self.ret[rows]),
                jnp.ones(len(range(SAMPLES)[rows]), jnp.float32))

    def port_grad(self, i: int) -> np.ndarray:
        """Sample i's loss gradient in the port, its leaves flattened in
        Flax's order (a kernel as the port's weight, [out, in])."""
        agent = self.agent
        agent.zero_grad(set_to_none=True)
        rows = slice(i, i + 1)
        loss, _info = self.port_loss(
            self.obs.map(lambda x: x[rows]), self.act[rows],
            *(torch.from_numpy(a[rows].copy())
              for a in (self.old_logp, self.adv, self.ret)), torch.ones(1))
        loss.backward()
        params = dict(agent.named_parameters())
        return np.concatenate([params[n].grad.numpy().ravel()
                               for n in self.names.values()])


@pytest.fixture(scope='module')
def setup():
    return Setup()


# ------------------------------------------------------------ inventory

HIGHER_ORDER = ('jit', 'pjit', 'closed_call', 'custom_jvp_call',
                'custom_vjp_call', 'custom_vjp_call_jaxpr', 'remat',
                'checkpoint')


def _sub_jaxprs(eqn):
    for value in eqn.params.values():
        for sub in (value if isinstance(value, (tuple, list)) else (value, )):
            if isinstance(sub, jcore.ClosedJaxpr):
                yield sub.jaxpr
            elif isinstance(sub, jcore.Jaxpr):
                yield sub


def products(jaxpr) -> list:
    """Every dot_general and conv_general_dilated of a jaxpr and its
    sub-jaxprs: (primitive, operand shapes, dimension numbers, precision)."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ('dot_general', 'conv_general_dilated'):
            out.append((eqn.primitive.name,
                        tuple(tuple(v.aval.shape) for v in eqn.invars),
                        eqn.params['dimension_numbers'],
                        eqn.params['precision']))
        for sub in _sub_jaxprs(eqn):
            out += products(sub)
    return out


def _inventory(found) -> collections.Counter:
    assert all(name == 'dot_general' and precision is None
               for name, _shapes, _dims, precision in found), found
    return collections.Counter((shapes[0], shapes[1], dims[0], dims[1])
                               for _n, shapes, dims, _p in found)


def test_inventory_of_the_jax_products(setup):
    """At INVENTORY_BATCH rows the sampled act, at SAMPLES `evaluate`, at
    one sample the loss's value and gradient (the jaxprs the interpreter
    runs)."""
    jagent, b = setup.jagent, INVENTORY_BATCH
    key = jax.random.PRNGKey(0)
    act = jax.make_jaxpr(lambda prm, o, k: jagent.apply(
        prm, o, k, False, method=jagent.act))(
            *setup.loss_args(slice(0, b))[:2], key)

    def table(batch, products):
        return tp.expected(products, tp.dims_of(
            WIDTH, setup.config['canvas_size'], len(setup.space.zs), batch,
            INTERACTIONS))
    forward = table(b, tp.FORWARD)
    for closed, want in (
            (act, forward), (setup.evaluate_jaxpr, table(SAMPLES, tp.FORWARD)),
            (setup.loss_jaxpr, table(1, tp.FORWARD + tp.transposed()))):
        assert _inventory(products(closed.jaxpr)) == want
    # the docstring's counts: at this width, and at the record's depth
    assert sum(forward.values()) == 18 * INTERACTIONS + 18 == 54
    assert sum(table(1, tp.transposed()).values()) == 33 * INTERACTIONS + 33
    record = tp.dims_of(64, 12, 4, 140, 3)
    assert sum(tp.expected(tp.FORWARD, record).values()) == 72
    assert sum(tp.expected(tp.transposed(), record).values()) == 204 - 72
    assert len(tp.FORWARD) == 20 and len(tp.transposed()) == 37

    # the env step (the reward with its solvation penalty inside it), the
    # reward alone, the reset and GAE: no product
    jenv = setup.jenv
    states = jax.eval_shape(lambda k: jenv.init_states(k, b), key)
    obs = jax.eval_shape(lambda k: jax.tree.map(
        lambda x: x[None], jenv.init_states(k, b).observation()), key)
    element = jnp.ones(b, jnp.int32)
    position = jnp.ones((b, 3), jnp.float32)
    _stop, _valid, needs_reward, zs_atomic, new_z = jax.eval_shape(
        jenv.reward_inputs, states, element, position)
    reward_args = (states.positions, zs_atomic, position, new_z,
                   needs_reward)
    traj = jbuffer.Trajectory(
        obs=obs, next_obs=obs, actions=jnp.zeros((1, b, 7)),
        rewards=jnp.zeros((1, b)), terminals=jnp.zeros((1, b), bool),
        values=jnp.zeros((1, b)), logps=jnp.zeros((1, b)),
        bootstrap_value=jnp.zeros(b))
    for fn, fn_args in ((jenv.step, (states, element, position)),
                        (setup.jreward, reward_args),
                        (jenv.reset_if_terminal,
                         (states, jnp.ones(b, bool))),
                        (lambda t: jbuffer.compute_ppo_data(t, 1.0, 0.97),
                         (traj, ))):
        assert products(jax.make_jaxpr(fn)(*fn_args).jaxpr) == []


def test_env_reward_and_gae_unchanged_under_the_context(setup):
    """The port's solvation env step (the device LJ with the solvation
    penalty) and GAE give the same bits under the context: they hold no
    product. A rollout outside it, each step again inside it from the
    same state with the same element and position."""
    env = head_draws.family_env('solvation', setup.config, 'cpu')
    recorder = head_draws.StepRecorder(env)
    start = env.init_states(10)
    _end, traj = make_rollout_fn(env, setup.agent, 14)(
        setup.agent, start, torch.Generator().manual_seed(2))
    steps = recorder.take()
    data = buffer.compute_ppo_data(traj, 1.0, 0.97)
    states = start
    with tp.tpu_default_precision():
        for t, step in enumerate(steps):
            result = env.step(states, step['element'], step['position'])
            assert torch.equal(result.reward, traj.rewards[t]), t
            assert torch.equal(result.done, traj.terminals[t]), t
            for name in ('elements', 'positions', 'bag', 'n_atoms'):
                assert torch.equal(getattr(result.state, name),
                                   getattr(step['state'], name)), (t, name)
            states = step.get('reset', result.state)
        inside = buffer.compute_ppo_data(traj, 1.0, 0.97)
    for key in ('adv', 'ret', 'logp'):
        assert torch.equal(inside[key], data[key]), key
    assert bool(traj.terminals.any())


# ------------------------------------------------- the JAX interpreter

def round_bits(x):
    """f32 -> bf16 (to nearest even) -> f32 on the bits; other dtypes as
    they are."""
    if x.dtype != jnp.float32:
        return x
    bits = lax.bitcast_convert_type(x, jnp.uint32)
    bits = (bits + jnp.uint32(0x7FFF) + ((bits >> 16) & jnp.uint32(1))) \
        & jnp.uint32(0xFFFF0000)
    return lax.bitcast_convert_type(bits, jnp.float32)


def interpret(closed, *args):
    """Evaluates a closed jaxpr with every DEFAULT dot_general at the TPU's
    default precision (operands rounded to bf16, f32 accumulation)."""
    return _eval(closed.jaxpr, closed.consts, jax.tree.leaves(args))


def _eval(jaxpr, consts, args):
    env = {}

    def read(v):
        return v.val if isinstance(v, jcore.Literal) else env[v]
    for v, x in zip(jaxpr.constvars, consts):
        env[v] = x
    for v, x in zip(jaxpr.invars, args):
        env[v] = x
    for eqn in jaxpr.eqns:
        outs = _apply(eqn, [read(v) for v in eqn.invars])
        if not eqn.primitive.multiple_results:
            outs = [outs]
        for v, x in zip(eqn.outvars, outs):
            env[v] = x
    return [read(v) for v in jaxpr.outvars]


def _apply(eqn, ins):
    name, params = eqn.primitive.name, eqn.params
    if name == 'dot_general':
        if params['precision'] not in (None, lax.Precision.DEFAULT):
            raise NotImplementedError(f'precision {params["precision"]}')
        return lax.dot_general(
            round_bits(ins[0]), round_bits(ins[1]),
            params['dimension_numbers'], precision=lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)
    if name in HIGHER_ORDER:
        sub = params.get('jaxpr', params.get('call_jaxpr'))
        if sub is not None:
            return (_eval(sub.jaxpr, sub.consts, ins)
                    if isinstance(sub, jcore.ClosedJaxpr)
                    else _eval(sub, (), ins))
    if any(products(sub) for sub in _sub_jaxprs(eqn)):
        raise NotImplementedError(f'a product inside {name}')
    return eqn.primitive.bind(*ins, **params)


@pytest.fixture(scope='module')
def jax_at_tpu_precision(setup):
    """The interpreted JAX package: evaluate's (logp, ent, v) at the
    SAMPLES rows, and each sample's loss gradient flattened in Flax's leaf
    order."""
    everything = slice(0, SAMPLES)
    evaluated = [np.asarray(x) for x in jax.jit(
        lambda *a: interpret(setup.evaluate_jaxpr, *a))(
            *setup.loss_args(everything)[:3])]
    closed = setup.loss_jaxpr
    one = setup.loss_args(slice(0, 1))
    tree = jax.tree.structure(jax.eval_shape(setup.loss, *one))

    def sample_grad(*rows):   # one sample's loss arguments, each [1, ...]
        return jax.tree.unflatten(tree, interpret(
            closed, setup.params, *rows))[1]
    rows = jax.tree.map(lambda x: x[:, None],
                        setup.loss_args(everything)[1:])
    flat = flatten_dict(jax.jit(jax.vmap(sample_grad))(*rows), sep='/')
    grads = np.concatenate([
        np.asarray(flat[k]).swapaxes(1, 2).reshape(SAMPLES, -1)
        if k.endswith('/kernel') else np.asarray(flat[k]).reshape(SAMPLES, -1)
        for k in setup.names], axis=1)
    return evaluated, grads


def _port(setup, emulate: bool, focus_hook: bool = True):
    """The port's evaluate and per-sample gradients, as the fixture's."""
    with (tp.tpu_default_precision() if emulate
          else contextlib.nullcontext()):
        if not focus_hook:
            internal.focus_select_hook = None
        with torch.no_grad():
            evaluated = [x.numpy() for x in setup.agent.evaluate(
                setup.obs, setup.act)]
        grads = [setup.port_grad(i) for i in range(SAMPLES)]
    return evaluated, grads


def within(got, want):
    """(the share of samples within BULK_TOL, the largest difference), for
    evaluate's three outputs (of each one's RMS) and the gradients (of each
    sample's norm)."""
    out = {}
    for name, g, w in zip(('logp', 'ent', 'v'), got[0], want[0]):
        err = np.abs(g.astype(np.float64) - w) / np.sqrt(np.mean(
            np.square(w.astype(np.float64))))
        out[name] = (np.mean(err <= BULK_TOL), err.max())
    err = np.array([np.linalg.norm(g.astype(np.float64) - w)
                    / np.linalg.norm(w.astype(np.float64))
                    for g, w in zip(got[1], want[1])])
    out['grad'] = (np.mean(err <= BULK_TOL), err.max())
    return out


def test_emulated_port_matches_the_jax_package_at_tpu_precision(
        setup, jax_at_tpu_precision):
    result = within(_port(setup, emulate=True), jax_at_tpu_precision)
    for name, (share, largest) in result.items():
        bulk = GRAD_BULK if name == 'grad' else EVAL_BULK
        assert share >= bulk and largest <= MAX_ULPS * BF16_ULP, (name,
                                                                  result)


def test_the_check_rejects_the_f32_port(setup, jax_at_tpu_precision):
    result = within(_port(setup, emulate=False), jax_at_tpu_precision)
    for name in ('logp', 'v', 'grad'):
        assert result[name][0] <= NONE_WITHIN, (name, result)


def test_the_check_rejects_the_port_without_the_focus_hook(
        setup, jax_at_tpu_precision):
    result = within(_port(setup, emulate=True, focus_hook=False),
                    jax_at_tpu_precision)
    assert internal.focus_select_hook is None
    assert result['grad'][0] <= NONE_WITHIN, result


# ------------------------------------------------------- the entry point

def test_the_tool_runs_a_record_under_the_context(tmp_path):
    record = RECORD
    module, argv = tp.emulated_argv(record, ['--seed=19'])
    assert module == 'molgym_tpu_torch.run_solvation'
    assert argv[-1] == '--name=solv' + tp.TAG_SUFFIX
    command = tp.main([record, '--seed=19', '--dry_run'])
    assert command.endswith('--seed=19 --name=solv_tpudefault')
    for flags in (['--model=covariant'], ['--num_devices=2']):
        with pytest.raises(NotImplementedError):
            tp.emulated_argv(record, flags)
    assert tp.main(['--diagnose', 'experiments/solvation/models/'
                    'solv_run-1_steps-7000.model', '--device', 'cpu',
                    '--dry_run']).startswith(
                        'python3 -m molgym_tpu_torch.tools.diagnose_greedy')

    dirs = [f'--{d}_dir={tmp_path}/{d}'
            for d in ('log', 'model', 'data', 'results')]
    before = sum(tp.product_counts.values())
    tp.main([record, '--seed=19', '--network_width=16',
             '--num_interactions=1', '--num_envs=4',
             '--num_steps_per_iter=16', '--mini_batch_size=16',
             '--num_steps=32', '--max_num_train_iters=2', '--eval_freq=1',
             '--device=cpu', *dirs])
    assert sum(tp.product_counts.values()) > before
    assert tp.product_counts['focus'] > 0
    tag = 'solv_tpudefault_run-19'
    assert (tmp_path / 'results' / f'{tag}_train.txt').exists()
    assert any(p.name.startswith(tag) for p in (tmp_path / 'model').iterdir())
    assert internal.focus_select_hook is None
