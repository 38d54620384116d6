"""The port's fused masked categorical head (ops/fused_softmax.py::
masked_categorical, distributions/discrete.py::categorical_head) against
molgym_tpu's discrete functions, forward and gradient; its plain backward
formula against autograd of its plain forward; and the covariant agent's
draws through the head against the chain of discrete.py's functions it
replaced. The CUDA kernels are compared with the plain versions on the card
(chip_smoke.py and tests/test_torch_kernels.py).

The JAX side has no sampler that takes given uniforms (jax.random.gumbel
draws its own), so it builds the Gumbel-max choice from the same numpy
uniforms with the noise -log(-log(clip(u))); its softmax is also held
against the Pallas kernel in interpret mode.

Tolerances (float32): probabilities, log-probabilities and entropies within
1e-6 absolute (the JAX softmax test's); indices equal; gradients within
1e-5 absolute and relative (the log-probability's 1/p and the entropy's
log p terms, summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molgym_tpu.distributions import discrete as jdiscrete
from molgym_tpu.ops.pallas_softmax import masked_softmax_pallas
from molgym_tpu_torch.distributions import discrete
from molgym_tpu_torch.ops import fused_softmax, kernel_common

ATOL = 1e-6
GRAD_TOL = 1e-5
# the focus head's shape at SF6, the element head's, and one row longer
# than a warp's 32 lanes, as in tests/test_torch_softmax.py
SHAPES = [(140, 7), (140, 3), (33, 200)]
MODES = ['sample', 'given', 'greedy']


def _case(shape, seed):
    """Logits, a mask with every 7th row fully masked, uniforms, an index
    (any entry, masked ones too) and the cotangents a, b, c of logp, ent
    and probs."""
    rng = np.random.RandomState(seed)
    rows, n = shape
    logits = (3.0 * rng.randn(rows, n)).astype(np.float32)
    mask = rng.rand(rows, n) > 0.4
    mask[::7] = False
    mask[1] = True
    u = rng.rand(rows, n).astype(np.float32)
    index = rng.randint(0, n, size=rows).astype(np.int64)
    cot = (rng.randn(rows).astype(np.float32), rng.randn(rows).astype(
        np.float32), rng.randn(rows, n).astype(np.float32))
    return logits, mask, u, index, cot


def _jax_head(logits, mask, u, index, mode):
    probs = jdiscrete.masked_categorical_probs(logits, mask)
    if mode == 'sample':
        tiny = jnp.finfo(jnp.float32).tiny
        noise = -jnp.log(-jnp.log(jnp.clip(u, tiny, 1.0 - 1e-7)))
        scores = (jnp.log(jnp.maximum(probs, 1e-10)) +
                  jnp.where(probs > 0, 0.0, -1e9))
        index = jnp.argmax(scores + noise, axis=-1)
    elif mode == 'greedy':
        index = jdiscrete.categorical_argmax(probs)
    index = jax.lax.stop_gradient(index)
    return (probs, index, jdiscrete.categorical_log_prob(probs, index),
            jdiscrete.categorical_entropy(probs))


def _torch_head(logits, mask, u, index, mode):
    kwargs = dict(sample=dict(u=torch.from_numpy(u)),
                  given=dict(index=torch.from_numpy(index)),
                  greedy=dict(greedy=True))[mode]
    return fused_softmax.masked_categorical(logits, torch.from_numpy(mask),
                                            **kwargs)


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('shape', SHAPES)
def test_head_matches_jax_forward_and_gradient(shape, mode):
    logits, mask, u, index, (a, b, c) = _case(shape, seed=shape[0] + shape[1])
    j_probs, j_index, j_logp, j_ent = _jax_head(
        jnp.asarray(logits), jnp.asarray(mask), jnp.asarray(u),
        jnp.asarray(index), mode)
    pallas = masked_softmax_pallas(jnp.asarray(logits), jnp.asarray(mask),
                                   interpret=True)
    np.testing.assert_allclose(np.asarray(j_probs), np.asarray(pallas),
                               atol=ATOL)

    x = torch.from_numpy(logits).requires_grad_()
    kernel_common.reset_launch_counts()
    probs, t_index, logp, ent = _torch_head(x, mask, u, index, mode)
    assert not any(kernel_common.launch_counts.values())   # plain on the CPU
    assert t_index.dtype == torch.int64 and t_index.shape == shape[:1]
    np.testing.assert_array_equal(t_index.numpy(), np.asarray(j_index))
    for got, ref in ((probs, j_probs), (logp, j_logp), (ent, j_ent)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=0)
    assert not probs.detach().numpy()[~mask].any()
    assert not probs.detach().numpy()[::7].any()
    assert not ent.detach().numpy()[::7].any()

    def loss(x):
        _p, _i, lp, en = _jax_head(x, jnp.asarray(mask), jnp.asarray(u),
                                   jnp.asarray(index), mode)
        return jnp.sum(a * lp) + jnp.sum(b * en) + jnp.sum(c * _p)
    ref = jax.grad(loss)(jnp.asarray(logits))
    (got, ) = torch.autograd.grad(
        (torch.from_numpy(a) * logp).sum() + (torch.from_numpy(b) * ent).sum()
        + (torch.from_numpy(c) * probs).sum(), x)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=GRAD_TOL,
                               rtol=GRAD_TOL)
    assert not got.numpy()[~mask].any()


# the outputs that pass a gradient
GRADS = {'all': ('probs', 'logp', 'ent'), 'logp_ent': ('logp', 'ent'),
         'logp': ('logp', ), 'ent': ('ent', ), 'probs': ('probs', )}


@pytest.mark.parametrize('grads', list(GRADS))
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('shape', SHAPES)
def test_plain_backward_matches_autograd(shape, mode, grads):
    """masked_categorical_bwd_plain, the formula the backward kernel is held
    to on the card, against autograd of masked_categorical_plain, with the
    gradients autograd would leave out passed as None."""
    logits, mask, u, index, (a, b, c) = _case(shape, seed=shape[1])
    x = torch.from_numpy(logits).requires_grad_()
    probs, t_index, logp, ent = _torch_head(x, mask, u, index, mode)
    g_probs, g_logp, g_ent = (torch.from_numpy(g) if name in GRADS[grads]
                              else None for name, g in
                              (('probs', c), ('logp', a), ('ent', b)))
    outs, cots = zip(*[(o, g) for o, g in ((probs, g_probs), (logp, g_logp),
                                           (ent, g_ent)) if g is not None])
    (auto, ) = torch.autograd.grad(outs, x, cots)
    plain = fused_softmax.masked_categorical_bwd_plain(
        probs.detach(), t_index, g_probs, g_logp, g_ent)
    torch.testing.assert_close(plain, auto, rtol=GRAD_TOL, atol=GRAD_TOL)
    assert not plain.numpy()[~mask].any()


def test_probs_only_and_refusals():
    """No index, u or greedy: the softmax alone, masked_softmax's output;
    two of them at once are refused."""
    logits, mask, u, index, _cot = _case((12, 9), seed=3)
    x, m = torch.from_numpy(logits), torch.from_numpy(mask)
    probs, none_i, none_lp, none_ent = fused_softmax.masked_categorical(x, m)
    assert none_i is None and none_lp is None and none_ent is None
    torch.testing.assert_close(probs, fused_softmax.masked_softmax(x, m),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match='one of'):
        fused_softmax.masked_categorical(x, m, u=torch.from_numpy(u),
                                         greedy=True)
    with pytest.raises(ValueError, match='one of'):
        fused_softmax.masked_categorical_plain(
            x, m, index=torch.from_numpy(index), greedy=True)


@pytest.mark.parametrize('mode', MODES)
def test_head_is_the_discrete_chain_bit_for_bit(mode):
    """categorical_head on the CPU gives the very bits of discrete.py's
    functions in the order the agent called them before the fusion, and
    leaves the generator where categorical_sample leaves it."""
    logits, mask, _u, index, _cot = _case((140, 7), seed=5)
    x, m = torch.from_numpy(logits), torch.from_numpy(mask)
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    given = torch.from_numpy(index) if mode == 'given' else None
    head = discrete.categorical_head(x, m, gens[0], index=given,
                                     deterministic=mode == 'greedy')
    probs = discrete.masked_categorical_probs(x, m)
    if mode == 'given':
        chosen = given
    elif mode == 'greedy':
        chosen = discrete.categorical_argmax(probs)
    else:
        chosen = discrete.categorical_sample(gens[1], probs)
    old = (probs, chosen, discrete.categorical_log_prob(probs, chosen),
           discrete.categorical_entropy(probs))
    for got, ref in zip(head, old):
        assert torch.equal(got, ref)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def _old_head(logits, mask, generator, index=None, deterministic=False):
    """The chain the covariant agent ran before the fused head."""
    probs = discrete.masked_categorical_probs(logits, mask)
    if index is None:
        index = (discrete.categorical_argmax(probs) if deterministic else
                 discrete.categorical_sample(generator, probs))
    return (probs, index, discrete.categorical_log_prob(probs, index),
            discrete.categorical_entropy(probs))


@pytest.mark.parametrize('deterministic', [False, True])
def test_covariant_act_keeps_the_generators_draws(monkeypatch, deterministic):
    """One covariant act through the fused head and through the old chain
    from one generator state: the same actions and outputs and the same
    generator state after, bit for bit (the pipelined rollout transport
    relies on every draw keeping its shape and order)."""
    from molgym_tpu_torch.agents import covariant
    from molgym_tpu_torch.spaces import Observation
    cfg = dict(zs=(0, 1, 6, 8), canvas_size=5, network_width=16, maxl=2,
               num_cg_levels=2, num_channels_hidden=3,
               num_channels_per_element=2, num_gaussians=3, bag_scale=3,
               min_max_distance=(0.9, 1.8), beta=-10.0)
    torch.manual_seed(0)
    agent = covariant.CovariantAC(**cfg, device='cpu')
    rng = np.random.RandomState(7)
    batch, n = 12, cfg['canvas_size']
    n_atoms = rng.randint(0, n, size=batch)
    elements = np.zeros((batch, n), np.int64)
    positions = np.zeros((batch, n, 3), np.float32)
    for i in range(batch):
        elements[i, :n_atoms[i]] = rng.randint(1, 4, size=n_atoms[i])
        positions[i, :n_atoms[i]] = rng.randn(n_atoms[i], 3)
    bag = rng.randint(0, 3, size=(batch, 4))
    bag[:, 0] = 0
    bag[:, 1] += 1
    obs = Observation(*(torch.from_numpy(v) for v in
                        (elements, positions, bag)))

    def act(head):
        monkeypatch.setattr(covariant, 'categorical_head', head)
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            out = agent.act(obs, gen, deterministic)
            logp, ent, v = agent.evaluate(obs, out.action_flat)
        return out, (logp, ent, v), gen.get_state()

    new, old = act(discrete.categorical_head), act(_old_head)
    for field in ('action_flat', 'element', 'position', 'logp', 'ent', 'v'):
        assert torch.equal(getattr(new[0], field), getattr(old[0], field))
    for got, ref in zip(new[1], old[1]):
        assert torch.equal(got, ref)
    assert torch.equal(new[2], old[2])
