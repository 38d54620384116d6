"""The port's masked softmax (ops/fused_softmax.py) against molgym_tpu's
Pallas kernel (ops/pallas_softmax.py, in interpret mode, at the inputs of
tests/test_ops.py) and its dense function (ops/masked.py), forward and
gradient; the plain backward against torch.autograd; masked_sum and
masked_mean. The CUDA kernels are compared with the plain versions on the
card (tests/test_torch_kernels.py and chip_smoke.py).

Tolerance: 1e-6 absolute (the JAX test's: probabilities in float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molgym_tpu.ops import masked as jmasked
from molgym_tpu.ops.pallas_softmax import masked_softmax_pallas
from molgym_tpu_torch.distributions.discrete import masked_categorical_probs
from molgym_tpu_torch.ops import fused_agg, fused_softmax
from molgym_tpu_torch.ops import masked as tmasked

ATOL = 1e-6
# the heads' shapes at SF6 and at the stochastic configuration, the JAX
# test's, and one row longer than 128
SHAPES = [(5, 7, 25), (140, 7), (140, 3), (140, 10), (140, 4), (33, 200)]


def _case(shape, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(*shape).astype(np.float32)
    mask = rng.rand(*shape) > 0.4
    return logits, mask


@pytest.mark.parametrize('shape', SHAPES)
def test_plain_forward_matches_pallas_and_dense(shape):
    logits, mask = _case(shape, seed=0)
    out = fused_softmax.masked_softmax(torch.from_numpy(logits),
                                       torch.from_numpy(mask)).numpy()
    ref = masked_softmax_pallas(jnp.asarray(logits), jnp.asarray(mask),
                                interpret=True)
    dense = jmasked.masked_softmax(jnp.asarray(logits), jnp.asarray(mask))
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(out, np.asarray(dense), atol=ATOL)
    assert not out[~mask].any()


def test_fully_masked_row_is_zero_forward_and_backward():
    """The JAX test's second case, and the gradient of such a row."""
    logits = torch.ones(2, 8, requires_grad=True)
    mask = torch.zeros(2, 8, dtype=torch.bool)
    mask[1, 3] = True
    out = fused_softmax.masked_softmax(logits, mask)
    ref = masked_softmax_pallas(jnp.ones((2, 8)), jnp.asarray(mask.numpy()),
                                interpret=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=0)
    assert not out[0].any() and float(out[1, 3].detach()) == 1.0
    grad = torch.arange(16.0).reshape(2, 8)
    (auto, ) = torch.autograd.grad(out, logits, grad)
    plain = fused_softmax.masked_softmax_bwd_plain(out.detach(), grad)
    for g in (auto, plain):
        assert torch.isfinite(g).all() and not g.any()


@pytest.mark.parametrize('shape', SHAPES)
def test_gradients_match_jax(shape):
    """autograd through the plain forward, and the plain backward, against
    jax.grad of the dense JAX function (its Pallas kernel has no VJP)."""
    logits, mask = _case(shape, seed=1)
    cot = np.random.RandomState(2).randn(*shape).astype(np.float32)
    ref = jax.grad(lambda x: jnp.sum(jmasked.masked_softmax(
        x, jnp.asarray(mask)) * jnp.asarray(cot)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    probs = fused_softmax.masked_softmax(x, torch.from_numpy(mask))
    (auto, ) = torch.autograd.grad(probs, x, torch.from_numpy(cot))
    plain = fused_softmax.masked_softmax_bwd_plain(probs.detach(),
                                                   torch.from_numpy(cot))
    np.testing.assert_allclose(auto.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=ATOL)
    assert not plain.numpy()[~mask].any()


def test_wrapper_dispatches_on_the_device():
    logits, mask = _case((4, 5), seed=3)
    fused_agg.reset_launch_counts()
    out = masked_categorical_probs(torch.from_numpy(logits),
                                   torch.from_numpy(mask))
    torch.testing.assert_close(out, tmasked.masked_softmax(
        torch.from_numpy(logits), torch.from_numpy(mask)), rtol=0, atol=0)
    assert set(fused_agg.launch_counts) >= {'masked_softmax',
                                            'masked_softmax_bwd'}
    assert all(v == 0 for v in fused_agg.launch_counts.values())
    with pytest.raises(ValueError, match='no kernel'):
        fused_softmax.masked_softmax(torch.from_numpy(logits).to('meta'),
                                     torch.from_numpy(mask).to('meta'))


def test_a_zero_one_mask_is_a_bool_mask():
    logits, mask = _case((6, 9), seed=4)
    x = torch.from_numpy(logits)
    ref = fused_softmax.masked_softmax(x, torch.from_numpy(mask))
    for dtype in (torch.uint8, torch.float32, torch.int64):
        torch.testing.assert_close(
            fused_softmax.masked_softmax(x, torch.from_numpy(mask).to(dtype)),
            ref, rtol=0, atol=0)


@pytest.mark.parametrize('fn', ['masked_sum', 'masked_mean'])
def test_masked_sum_and_mean_match(fn):
    rng = np.random.RandomState(5)
    x = rng.randn(4, 6, 3).astype(np.float32)
    mask = rng.rand(4, 6) > 0.5
    mask[2] = False
    ref = getattr(jmasked, fn)(jnp.asarray(x), jnp.asarray(mask))
    out = getattr(tmasked, fn)(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert not out[2].any()
