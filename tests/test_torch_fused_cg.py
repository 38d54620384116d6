"""The port's channel-wise packed CG product (ops/fused_cg.py) against
molgym_tpu's Pallas kernel (ops/pallas_cg.py, run in interpret mode as the
JAX package's own tests run it on the CPU), forward and gradient; its plain
backward against torch.autograd through the plain forward; and the tables
the CUDA kernels read (sparse columns with each entry's (m, n), sparse
rows), held against the plain versions by running the kernels' loops in
PyTorch. The kernels themselves are compared with the plain versions on the
card (tests/test_torch_kernels.py and chip_smoke.py).

Tolerance: forward 2e-5 absolute (the JAX test's, tests/covariant/
test_so3_ops.py), gradients 3e-4 relative and absolute (the JAX test's);
PyTorch against PyTorch 1e-5 relative, 2e-5 absolute (float32, another
summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molgym_tpu.ops import cg as jcg
from molgym_tpu.ops.pallas_cg import cg_contract_pallas
from molgym_tpu_torch.ops import cg as tcg
from molgym_tpu_torch.ops import fused_agg, fused_cg

# (n_ells1, n_ells2, maxl): the mixer's two products at SF6 (M = 1 x 25,
# 25 x 25) and at the stochastic configuration (1 x 16, 16 x 16), and an
# uneven pair
CONFIGS = [(1, 5, 4), (5, 5, 4), (1, 4, 3), (4, 4, 3), (3, 2, 3)]
RTOL, ATOL = 1e-5, 2e-5


def _case(n1, n2, maxl, seed, lead=(3, 4)):
    rng = np.random.RandomState(seed)
    m1, m2 = n1 * n1, n2 * n2
    table3, _sl = tcg._fused_cg_table(n1, n2, maxl)
    parts = [rng.randn(*lead, m).astype(np.float32) for m in (m1, m1, m2, m2)]
    grads = rng.randn(2, *lead, table3.shape[2]).astype(np.float32)
    return parts, grads, table3


def _stacked(r, i):
    return jnp.stack([jnp.asarray(r), jnp.asarray(i)], axis=-1)


@pytest.mark.parametrize('n1,n2,maxl', CONFIGS)
def test_plain_forward_matches_pallas(n1, n2, maxl):
    parts, _grads, table3 = _case(n1, n2, maxl, seed=n1 + n2)
    jtable, _sl = jcg._fused_cg_table(n1, n2, maxl)
    ref = cg_contract_pallas(_stacked(*parts[:2]), _stacked(*parts[2:]),
                             jtable, interpret=True)
    out_r, out_i = fused_cg.cg_contract_ri(*map(torch.from_numpy, parts),
                                           table3)
    np.testing.assert_allclose(out_r.numpy(), np.asarray(ref[..., 0]), atol=2e-5)
    np.testing.assert_allclose(out_i.numpy(), np.asarray(ref[..., 1]), atol=2e-5)


@pytest.mark.parametrize('n1,n2,maxl', CONFIGS)
def test_gradients_match_the_pallas_vjp(n1, n2, maxl):
    """autograd through the plain forward, and the plain backward, against
    jax.grad through the Pallas custom VJP."""
    parts, grads, table3 = _case(n1, n2, maxl, seed=3 + n1 + n2)
    jtable, _sl = jcg._fused_cg_table(n1, n2, maxl)
    cot = _stacked(*grads)

    def loss(a, b):
        return jnp.sum(cg_contract_pallas(a, b, jtable, interpret=True) * cot)

    ja, jb = jax.grad(loss, argnums=(0, 1))(_stacked(*parts[:2]),
                                            _stacked(*parts[2:]))
    ref = [ja[..., 0], ja[..., 1], jb[..., 0], jb[..., 1]]

    leaves = [torch.from_numpy(x).requires_grad_() for x in parts]
    out = fused_cg.cg_contract_ri(*leaves, table3)
    g = tuple(map(torch.from_numpy, grads))
    auto = torch.autograd.grad(out, leaves, g)
    plain = fused_cg.cg_contract_ri_bwd_plain(
        *(x.detach() for x in leaves), *g, table3)
    for a, p, j in zip(auto, plain, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=3e-4, atol=3e-4)
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=3e-4, atol=3e-4)
        torch.testing.assert_close(p, a, rtol=RTOL, atol=ATOL)


def test_one_tensor_as_both_operands_sums_both_gradients():
    """The mixer's square: autograd adds da and db of the plain backward."""
    parts, grads, table3 = _case(3, 3, 2, seed=5)
    a_r = torch.from_numpy(parts[0]).requires_grad_()
    a_i = torch.from_numpy(parts[1])
    out = fused_cg.cg_contract_ri(a_r, a_i, a_r, a_i, table3)
    g = tuple(map(torch.from_numpy, grads))
    (auto, ) = torch.autograd.grad(out, a_r, g)
    da_r, _da_i, db_r, _db_i = fused_cg.cg_contract_ri_bwd_plain(
        a_r.detach(), a_i, a_r.detach(), a_i, *g, table3)
    torch.testing.assert_close(da_r + db_r, auto, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('n1,n2,maxl', CONFIGS)
def test_kernel_tables_match_plain(n1, n2, maxl):
    """The kernels' loops, run in PyTorch. Forward: out[r, k] sums column
    k's entries c * a[m] * b[n]. Backward: dz from the sparse rows, then
    da[m] over n and db[n] over m."""
    parts, grads, table3 = _case(n1, n2, maxl, seed=7 + n1)
    a_r, a_i, b_r, b_i = map(torch.from_numpy, parts)
    g_r, g_i = map(torch.from_numpy, grads)
    m1, m2, k = table3.shape
    tabs = fused_cg.kernel_tables(table3, torch.device('cpu'))
    assert fused_cg.kernel_tables(table3, torch.device('cpu')) is tabs
    colptr, rowptr = tabs['colptr'].numpy(), tabs['rowptr'].numpy()
    nnz = int(np.count_nonzero(table3))
    assert colptr.shape == (k + 1, ) and colptr[-1] == nnz
    assert rowptr.shape == (m1 * m2 + 1, ) and rowptr[-1] == nnz
    assert tabs['ent_m'].dtype == tabs['ent_n'].dtype == torch.int32
    assert int(tabs['ent_m'].max()) < m1 and int(tabs['ent_n'].max()) < m2

    m, n = tabs['ent_m'].long(), tabs['ent_n'].long()
    col = torch.from_numpy(np.repeat(np.arange(k), np.diff(colptr)))
    xr, xi, yr, yi = a_r[..., m], a_i[..., m], b_r[..., n], b_i[..., n]
    out_r = torch.zeros(a_r.shape[:-1] + (k, )).index_add_(
        -1, col, tabs['coef'] * (xr * yr - xi * yi))
    out_i = torch.zeros(a_r.shape[:-1] + (k, )).index_add_(
        -1, col, tabs['coef'] * (xr * yi + xi * yr))
    ref = fused_cg.cg_contract_ri_plain(a_r, a_i, b_r, b_i, table3)
    torch.testing.assert_close(out_r, ref[0], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(out_i, ref[1], rtol=RTOL, atol=ATOL)

    row = torch.from_numpy(np.repeat(np.arange(m1 * m2), np.diff(rowptr)))

    def rows_contract(g):
        dz = g.new_zeros(g.shape[:-1] + (m1 * m2, ))
        return dz.index_add_(-1, row, g[..., tabs['col'].long()] *
                             tabs['coef_t']).unflatten(-1, (m1, m2))
    dz_r, dz_i = rows_contract(g_r), rows_contract(g_i)
    mine = ((dz_r * b_r[..., None, :] + dz_i * b_i[..., None, :]).sum(-1),
            (dz_i * b_r[..., None, :] - dz_r * b_i[..., None, :]).sum(-1),
            (dz_r * a_r[..., :, None] + dz_i * a_i[..., :, None]).sum(-2),
            (dz_i * a_r[..., :, None] - dz_r * a_i[..., :, None]).sum(-2))
    ref = fused_cg.cg_contract_ri_bwd_plain(a_r, a_i, b_r, b_i, g_r, g_i,
                                            table3)
    for x, r in zip(mine, ref):
        torch.testing.assert_close(x, r, rtol=RTOL, atol=ATOL)


def test_wrapper_dispatches_on_the_device():
    """CPU tensors take the plain version and launch nothing; a tensor on
    neither the CPU nor a CUDA card is refused."""
    parts, _grads, table3 = _case(2, 2, 1, seed=1)
    fused_agg.reset_launch_counts()
    fused_cg.cg_contract_ri(*map(torch.from_numpy, parts), table3)
    assert set(fused_agg.launch_counts) >= {'cg_contract_ri',
                                            'cg_contract_ri_bwd'}
    assert all(v == 0 for v in fused_agg.launch_counts.values())
    meta = [torch.from_numpy(x).to('meta') for x in parts]
    with pytest.raises(ValueError, match='no kernel'):
        fused_cg.cg_contract_ri(*meta, table3)


def test_packed_product_routes_through_the_wrapper(monkeypatch):
    """cg_product_packed_ri and the stacked cg_product_packed call
    cg_contract_ri with contiguous parts."""
    seen = []

    def spy(a_r, a_i, b_r, b_i, table3):
        seen.append(all(x.is_contiguous() for x in (a_r, a_i, b_r, b_i)))
        return fused_cg.cg_contract_ri(a_r, a_i, b_r, b_i, table3)
    monkeypatch.setattr(tcg, 'cg_contract_ri', spy)
    parts, _grads, _table3 = _case(3, 2, 3, seed=2)
    a_r, a_i, b_r, b_i = map(torch.from_numpy, parts)
    (out_r, out_i), slices = tcg.cg_product_packed_ri(a_r, a_i, b_r, b_i,
                                                      3, 2, 3)
    stacked, slices2 = tcg.cg_product_packed(
        torch.stack([a_r, a_i], -1), torch.stack([b_r, b_i], -1), 3, 2, 3)
    assert seen == [True, True] and slices == slices2
    torch.testing.assert_close(stacked[..., 0], out_r, rtol=0, atol=0)
    torch.testing.assert_close(stacked[..., 1], out_i, rtol=0, atol=0)
