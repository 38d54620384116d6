"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the shapes of the main paths (SF6: M = 25, N = 7; the stochastic-bag
configuration: M = 16, N = 10), forward and backward, and the agent's
gradients through them. Every test here needs a CUDA card and skips without
one. The file imports no JAX, so that it also runs on a machine without it:

    python3 -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerance: 1e-4 relative and absolute (f32, another summation order); the
agent's gradients within 1e-3 of each leaf's largest |g| on the CPU (or of
1e-3 of the largest leaf's, for a leaf whose true gradient is zero). The
bf16 versions of the encoder's kernels within one bf16 ulp of their plain
versions on the same bf16 operands (both compute in f32 and round once, so
another summation order can move a rounding by one ulp at most)."""
import numpy as np
import pytest
import torch

from molgym_tpu_torch.ops import cg, fused_agg, fused_cg, fused_softmax

MAXL, N = 4, 7
SF6_AGENT = dict(zs=(0, 9, 16), canvas_size=7, network_width=128, maxl=4,
                 num_cg_levels=3, num_channels_hidden=10,
                 num_channels_per_element=4, num_gaussians=3, bag_scale=5,
                 min_max_distance=(1.10, 2.10), beta=-10.0)
STOCH_AGENT = dict(zs=(0, 1, 6, 8), canvas_size=10, network_width=128, maxl=3,
                   num_cg_levels=2, num_channels_hidden=10,
                   num_channels_per_element=4, num_gaussians=3, bag_scale=6,
                   min_max_distance=(0.9, 1.8), beta=-10.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('B', [140, 9])
@pytest.mark.parametrize('atom_n_ells', [1, 5])
def test_aggregate_kernel_matches_plain(cuda_device, B, atom_n_ells):
    tau, n_ells = 10, MAXL + 1
    gen = torch.Generator(device=cuda_device).manual_seed(B + atom_n_ells)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device)
    args = (randn(B, N, N, n_ells ** 2, 2), randn(B, N, N, tau, n_ells),
            randn(B, N, tau, atom_n_ells ** 2), randn(B, N, tau, atom_n_ells ** 2))
    table3, _sl = cg._fused_cg_table(n_ells, atom_n_ells, MAXL)
    g = cg.fused_cg_table_grouped(n_ells, atom_n_ells, MAXL)
    grouped = None if g is None else (g[0], g[1])
    before = fused_agg.launch_counts['cg_aggregate_edge_fused_ri']
    out = fused_agg.cg_aggregate_edge_fused_ri(*args, table3, grouped=grouped)
    torch.cuda.synchronize()
    assert fused_agg.launch_counts['cg_aggregate_edge_fused_ri'] == before + 1
    ref = fused_agg.cg_aggregate_edge_fused_ri_plain(*args, table3,
                                                     grouped=grouped)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('tau', [10, 12])
@pytest.mark.parametrize('mode', ['tri', 'dense'])
def test_square_kernel_matches_plain(cuda_device, tau, mode):
    n_ells = MAXL + 1
    gen = torch.Generator(device=cuda_device).manual_seed(tau)
    a_r, a_i = (torch.randn((140, N, tau, n_ells ** 2), generator=gen,
                            device=cuda_device) for _ in range(2))
    table3, _sl = cg._fused_cg_table(n_ells, n_ells, MAXL)
    tri = None
    if mode == 'tri':
        pairs, groups, _perm, _si = cg.fused_cg_table_tri(n_ells, MAXL)
        tri = (pairs, groups)
    before = fused_agg.launch_counts['cg_square_fused_ri']
    out = fused_agg.cg_square_fused_ri(a_r, a_i, table3, tri=tri)
    torch.cuda.synchronize()
    assert fused_agg.launch_counts['cg_square_fused_ri'] == before + 1
    ref = fused_agg.cg_square_fused_ri_plain(a_r, a_i, table3, tri=tri)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_refuses_non_contiguous(cuda_device):
    n_ells = MAXL + 1
    a = torch.randn((4, 3, n_ells ** 2 * 2), device=cuda_device)[..., ::2]
    table3, _sl = cg._fused_cg_table(n_ells, n_ells, MAXL)
    with pytest.raises(ValueError, match='contiguous'):
        fused_agg.cg_square_fused_ri(a, a, table3)


def _aggregate_args(device, B, atom_n_ells, seed):
    tau, n_ells = 10, MAXL + 1
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    args = (randn(B, N, N, n_ells ** 2, 2), randn(B, N, N, tau, n_ells),
            randn(B, N, tau, atom_n_ells ** 2), randn(B, N, tau, atom_n_ells ** 2))
    table3, _sl = cg._fused_cg_table(n_ells, atom_n_ells, MAXL)
    g = cg.fused_cg_table_grouped(n_ells, atom_n_ells, MAXL)
    return args, table3, None if g is None else (g[0], g[1]), randn


@pytest.mark.cuda
@pytest.mark.parametrize('B', [140, 9])
@pytest.mark.parametrize('atom_n_ells', [1, 5])
def test_aggregate_bwd_kernel_matches_plain(cuda_device, B, atom_n_ells):
    (sph, rad, q_r, q_i), table3, grouped, randn = _aggregate_args(
        cuda_device, B, atom_n_ells, 7 * B + atom_n_ells)
    leaves = [x.requires_grad_() for x in (rad, q_r, q_i)]
    out = fused_agg.cg_aggregate_edge_fused_ri(sph, *leaves, table3,
                                               grouped=grouped)
    grads = (randn(*out[0].shape), randn(*out[1].shape))
    before = fused_agg.launch_counts['cg_aggregate_edge_fused_ri_bwd']
    got = torch.autograd.grad(out, leaves, grads)
    torch.cuda.synchronize()
    assert fused_agg.launch_counts['cg_aggregate_edge_fused_ri_bwd'] == before + 1
    ref = fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(
        sph, *(x.detach() for x in leaves), *grads, table3, grouped=grouped)
    for o, r in zip(got, ref):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('tau', [10, 12])
@pytest.mark.parametrize('mode', ['tri', 'dense', 'grouped'])
def test_square_bwd_kernel_matches_plain(cuda_device, tau, mode):
    n_ells = MAXL + 1
    gen = torch.Generator(device=cuda_device).manual_seed(3 * tau)
    a_r, a_i = (torch.randn((140, N, tau, n_ells ** 2), generator=gen,
                            device=cuda_device).requires_grad_()
                for _ in range(2))
    table3, _sl = cg._fused_cg_table(n_ells, n_ells, MAXL)
    grouped = tri = None
    if mode == 'tri':
        pairs, groups, _perm, _si = cg.fused_cg_table_tri(n_ells, MAXL)
        tri = (pairs, groups)
    elif mode == 'grouped':
        g = cg.fused_cg_table_grouped(n_ells, n_ells, MAXL)
        grouped = (g[0], g[1])
    out = fused_agg.cg_square_fused_ri(a_r, a_i, table3, grouped=grouped,
                                       tri=tri)
    grads = tuple(torch.randn(o.shape, generator=gen, device=cuda_device)
                  for o in out)
    before = fused_agg.launch_counts['cg_square_fused_ri_bwd']
    got = torch.autograd.grad(out, (a_r, a_i), grads)
    torch.cuda.synchronize()
    assert fused_agg.launch_counts['cg_square_fused_ri_bwd'] == before + 1
    ref = fused_agg.cg_square_fused_ri_bwd_plain(
        a_r.detach(), a_i.detach(), *grads, table3, grouped=grouped, tri=tri)
    for o, r in zip(got, ref):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


@pytest.mark.cuda
def test_backward_takes_a_missing_gradient(cuda_device):
    """Only out_r reaches the loss: autograd passes None for out_i."""
    (sph, rad, q_r, q_i), table3, grouped, _randn = _aggregate_args(
        cuda_device, 9, 5, 1)
    rad.requires_grad_()
    out_r, _out_i = fused_agg.cg_aggregate_edge_fused_ri(sph, rad, q_r, q_i,
                                                         table3, grouped=grouped)
    (got, ) = torch.autograd.grad(out_r.sum(), rad)
    drad, _dq_r, _dq_i = fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(
        sph, rad.detach(), q_r, q_i, torch.ones_like(out_r),
        torch.zeros_like(out_r), table3, grouped=grouped)
    torch.testing.assert_close(got, drad, rtol=1e-4,
                               atol=1e-4 * float(drad.abs().max()))


def _aggregate_case(device, B, N, tau, maxl, atom_n_ells, seed):
    n_ells = maxl + 1
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    args = (randn(B, N, N, n_ells ** 2, 2), randn(B, N, N, tau, n_ells),
            randn(B, N, tau, atom_n_ells ** 2), randn(B, N, tau, atom_n_ells ** 2))
    table3, _sl = cg._fused_cg_table(n_ells, atom_n_ells, maxl)
    g = cg.fused_cg_table_grouped(n_ells, atom_n_ells, maxl)
    return args, table3, None if g is None else (g[0], g[1]), randn


@pytest.mark.cuda
@pytest.mark.parametrize('full_atom', [False, True], ids=['level0', 'upper'])
@pytest.mark.parametrize('maxl', [2, 3, 4])
@pytest.mark.parametrize('tau', [1, 10, 12])
@pytest.mark.parametrize('N', [3, 7, 10])
@pytest.mark.parametrize('B', [1, 9, 10, 140])
def test_aggregate_kernels_over_shapes(cuda_device, B, N, tau, maxl, full_atom):
    """Forward and backward kernels against their plain versions over batch
    sizes, canvas sizes, channel counts that the tile does and does not
    divide, and atom reps of one l and of maxl + 1; the backward twice on
    the same inputs gives the same bits."""
    atom_n_ells = maxl + 1 if full_atom else 1
    args, table3, grouped, randn = _aggregate_case(
        cuda_device, B, N, tau, maxl, atom_n_ells, B + N + tau + maxl)
    out = fused_agg._aggregate_fwd_kernel(*args, table3, grouped)
    torch.cuda.synchronize()
    ref = fused_agg.cg_aggregate_edge_fused_ri_plain(*args, table3,
                                                     grouped=grouped)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))
    grads = (randn(*out[0].shape), randn(*out[1].shape))
    got = fused_agg._aggregate_bwd_kernel(*args, *grads, table3, grouped)
    again = fused_agg._aggregate_bwd_kernel(*args, *grads, table3, grouped)
    torch.cuda.synchronize()
    ref = fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(*args, *grads, table3,
                                                         grouped=grouped)
    for o, o2, r in zip(got, again, ref):
        assert torch.equal(o, o2)
        torch.testing.assert_close(o, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))


@pytest.mark.cuda
def test_aggregate_kernels_refuse_what_they_cannot_tile(cuda_device):
    """A neighbourhood too large for a block's shared memory (forward) or
    for one block's threads (backward) raises, with the shape named; at the
    main shapes at least four blocks of each kernel fit an SM."""
    args, table3, grouped, randn = _aggregate_case(cuda_device, 1, 600, 1, 4,
                                                   5, 0)
    with pytest.raises(ValueError, match='N=600.*shared memory'):
        fused_agg._aggregate_fwd_kernel(*args, table3, grouped)
    args, table3, grouped, randn = _aggregate_case(cuda_device, 1, 64, 1, 4, 5, 0)
    k = fused_agg._kernel_tables('aggregate', table3, grouped, None,
                                 cuda_device)['k']
    with pytest.raises(ValueError, match='N=64.*more than 192 outputs'):
        fused_agg._aggregate_bwd_kernel(*args, randn(1, 64, 1, k),
                                        randn(1, 64, 1, k), table3, grouped)
    for maxl, n, N in ((4, 5, 7), (4, 1, 7), (3, 4, 10), (3, 1, 10)):
        table3, _sl = cg._fused_cg_table(maxl + 1, n, maxl)
        g = cg.fused_cg_table_grouped(maxl + 1, n, maxl)
        grouped = None if g is None else (g[0], g[1])
        res = fused_agg.aggregate_kernel_resources(140, N, 10, maxl + 1, n * n,
                                                   table3, grouped, cuda_device)
        assert res['fwd']['blocks_per_sm'] >= 4 and res['bwd']['blocks_per_sm'] >= 4


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['tri', 'dense', 'grouped'])
@pytest.mark.parametrize('maxl', [2, 3, 4])
@pytest.mark.parametrize('tau', [1, 10, 12, 16])
@pytest.mark.parametrize('B', [1, 9, 10, 140])
def test_square_kernels_over_shapes(cuda_device, B, tau, maxl, mode):
    """Forward and backward kernels of the square against their plain
    versions over batch sizes (every tile of rows the host picks, rows no
    tile divides), channel counts and all three table modes; the backward
    twice on the same inputs gives the same bits."""
    n_ells = maxl + 1
    N = {2: 3, 3: 10, 4: 7}[maxl]
    gen = torch.Generator(device=cuda_device).manual_seed(B + tau + maxl)
    table3, _sl = cg._fused_cg_table(n_ells, n_ells, maxl)
    grouped = tri = None
    if mode == 'tri':
        pairs, groups, _perm, _si = cg.fused_cg_table_tri(n_ells, maxl)
        tri = (pairs, groups)
    elif mode == 'grouped':     # no grouped table below maxl 4: dense
        g = cg.fused_cg_table_grouped(n_ells, n_ells, maxl)
        grouped = None if g is None else (g[0], g[1])
    a = tuple(torch.randn((B, N, tau, n_ells ** 2), generator=gen,
                          device=cuda_device) for _ in range(2))
    out = fused_agg._square_fwd_kernel(*a, table3, grouped, tri)
    torch.cuda.synchronize()
    ref = fused_agg.cg_square_fused_ri_plain(*a, table3, grouped=grouped,
                                             tri=tri)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))
    grads = tuple(torch.randn(o.shape, generator=gen, device=cuda_device)
                  for o in out)
    got = fused_agg._square_bwd_kernel(*a, *grads, table3, grouped, tri)
    again = fused_agg._square_bwd_kernel(*a, *grads, table3, grouped, tri)
    torch.cuda.synchronize()
    ref = fused_agg.cg_square_fused_ri_bwd_plain(*a, *grads, table3,
                                                 grouped=grouped, tri=tri)
    for o, o2, r in zip(got, again, ref):
        assert torch.equal(o, o2)
        torch.testing.assert_close(o, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))


@pytest.mark.cuda
def test_square_kernels_take_no_rows_and_report_resources(cuda_device):
    """An empty batch launches nothing and returns empty outputs; at the
    main shapes at least four blocks of each kernel fit an SM."""
    for maxl in (4, 3):
        n_ells = maxl + 1
        table3, _sl = cg._fused_cg_table(n_ells, n_ells, maxl)
        pairs, groups, _perm, _si = cg.fused_cg_table_tri(n_ells, maxl)
        tri = (pairs, groups)
        a = torch.zeros((0, 7, 10, n_ells ** 2), device=cuda_device)
        out = fused_agg._square_fwd_kernel(a, a, table3, None, tri)
        k = out[0].shape[-1]
        assert out[0].shape == (0, 7, 10, k)
        g = torch.zeros((0, 7, 10, k), device=cuda_device)
        da = fused_agg._square_bwd_kernel(a, a, g, g, table3, None, tri)
        assert da[0].shape == a.shape
        res = fused_agg.square_kernel_resources(140 * 70, table3, None, tri,
                                                cuda_device)
        assert res['fwd']['blocks_per_sm'] >= 4
        assert res['bwd']['blocks_per_sm'] >= 4


# (leading dims incl. tau, n_ells1, n_ells2, maxl): the mixer's two products
# at SF6 (140 envs, 10 and 1) and at the stochastic configuration (140 and
# 1), and row counts that no tile divides at each (111 rows, one tile of
# 1 row a block; 665, tiles of 4 and a last short one)
CONTRACT_CASES = [((140, 4), 1, 5, 4), ((140, 4), 5, 5, 4), ((10, 4), 5, 5, 4),
                  ((1, 4), 1, 5, 4), ((1, 4), 5, 5, 4),
                  ((140, 4), 1, 4, 3), ((140, 4), 4, 4, 3),
                  ((1, 4), 1, 4, 3), ((1, 4), 4, 4, 3),
                  ((37, 3), 5, 5, 4), ((37, 3), 1, 5, 4), ((133, 5), 5, 5, 4),
                  ((37, 3), 4, 4, 3), ((133, 5), 4, 4, 3)]


def _contract_args(device, lead, n1, n2, maxl, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    table3, _sl = cg._fused_cg_table(n1, n2, maxl)
    args = (randn(*lead, n1 * n1), randn(*lead, n1 * n1),
            randn(*lead, n2 * n2), randn(*lead, n2 * n2))
    return args, table3, randn


@pytest.mark.cuda
@pytest.mark.parametrize('lead,n1,n2,maxl', CONTRACT_CASES)
def test_contract_kernels_match_plain(cuda_device, lead, n1, n2, maxl):
    """Forward and backward through the public wrapper and autograd."""
    args, table3, randn = _contract_args(cuda_device, lead, n1, n2, maxl, 11)
    leaves = [x.requires_grad_() for x in args]
    before = dict(fused_agg.launch_counts)
    out = fused_cg.cg_contract_ri(*leaves, table3)
    torch.cuda.synchronize()
    assert fused_agg.launch_counts['cg_contract_ri'] == before['cg_contract_ri'] + 1
    assert out[0].shape == lead + (table3.shape[2], )
    detached = [x.detach() for x in leaves]
    ref = fused_cg.cg_contract_ri_plain(*detached, table3)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4)
    grads = (randn(*out[0].shape), randn(*out[1].shape))
    got = torch.autograd.grad(out, leaves, grads)
    torch.cuda.synchronize()
    assert (fused_agg.launch_counts['cg_contract_ri_bwd'] ==
            before['cg_contract_ri_bwd'] + 1)
    ref = fused_cg.cg_contract_ri_bwd_plain(*detached, *grads, table3)
    for o, r in zip(got, ref):
        torch.testing.assert_close(o, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize('lead,n1,n2,maxl', CONTRACT_CASES)
def test_contract_backward_gives_the_same_bits(cuda_device, lead, n1, n2, maxl):
    """Every output of the backward is one thread's sum in a fixed order."""
    args, table3, randn = _contract_args(cuda_device, lead, n1, n2, maxl, 13)
    k = table3.shape[2]
    grads = (randn(*lead, k), randn(*lead, k))
    first = fused_cg._bwd_kernel(*args, *grads, table3)
    second = fused_cg._bwd_kernel(*args, *grads, table3)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize('n1,n2,maxl', [(1, 5, 4), (5, 5, 4), (4, 4, 3)])
def test_contract_takes_an_empty_batch_and_fits_the_card(cuda_device, n1, n2,
                                                         maxl):
    """No rows: empty outputs and nothing run. At the path's rows every
    block of both kernels fits an SM at least twice."""
    table3, _sl = cg._fused_cg_table(n1, n2, maxl)
    m1, m2, k = table3.shape
    a = torch.zeros((0, 4, m1), device=cuda_device)
    b = torch.zeros((0, 4, m2), device=cuda_device)
    out = fused_cg._fwd_kernel(a, a, b, b, table3)
    assert out[0].shape == (0, 4, k)
    g = torch.zeros((0, 4, k), device=cuda_device)
    grads = fused_cg._bwd_kernel(a, a, b, b, g, g, table3)
    torch.cuda.synchronize()
    assert [x.shape for x in grads] == [a.shape, a.shape, b.shape, b.shape]
    for n_rows in (560, 40, 4):
        res = fused_cg.product_kernel_resources(n_rows, table3, cuda_device)
        assert res['fwd']['blocks_per_sm'] >= 2
        assert res['bwd']['blocks_per_sm'] >= 2


@pytest.mark.cuda
def test_contract_of_a_rep_with_itself_sums_both_gradients(cuda_device):
    """The mixer's square passes one tensor as both operands."""
    (a_r, a_i, _b_r, _b_i), table3, randn = _contract_args(
        cuda_device, (9, 4), 5, 5, 4, 3)
    a_r.requires_grad_()
    out = fused_cg.cg_contract_ri(a_r, a_i, a_r, a_i, table3)
    grads = (randn(*out[0].shape), randn(*out[1].shape))
    (got, ) = torch.autograd.grad(out, a_r, grads)
    da_r, _da_i, db_r, _db_i = fused_cg.cg_contract_ri_bwd_plain(
        a_r.detach(), a_i, a_r.detach(), a_i, *grads, table3)
    ref = da_r + db_r
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
def test_contract_refuses_non_contiguous_and_takes_a_missing_gradient(cuda_device):
    (a_r, a_i, b_r, b_i), table3, _randn = _contract_args(
        cuda_device, (9, 4), 5, 5, 4, 5)
    stacked = torch.stack([a_r, a_i], dim=-1)
    with pytest.raises(ValueError, match='contiguous'):
        fused_cg.cg_contract_ri(stacked[..., 0], stacked[..., 1], b_r, b_i,
                                table3)
    with pytest.raises(ValueError, match='contiguous'):
        fused_cg.cg_contract_ri(a_r, a_i, b_r[:, :1].expand(9, 4, 25), b_i,
                                table3)
    # only out_r reaches the loss: autograd passes None for out_i
    b_r.requires_grad_()
    out_r, _out_i = fused_cg.cg_contract_ri(a_r, a_i, b_r, b_i, table3)
    (got, ) = torch.autograd.grad(out_r.sum(), b_r)
    _da_r, _da_i, db_r, _db_i = fused_cg.cg_contract_ri_bwd_plain(
        a_r, a_i, b_r.detach(), b_i, torch.ones_like(out_r),
        torch.zeros_like(out_r), table3)
    torch.testing.assert_close(got, db_r, rtol=1e-4,
                               atol=1e-4 * float(db_r.abs().max()))


def _softmax_args(device, rows, n, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    logits = 3.0 * torch.randn((rows, n), generator=gen, device=device)
    mask = torch.rand((rows, n), generator=gen, device=device) > 0.4
    mask[::7] = False                  # some rows fully masked
    mask[1, :] = True
    return logits, mask, gen


@pytest.mark.cuda
@pytest.mark.parametrize('rows,n', [(140, 7), (140, 3), (140, 10), (140, 4),
                                    (8192, 128), (33, 200)])
def test_softmax_kernels_match_plain(cuda_device, rows, n):
    logits, mask, gen = _softmax_args(cuda_device, rows, n, rows + n)
    logits.requires_grad_()
    before = dict(fused_agg.launch_counts)
    probs = fused_softmax.masked_softmax(logits, mask)
    torch.cuda.synchronize()
    assert fused_agg.launch_counts['masked_softmax'] == before['masked_softmax'] + 1
    ref = fused_softmax.masked_softmax_plain(logits.detach(), mask)
    torch.testing.assert_close(probs, ref, rtol=1e-4, atol=1e-6)
    assert not probs[~mask].any() and not probs[::7].any()
    grad = torch.randn(probs.shape, generator=gen, device=cuda_device)
    (got, ) = torch.autograd.grad(probs, logits, grad)
    torch.cuda.synchronize()
    assert (fused_agg.launch_counts['masked_softmax_bwd'] ==
            before['masked_softmax_bwd'] + 1)
    ref = fused_softmax.masked_softmax_bwd_plain(probs.detach(), grad)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-6)
    assert torch.isfinite(got).all() and not got[::7].any()
    # a uint8 mask is the same bytes
    torch.testing.assert_close(
        fused_softmax.masked_softmax(logits.detach(), mask.to(torch.uint8)),
        probs.detach(), rtol=0, atol=0)


@pytest.mark.cuda
def test_softmax_leading_dims_and_refusals(cuda_device):
    logits, mask, _gen = _softmax_args(cuda_device, 35, 25, 1)
    out = fused_softmax.masked_softmax(logits.reshape(5, 7, 25),
                                       mask.reshape(5, 7, 25))
    torch.testing.assert_close(
        out.reshape(35, 25), fused_softmax.masked_softmax_plain(logits, mask),
        rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match='contiguous'):
        fused_softmax.masked_softmax(logits.T, mask.T)
    with pytest.raises(TypeError, match='bool'):
        fused_softmax.masked_softmax(logits, mask.float())
    with pytest.raises(ValueError, match='mask'):
        fused_softmax.masked_softmax(logits, mask[:, :5].contiguous())
    with pytest.raises(ValueError):
        fused_softmax.masked_softmax(logits, mask.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['given', 'greedy', 'sample'])
@pytest.mark.parametrize('rows,n', [(140, 7), (140, 3), (33, 200)])
def test_categorical_head_kernels_match_plain(cuda_device, rows, n, mode):
    """The fused head (softmax, index, logp, ent in one launch, one launch
    backward) against its plain chain: probs, logp, ent within 1e-6,
    indices equal but at a near-tie of the best two scores (1e-5), the
    backward through autograd within 1e-5 of max |ref|."""
    logits, mask, gen = _softmax_args(cuda_device, rows, n, rows + n + 1)
    kw = dict(given=dict(index=torch.randint(0, n, (rows, ), generator=gen,
                                             device=cuda_device)),
              greedy=dict(greedy=True),
              sample=dict(u=torch.rand((rows, n), generator=gen,
                                       device=cuda_device)))[mode]
    g_logp, g_ent = (torch.randn(rows, generator=gen, device=cuda_device)
                     for _ in range(2))
    x = logits.requires_grad_()
    before = dict(fused_agg.launch_counts)
    probs, index, logp, ent = fused_softmax.masked_categorical(x, mask, **kw)
    (got, ) = torch.autograd.grad((logp, ent), x, (g_logp, g_ent))
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in fused_agg.launch_counts.items()}
    assert launched['masked_softmax'] == 1
    assert launched['masked_softmax_bwd'] == 1
    ref = fused_softmax.masked_categorical_plain(logits.detach(), mask, **kw)
    for o, r in ((probs, ref[0]), (logp, ref[2]), (ent, ref[3])):
        torch.testing.assert_close(o.detach(), r, rtol=1e-6, atol=1e-6)
    if mode == 'given':
        assert torch.equal(index, kw['index'])
    else:
        scores = ref[0] if mode == 'greedy' else (
            torch.log(ref[0].clamp(min=1e-10)) +
            torch.where(ref[0] > 0, 0.0, -1e9) +
            fused_softmax.gumbel_from_uniform(kw['u']))
        top2 = scores.topk(2, dim=-1).values
        assert ((index == ref[1]) | (top2[:, 0] - top2[:, 1] <= 1e-5)).all()
    plain = fused_softmax.masked_categorical_bwd_plain(
        probs.detach(), index, None, g_logp, g_ent)
    torch.testing.assert_close(got, plain, rtol=0,
                               atol=1e-5 * float(plain.abs().max()))
    assert not got[~mask].any()


def _batch(cfg, batch, seed):
    """Random canvases (the bench.py recipe) and actions."""
    rng = np.random.RandomState(seed)
    n, nz = cfg['canvas_size'], len(cfg['zs'])
    lo, hi = cfg['min_max_distance']
    n_atoms = rng.randint(1, n + 1, size=batch)
    elements = np.zeros((batch, n), np.int64)
    positions = np.zeros((batch, n, 3), np.float32)
    bag = np.zeros((batch, nz), np.int64)
    for b in range(batch):
        elements[b, :n_atoms[b]] = rng.randint(1, nz, size=n_atoms[b])
        positions[b, :n_atoms[b]] = rng.randn(n_atoms[b], 3) * 1.2
        bag[b, 1] = rng.randint(1, 6)
        bag[b, 2] = 1
    normal = rng.randn(batch, 3)
    actions = np.concatenate([
        rng.randint(0, n_atoms)[:, None], np.ones((batch, 1)),
        rng.uniform(lo, hi, size=(batch, 1)),
        normal / np.linalg.norm(normal, axis=-1, keepdims=True)], axis=-1)
    return elements, positions, bag, actions.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize('cfg', [SF6_AGENT, STOCH_AGENT], ids=['sf6', 'stoch'])
def test_agent_backward_reaches_every_parameter(cuda_device, cfg):
    """The agent's loss on the card (through the kernels) gives a gradient
    to every parameter, equal to the same agent's on the CPU."""
    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.spaces import Observation
    torch.manual_seed(0)
    agents = {'cuda': CovariantAC(**cfg, device=cuda_device)}
    agents['cpu'] = CovariantAC(**cfg, device='cpu')
    agents['cpu'].load_state_dict(agents['cuda'].state_dict())
    elements, positions, bag, actions = _batch(cfg, 16, seed=2)
    grads = {}
    before = dict(fused_agg.launch_counts)
    for name, agent in agents.items():
        dev = next(agent.parameters()).device
        obs = Observation(*(torch.from_numpy(x).to(dev)
                            for x in (elements, positions, bag)))
        logp, ent, v = agent.evaluate(obs, torch.from_numpy(actions).to(dev))
        loss = logp.mean() + 0.5 * (v ** 2).mean() + 0.01 * ent.mean()
        agent.zero_grad(set_to_none=True)
        loss.backward()
        grads[name] = {k: p.grad for k, p in agent.named_parameters()}
    # one forward and one backward: each CG level's two kernels, and the
    # heads' two products and two softmaxes
    levels = cfg['num_cg_levels']
    launched = {k: v - before[k] for k, v in fused_agg.launch_counts.items()}
    assert launched == dict(
        dict.fromkeys(launched, 0),     # no bf16 version in an f32 agent
        cg_aggregate_edge_fused_ri=levels, cg_square_fused_ri=levels,
        cg_aggregate_edge_fused_ri_bwd=levels,
        cg_square_fused_ri_bwd=levels, cg_contract_ri=2,
        cg_contract_ri_bwd=2, masked_softmax=2, masked_softmax_bwd=2)
    missing = [k for k, g in grads['cuda'].items() if g is None]
    assert not missing, f'no gradient on the card for {missing}'
    # a leaf whose true gradient is zero (the focus head's last bias: a
    # softmax does not see a shift of its logits) holds rounding noise only
    floor = 1e-3 * max(float(g.abs().max()) for g in grads['cpu'].values())
    for k, g in grads['cpu'].items():
        scale = max(float(g.abs().max()), floor)
        err = float((grads['cuda'][k].cpu() - g).abs().max())
        assert err <= 1e-3 * scale, (k, err, scale)


# ---------------------------------------------------------------------------
# the bf16 versions of the encoder's four kernels
# ---------------------------------------------------------------------------

def assert_within_one_ulp(got, ref):
    """bf16 `got` within one bf16 ulp of bf16 `ref` everywhere:
    |got - ref| <= 2^-7 |ref| + 1e-5 max |ref|."""
    assert got.dtype == ref.dtype == torch.bfloat16
    assert got.shape == ref.shape
    g, r = got.float(), ref.float()
    tol = 2.0 ** -7 * r.abs() + 1e-5 * float(r.abs().max())
    worst = float(((g - r).abs() - tol).max()) if r.numel() else 0.0
    assert worst <= 0.0, f'{worst} above one ulp'


def _shifted(t, shift):
    """`t` copied into a contiguous tensor whose storage starts `shift`
    elements into its allocation (shift 1: every bf16 row of odd width
    starts on a 2-byte, not a 4-byte, boundary)."""
    if not shift:
        return t.contiguous()
    buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    out = buf[shift:].view(t.shape)
    out.copy_(t)
    return out


def _launched(before):
    return {k: v - before[k] for k, v in fused_agg.launch_counts.items() if
            v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize('shift', [0, 1])
@pytest.mark.parametrize('full_atom', [False, True], ids=['level0', 'upper'])
@pytest.mark.parametrize('maxl,N,tau', [(4, 7, 10), (3, 10, 10), (4, 7, 3),
                                        (3, 10, 7), (2, 3, 5)])
@pytest.mark.parametrize('B', [1, 10, 140])
def test_bf16_aggregate_kernels_within_one_ulp(cuda_device, B, maxl, N, tau,
                                               full_atom, shift):
    """M = 25, 16 and 9, odd channel counts, rows that start on odd 2-byte
    addresses: forward and backward against the plain versions on the same
    bf16 operands, the backward the same bits twice, counted as bf16."""
    atom_n_ells = maxl + 1 if full_atom else 1
    args, table3, grouped, randn = _aggregate_case(
        cuda_device, B, N, tau, maxl, atom_n_ells, B + N + tau + maxl + shift)
    args = tuple(_shifted(x.to(torch.bfloat16), shift) for x in args)
    before = dict(fused_agg.launch_counts)
    out = fused_agg._aggregate_fwd_kernel(*args, table3, grouped)
    torch.cuda.synchronize()
    ref = fused_agg.cg_aggregate_edge_fused_ri_plain(*args, table3,
                                                     grouped=grouped)
    for o, r in zip(out, ref):
        assert_within_one_ulp(o, r)
    grads = tuple(_shifted(randn(*out[0].shape).to(torch.bfloat16), shift)
                  for _ in range(2))
    got = fused_agg._aggregate_bwd_kernel(*args, *grads, table3, grouped)
    again = fused_agg._aggregate_bwd_kernel(*args, *grads, table3, grouped)
    torch.cuda.synchronize()
    assert _launched(before) == {'cg_aggregate_edge_fused_ri_bf16': 1,
                                 'cg_aggregate_edge_fused_ri_bwd_bf16': 2}
    ref = fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(*args, *grads, table3,
                                                         grouped=grouped)
    for o, o2, r in zip(got, again, ref):
        assert torch.equal(o, o2)
        assert_within_one_ulp(o, r)


@pytest.mark.cuda
@pytest.mark.parametrize('shift', [0, 1])
@pytest.mark.parametrize('mode', ['tri', 'dense'])
@pytest.mark.parametrize('maxl', [3, 4])
@pytest.mark.parametrize('tau', [3, 10, 16])
@pytest.mark.parametrize('B', [1, 10, 140])
def test_bf16_square_kernels_within_one_ulp(cuda_device, B, tau, maxl, mode,
                                            shift):
    """Every tile of rows the host picks, M = 25 and 16, odd widths and odd
    starting addresses: forward and backward against the plain versions on
    the same bf16 operands, the backward the same bits twice."""
    n_ells = maxl + 1
    N = {3: 10, 4: 7}[maxl]
    gen = torch.Generator(device=cuda_device).manual_seed(B + tau + maxl)
    table3, _sl = cg._fused_cg_table(n_ells, n_ells, maxl)
    tri = None
    if mode == 'tri':
        pairs, groups, _perm, _si = cg.fused_cg_table_tri(n_ells, maxl)
        tri = (pairs, groups)

    def bf16(*shape):
        return _shifted(torch.randn(shape, generator=gen, device=cuda_device)
                        .to(torch.bfloat16), shift)
    a = (bf16(B, N, tau, n_ells ** 2), bf16(B, N, tau, n_ells ** 2))
    before = dict(fused_agg.launch_counts)
    out = fused_agg._square_fwd_kernel(*a, table3, None, tri)
    torch.cuda.synchronize()
    ref = fused_agg.cg_square_fused_ri_plain(*a, table3, tri=tri)
    for o, r in zip(out, ref):
        assert_within_one_ulp(o, r)
    grads = (bf16(*out[0].shape), bf16(*out[0].shape))
    got = fused_agg._square_bwd_kernel(*a, *grads, table3, None, tri)
    again = fused_agg._square_bwd_kernel(*a, *grads, table3, None, tri)
    torch.cuda.synchronize()
    assert _launched(before) == {'cg_square_fused_ri_bf16': 1,
                                 'cg_square_fused_ri_bwd_bf16': 2}
    ref = fused_agg.cg_square_fused_ri_bwd_plain(*a, *grads, table3, tri=tri)
    for o, o2, r in zip(got, again, ref):
        assert torch.equal(o, o2)
        assert_within_one_ulp(o, r)


@pytest.mark.cuda
def test_bf16_autograd_passes_bf16_cotangents(cuda_device):
    """Through the public wrappers: bf16 outputs, bf16 gradients from
    non-contiguous bf16 cotangents, the same as the plain backward's."""
    args, table3, grouped, randn = _aggregate_case(cuda_device, 9, 7, 10, 4,
                                                   5, 3)
    sph, rad, q_r, q_i = (x.to(torch.bfloat16) for x in args)
    leaves = [x.requires_grad_() for x in (rad, q_r, q_i)]
    out = fused_agg.cg_aggregate_edge_fused_ri(sph, *leaves, table3,
                                               grouped=grouped)
    assert all(o.dtype == torch.bfloat16 for o in out)
    # every other channel of a wider tensor: not contiguous
    grads = tuple(randn(*out[0].shape[:-2], 2 * out[0].shape[-2],
                        out[0].shape[-1]).to(torch.bfloat16)[..., ::2, :]
                  for _ in range(2))
    assert not grads[0].is_contiguous()
    got = torch.autograd.grad(out, leaves, grads)
    ref = fused_agg.cg_aggregate_edge_fused_ri_bwd_plain(
        sph, *(x.detach() for x in leaves), *grads, table3, grouped=grouped)
    for o, r in zip(got, ref):
        assert_within_one_ulp(o, r)


@pytest.mark.cuda
def test_kernels_refuse_mixed_dtypes(cuda_device):
    n_ells = MAXL + 1
    table3, _sl = cg._fused_cg_table(n_ells, n_ells, MAXL)
    a = torch.randn((4, 3, n_ells ** 2), device=cuda_device)
    with pytest.raises(TypeError, match='one dtype'):
        fused_agg.cg_square_fused_ri(a, a.to(torch.bfloat16), table3)
    with pytest.raises(TypeError, match='float16'):
        fused_agg.cg_square_fused_ri(a.half(), a.half(), table3)
