"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the SF6 shapes of the main path. Every test here needs a CUDA card and
skips without one. The file imports no JAX, so that it also runs on a
machine without it:

    python3 -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerance: 1e-4 relative and absolute (f32, another summation order)."""
import pytest
import torch

from molgym_tpu_torch.ops import cg, fused_agg

MAXL, N = 4, 7


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
