"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the SF6 shapes of the main path, forward and backward, and the agent's
gradients through them. Every test here needs a CUDA card and skips without
one. The file imports no JAX, so that it also runs on a machine without it:

    python3 -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerance: 1e-4 relative and absolute (f32, another summation order); the
agent's gradients within 1e-3 of each leaf's largest |g| on the CPU (or of
1e-3 of the largest leaf's, for a leaf whose true gradient is zero)."""
import numpy as np
import pytest
import torch

from molgym_tpu_torch.ops import cg, fused_agg

MAXL, N = 4, 7
SF6_AGENT = dict(zs=(0, 9, 16), canvas_size=7, network_width=128, maxl=4,
                 num_cg_levels=3, num_channels_hidden=10,
                 num_channels_per_element=4, num_gaussians=3, bag_scale=5,
                 min_max_distance=(1.10, 2.10), beta=-10.0)


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


def _sf6_batch(batch, seed):
    """Random SF6 canvases (the bench.py recipe) and actions."""
    rng = np.random.RandomState(seed)
    n_atoms = rng.randint(1, 8, size=batch)
    elements = np.zeros((batch, 7), np.int64)
    positions = np.zeros((batch, 7, 3), np.float32)
    bag = np.zeros((batch, 3), np.int64)
    for b in range(batch):
        elements[b, :n_atoms[b]] = rng.randint(1, 3, size=n_atoms[b])
        positions[b, :n_atoms[b]] = rng.randn(n_atoms[b], 3) * 1.2
        bag[b, 1] = rng.randint(1, 6)
        bag[b, 2] = 1
    normal = rng.randn(batch, 3)
    actions = np.concatenate([
        rng.randint(0, n_atoms)[:, None], np.ones((batch, 1)),
        rng.uniform(1.1, 2.1, size=(batch, 1)),
        normal / np.linalg.norm(normal, axis=-1, keepdims=True)], axis=-1)
    return elements, positions, bag, actions.astype(np.float32)


@pytest.mark.cuda
def test_agent_backward_reaches_every_parameter(cuda_device):
    """The agent's loss on the card (through the kernels) gives a gradient
    to every parameter, equal to the same agent's on the CPU."""
    from molgym_tpu_torch.agents.covariant import CovariantAC
    from molgym_tpu_torch.spaces import Observation
    torch.manual_seed(0)
    agents = {'cuda': CovariantAC(**SF6_AGENT, device=cuda_device)}
    agents['cpu'] = CovariantAC(**SF6_AGENT, device='cpu')
    agents['cpu'].load_state_dict(agents['cuda'].state_dict())
    elements, positions, bag, actions = _sf6_batch(16, seed=2)
    grads = {}
    for name, agent in agents.items():
        dev = next(agent.parameters()).device
        obs = Observation(*(torch.from_numpy(x).to(dev)
                            for x in (elements, positions, bag)))
        logp, ent, v = agent.evaluate(obs, torch.from_numpy(actions).to(dev))
        loss = logp.mean() + 0.5 * (v ** 2).mean() + 0.01 * ent.mean()
        agent.zero_grad(set_to_none=True)
        loss.backward()
        grads[name] = {k: p.grad for k, p in agent.named_parameters()}
    missing = [k for k, g in grads['cuda'].items() if g is None]
    assert not missing, f'no gradient on the card for {missing}'
    # a leaf whose true gradient is zero (the focus head's last bias: a
    # softmax does not see a shift of its logits) holds rounding noise only
    floor = 1e-3 * max(float(g.abs().max()) for g in grads['cpu'].values())
    for k, g in grads['cpu'].items():
        scale = max(float(g.abs().max()), floor)
        err = float((grads['cuda'][k].cpu() - g).abs().max())
        assert err <= 1e-3 * scale, (k, err, scale)
