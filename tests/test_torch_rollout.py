"""A tiny covariant rollout of the port on the CPU: Trajectory shapes,
finite values, and auto-reset after terminals."""
import numpy as np
import torch

from molgym_tpu_torch.agents.covariant import CovariantAC
from molgym_tpu_torch.envs.environment import MolecularEnv
from molgym_tpu_torch.envs.reward import make_lennard_jones_reward
from molgym_tpu_torch.formula import string_to_formula
from molgym_tpu_torch.ops import fused_agg
from molgym_tpu_torch.rl.rollout import make_rollout_fn
from molgym_tpu_torch.spaces import ObservationSpace


def test_tiny_rollout():
    torch.manual_seed(0)
    zs = [0, 1, 8]
    space = ObservationSpace(canvas_size=4, zs=zs)
    bag = space.bag_from_formula(string_to_formula('H2O'))
    env = MolecularEnv(make_lennard_jones_reward(), space, bag[None],
                       device='cpu')
    agent = CovariantAC(zs=tuple(zs), canvas_size=4, network_width=16, maxl=2,
                        num_cg_levels=2, num_channels_hidden=4,
                        num_channels_per_element=2, bag_scale=3,
                        min_max_distance=(0.9, 1.5), beta=-10.0, device='cpu')
    T, B = 7, 5
    rollout = make_rollout_fn(env, agent, T)
    fused_agg.reset_launch_counts()
    states, traj = rollout(agent, env.init_states(B),
                           torch.Generator().manual_seed(1))
    # the CPU path takes the plain versions: no kernel launch is counted
    assert all(v == 0 for v in fused_agg.launch_counts.values())

    assert traj.obs.elements.shape == (T, B, 4)
    assert traj.obs.positions.shape == (T, B, 4, 3)
    assert traj.next_obs.bag.shape == (T, B, 3)
    assert traj.actions.shape == (T, B, 6)
    for x in (traj.rewards, traj.terminals, traj.values, traj.logps):
        assert x.shape == (T, B)
    assert traj.bootstrap_value.shape == (B, )
    for x in (traj.rewards, traj.values, traj.logps, traj.bootstrap_value,
              traj.actions):
        assert torch.isfinite(x).all()
    assert traj.num_steps == T * B

    # every rollout starts from a reset canvas with the full bag
    assert (traj.obs.elements[0] == 0).all()
    full = torch.from_numpy(bag)
    assert (traj.obs.bag[0] == full).all()
    # H2O has 3 atoms: every episode ends within 4 steps (3 atoms + a stop or
    # an invalid action at the latest)
    term = traj.terminals.numpy()
    for b in range(B):
        ends = np.flatnonzero(term[:, b])
        starts = np.concatenate([[0], ends[:-1] + 1])
        assert len(ends) >= 1
        assert (ends - starts < 4).all()
    # after a terminal the next observation is a fresh canvas; otherwise it
    # is the post-step observation
    for t in range(T - 1):
        done = traj.terminals[t]
        assert (traj.obs.elements[t + 1][done] == 0).all()
        assert (traj.obs.bag[t + 1][done] == full).all()
        assert torch.equal(traj.obs.elements[t + 1][~done],
                           traj.next_obs.elements[t][~done])
    # the returned states are the post-rollout (auto-reset) states
    last_done = traj.terminals[-1]
    assert (states.elements[last_done] == 0).all()
    assert states.elements.shape == (B, 4)
