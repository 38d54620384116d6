"""On-device rollout (counterpart of make_rollout_fn in
molgym_tpu/rl/rollout.py): all envs are reset at rollout start, stepped T
times with auto-reset at terminals, and the value head on the final
observation gives the bootstrap value. The JAX `lax.scan` becomes a Python
loop; the rollout runs without autograd. A stochastic-bag env draws its
bags from the rollout's generator."""
from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from molgym_tpu_torch.envs.environment import EnvState, MolecularEnv
from molgym_tpu_torch.rl.buffer import Trajectory
from molgym_tpu_torch.spaces import Observation


def make_rollout_fn(env: MolecularEnv, agent: nn.Module,
                    num_steps_per_env: int,
                    deterministic: bool = False) -> Callable:
    """Returns rollout(params_or_module, states, generator) ->
    (states, Trajectory). `params_or_module` is the agent itself (or another
    module of its kind) or a state_dict to load into `agent` first.
    `deterministic` takes the policy's mode at every step (greedy
    evaluation) instead of sampling."""

    def rollout(params, states: EnvState,
                generator: torch.Generator) -> Tuple[EnvState, Trajectory]:
        if isinstance(params, nn.Module):
            module = params
        else:
            agent.load_state_dict(params)
            module = agent
        obs_seq, next_obs_seq = [], []
        act_seq, rew_seq, term_seq, val_seq, logp_seq = [], [], [], [], []
        with torch.no_grad():
            states, obs = env.reset(states, generator)
            for _ in range(num_steps_per_env):
                out = module.act(obs, generator, deterministic)
                result = env.step(states, out.element, out.position)
                obs_seq.append(obs)
                next_obs_seq.append(result.observation)
                act_seq.append(out.action_flat)
                rew_seq.append(result.reward)
                term_seq.append(result.done)
                val_seq.append(out.v)
                logp_seq.append(out.logp)
                states, obs = env.reset_if_terminal(
                    result.state, result.done, generator)
            final_out = module.act(obs, generator, True)
        traj = Trajectory(obs=Observation.stack(obs_seq),
                          next_obs=Observation.stack(next_obs_seq),
                          actions=torch.stack(act_seq),
                          rewards=torch.stack(rew_seq),
                          terminals=torch.stack(term_seq),
                          values=torch.stack(val_seq),
                          logps=torch.stack(logp_seq),
                          bootstrap_value=final_out.v)
        return states, traj

    return rollout
