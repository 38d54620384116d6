"""The solvation and scaffold runs' internal agents at their recorded
configurations, for holding their sampled heads and their rollouts: the
pieces that tests/test_torch_solvation_training.py and
test_torch_scaffold_training.py (against the JAX package) and chip_smoke.py
phase 18 (the card against the CPU) share.

  * `recorded_config` and `family_env`: a family's configuration from its
    record (tools/recorded_run.py) and its training env from its driver's
    builder and `make_reward_fn`;
  * `trained_state`: the weights of a committed JAX archive of the same
    network, the kappa head's output layer multiplied by the family's
    `kappa_scale`. At the trained weights kappa is 0.5 within 0.2 on these
    observations (exactly, by the cube's symmetry, where only the scaffold
    is placed), and a flip of 5% of its draws then moves less probability
    than a test of 10^4 draws sees; scaled, its two candidates are told
    apart. Where kappa is drawn from does not depend on the weights;
  * `StepRecorder`: what each step of a rollout was given and left;
  * `select_observations`: FAMILIES' observations from a rollout;
  * `draw_actions` and `head_distributions`: sampled actions at repeated
    observations, and the distributions each sub-action was drawn from
    (InternalAC.head_distributions), in chunks of at most CHUNK rows.
"""
from __future__ import annotations

import importlib
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from molgym_tpu_torch.agents.internal import HeadDistributions
from molgym_tpu_torch.convert import checkpoint_from_jax
from molgym_tpu_torch.spaces import (Observation, ObservationSpace,
                                     symbols_to_zs)
from molgym_tpu_torch.tools import driver, recorded_run
from molgym_tpu_torch.tools.model_io import read_archive

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CHUNK = 512

# family -> its record (a log JSON, or the experiment UNLOGGED names),
# whether its reward has the solvation penalty, the committed JAX archive
# whose weights the draws are taken at (scaffold's device-LJ record kept
# none: scaffold_pm6's is the same network on the same cube), the factor
# on the kappa head's output layer there, the draws at each observation,
# and the observations: label -> (atoms on the canvas, bag or None for
# any), the first of a rollout's that matches
FAMILIES = {
    'solvation': dict(
        record='experiments/solvation/logs/solv_run-1.json', solvation=True,
        archive='solvation/solv_run-1_steps-7000.npz', kappa_scale=10.0,
        draws_per_observation=4096,
        observations={'the solute alone': (2, (0, 2, 0, 1)),
                      'mid-bag': (3, (0, 1, 0, 1)),
                      'after a refill': (5, (0, 2, 0, 1))}),
    'scaffold': dict(
        record='experiments/scaffold', solvation=False,
        archive='scaffold_pm6/scafpm6_run-1_steps-12288.npz',
        kappa_scale=1e4, draws_per_observation=4096,
        observations={'the cube alone': (8, (0, 2, 1, 0)),
                      'partway through the bag': (9, None)}),
}


def recorded_config(name: str) -> Tuple[str, dict]:
    """(driver module, configuration) of family `name`'s record."""
    module, argv = recorded_run.recorded_argv(
        os.path.join(ROOT, FAMILIES[name]['record']))
    return module, vars(recorded_run.parser_of(module).parse_args(argv))


def family_env(name: str, config: dict, device):
    """The family's training env on `device`, from its driver's builder."""
    module = importlib.import_module(recorded_config(name)[0])
    space = ObservationSpace(config['canvas_size'],
                             symbols_to_zs(config['symbols']))
    reward_fn = driver.make_reward_fn(config,
                                      FAMILIES[name]['solvation'])[0]
    return getattr(module, f'{name}_envs')(config, space, reward_fn,
                                           torch.device(device))[0]


def trained_state(name: str) -> Dict[str, torch.Tensor]:
    """The port's state_dict of FAMILIES' archive, the kappa head's output
    layer times the family's kappa_scale (see the module docstring)."""
    spec = FAMILIES[name]
    state = checkpoint_from_jax(read_archive(os.path.join(
        ROOT, 'molgym_tpu_torch', 'checkpoints', spec['archive'])),
        'internal')['model']
    state['phi_kappa.layers.1.weight'] = (
        state['phi_kappa.layers.1.weight'] * spec['kappa_scale'])
    return state


class StepRecorder:
    """Installed on an env: records what each `step` was given (the
    element, the position), which placements were valid, the state after
    it, and the state after each `reset_if_terminal`."""

    def __init__(self, env):
        self.env = env
        self._step, self._reset = env.step, env.reset_if_terminal
        env.step, env.reset_if_terminal = self.step, self.reset_if_terminal
        self.steps: List[dict] = []

    def step(self, states, element, position):
        valid = self.env.reward_inputs(states, element.long(), position)[1]
        result = self._step(states, element, position)
        self.steps.append(dict(element=element.clone(),
                               position=position.clone(), valid=valid,
                               state=result.state))
        return result

    def reset_if_terminal(self, states, dones, generator=None):
        states, obs = self._reset(states, dones, generator)
        self.steps[-1]['reset'] = states
        return states, obs

    def take(self) -> List[dict]:
        steps, self.steps = self.steps, []
        return steps


def select_observations(name: str, obs: Observation) -> Observation:
    """[K] observations: for each of FAMILIES' labels, in order, the first
    of a rollout's observations [T, B, ...] with its atom count and bag."""
    flat = obs.map(lambda x: x.reshape((-1, ) + x.shape[2:]))
    n_atoms = (flat.elements != 0).sum(-1)
    picked = []
    for label, (atoms, bag) in FAMILIES[name]['observations'].items():
        match = n_atoms == atoms
        if bag is not None:
            match &= (flat.bag == torch.tensor(bag, device=flat.bag.device)
                      ).all(-1)
        rows = torch.nonzero(match)[:, 0]
        if not len(rows):
            raise ValueError(f'{name}: no observation {label} in the rollout')
        picked.append(int(rows[0]))
    index = torch.tensor(picked, device=flat.elements.device)
    return flat.map(lambda x: x[index])


def repeat_rows(observations: Observation,
                per_observation: int) -> Tuple[Observation, np.ndarray]:
    """(rows, ids): each observation repeated per_observation times, and
    the index of each row's observation."""
    ids = np.repeat(np.arange(observations.elements.shape[0]),
                    per_observation)
    index = torch.from_numpy(ids).to(observations.elements.device)
    return observations.map(lambda x: x[index]), ids


def chunks(rows: Observation, size: int = CHUNK):
    for start in range(0, rows.elements.shape[0], size):
        yield rows.map(lambda x: x[start:start + size])


def draw_actions(agent, rows: Observation, generator) -> np.ndarray:
    """[M, 7] actions `agent` samples at `rows` from `generator`, CHUNK
    rows an `act`, on the agent's device."""
    device = next(agent.parameters()).device
    out = []
    with torch.no_grad():
        for chunk in chunks(rows):
            out.append(agent.act(chunk.map(lambda x: x.to(device)),
                                 generator).action_flat.cpu().numpy())
    return np.concatenate(out)


def head_distributions(agent, rows: Observation,
                       actions: np.ndarray) -> HeadDistributions:
    """HeadDistributions (numpy) of `agent` at `actions`, CHUNK rows a
    pass, on the agent's device."""
    device = next(agent.parameters()).device
    parts = []
    with torch.no_grad():
        for i, chunk in enumerate(chunks(rows)):
            a = torch.from_numpy(actions[i * CHUNK:(i + 1) * CHUNK])
            parts.append([x.cpu().numpy() for x in agent.head_distributions(
                chunk.map(lambda x: x.to(device)), a.to(device))])
    return HeadDistributions(*(
        parts[0][i] if name == 'stds' else
        np.concatenate([p[i] for p in parts])
        for i, name in enumerate(HeadDistributions._fields)))
