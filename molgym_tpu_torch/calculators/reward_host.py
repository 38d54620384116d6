"""Host rewards (counterpart of molgym_tpu/calculators/reward_host.py): a
batched host evaluator (NativeBatchCalculator, SparrowBatchCalculator) as a
device RewardFn, its timer, and the object API of the reference's reward
classes.

Where the JAX package calls the host from inside its jitted scan through
`io_callback`, the port's reward function copies its inputs to the host
itself: every input of a step leaves the device in one copy (one
synchronisation), the evaluator runs in float64, the distance penalty is
applied, and the rewards come back rounded to float32 once.
"""
from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from molgym_tpu_torch.atoms import Atom, Atoms
from molgym_tpu_torch.envs.reward import (RewardFn,
                                          get_minimum_spin_multiplicity)


def inputs_to_host(positions: torch.Tensor, zs: torch.Tensor,
                   new_pos: torch.Tensor, new_z: torch.Tensor,
                   valid: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """The reward-function inputs as numpy arrays (zs int32[B, N], positions
    float64[B, N, 3], n_atoms int32[B], new_z int32[B], new_pos float64[B,
    3], valid uint8[B]), moved to the host in one copy. float32 positions
    and small integers are exact in float64."""
    b, n = zs.shape
    packed = torch.cat([positions.reshape(b, 3 * n).double(), zs.double(),
                        new_pos.double(), new_z[:, None].double(),
                        valid[:, None].double()], dim=1).cpu().numpy()
    pos = packed[:, :3 * n].reshape(b, n, 3)
    zs_np = packed[:, 3 * n:4 * n].astype(np.int32)
    new_pos_np = packed[:, 4 * n:4 * n + 3]
    new_z_np = packed[:, 4 * n + 3].astype(np.int32)
    valid_np = packed[:, 4 * n + 4].astype(np.uint8)
    n_atoms = (zs_np > 0).sum(axis=-1).astype(np.int32)
    return zs_np, pos, n_atoms, new_z_np, new_pos_np, valid_np


def host_rewards(batch_calculator, distance_penalty: float, zs, positions,
                 n_atoms, new_z, new_pos, valid) -> np.ndarray:
    """float64[B] rewards of host inputs, less distance_penalty * |new_pos|
    where valid."""
    rewards = batch_calculator.batch_reward(zs, positions, n_atoms, new_z,
                                            new_pos, valid)
    if distance_penalty:
        dist = np.linalg.norm(new_pos, axis=-1)
        rewards = rewards - distance_penalty * dist * valid
    return rewards


def make_host_reward(batch_calculator, distance_penalty: float = 0.0) -> RewardFn:
    """A batched host evaluator as a RewardFn with the device-reward
    contract (envs/reward.py): positions[B,N,3], zs[B,N] atomic numbers,
    new_pos[B,3], new_z[B], valid[B] -> float32[B] on the inputs' device."""

    def reward_fn(positions, zs, new_pos, new_z, valid):
        host = inputs_to_host(positions, zs, new_pos, new_z, valid)
        rewards = host_rewards(batch_calculator, distance_penalty, *host)
        return torch.from_numpy(rewards.astype(np.float32)).to(positions.device)

    return reward_fn


class TimedBatchCalculator:
    """Wraps a batch calculator, adding up the wall time and count of its
    batch_reward calls (the `reward_time` of the train info)."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.total_time = 0.0
        self.total_calls = 0

    def batch_reward(self, *args, **kwargs):
        start = time.perf_counter()
        result = self.inner.batch_reward(*args, **kwargs)
        self.total_time += time.perf_counter() - start
        self.total_calls += 1
        return result

    def pool_stats(self):
        return self.inner.pool_stats()


# -- object API (the reference's molgym/reward.py) ----------------------------

class MolecularReward:
    def calculate(self, atoms: Atoms, new_atom: Atom) -> Tuple[float, dict]:
        raise NotImplementedError

    @staticmethod
    def get_minimum_spin_multiplicity(atoms: Atoms) -> int:
        return get_minimum_spin_multiplicity(a.z for a in atoms)


class InteractionReward(MolecularReward):
    """r = -(E(atoms + new) - E(atoms) - E(new alone)). backend 'sparrow'
    is PM6 through scine (when installed); 'lj', 'morse', 'eht' and 'pm6'
    are the native library's."""

    def __init__(self, backend: str = 'sparrow', method: str = 'PM6') -> None:
        self.backend = backend
        if backend == 'sparrow':
            from molgym_tpu_torch.calculators.sparrow import (
                SPARROW_AVAILABLE, SparrowBatchCalculator)
            if not SPARROW_AVAILABLE:
                raise RuntimeError(
                    "backend='sparrow' requires scine_sparrow; use 'pm6', "
                    "'eht', 'lj' or 'morse' on hosts without it")
            self._batch = SparrowBatchCalculator(method=method)
        else:
            from molgym_tpu_torch.calculators.native import (
                METHODS, NativeBatchCalculator)
            self._batch = NativeBatchCalculator(method=METHODS[backend])

    @property
    def batch_calculator(self):
        return self._batch

    def calculate(self, atoms: Atoms, new_atom: Atom) -> Tuple[float, dict]:
        start = time.time()
        n = len(atoms)
        zs = np.zeros((1, max(n, 1)), dtype=np.int32)
        positions = np.zeros((1, max(n, 1), 3), dtype=np.float64)
        if n:
            zs[0, :n] = atoms.numbers
            positions[0, :n] = atoms.positions
        reward = self._batch.batch_reward(
            zs, positions, np.array([n], np.int32),
            np.array([new_atom.z], np.int32),
            new_atom.position.reshape(1, 3), np.array([1], np.uint8))
        return float(reward[0]), {'elapsed_time': time.time() - start}


class SolvationReward(InteractionReward):
    """The interaction reward less distance_penalty * |new atom's
    position|."""

    def __init__(self, distance_penalty: float = 0.01, **kwargs) -> None:
        super().__init__(**kwargs)
        self.distance_penalty = distance_penalty

    def calculate(self, atoms: Atoms, new_atom: Atom) -> Tuple[float, dict]:
        reward, info = super().calculate(atoms, new_atom)
        reward -= self.distance_penalty * float(np.linalg.norm(new_atom.position))
        return reward, info
