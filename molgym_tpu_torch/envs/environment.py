"""Molecular-design MDP on batched tensors (counterpart of
molgym_tpu/envs/environment.py).

  * stop element (z == 0)          -> done, reward 0
  * invalid geometry or action     -> done, reward = min_reward
  * reward < min_reward            -> clamp + done, atom placed
  * canvas full or bag empty       -> done (after an optional refill)
  * validity: min pairwise distance, H/F/Cl/Br within max_solo_distance of a
    heavy atom, the element in the bag, a free slot, and (for a scaffold)
    the new atom inside the scaffold's convex hull

The JAX package writes single-env functions and vmaps them; here every
method works on a batch of envs ([B, ...] tensors) directly. The state is a
dataclass of tensors and methods return new states without mutating their
inputs.

Variants are configuration, not subclasses: a formula table with a cycling
cursor, an optional initial structure, a refill budget, and an optional
stochastic bag sampler (`stochastic_size_range`). The JAX state carries a
PRNG key per env; here the sampler draws the bags of all envs of a reset at
once from the `torch.Generator` the caller passes to `reset`,
`reset_if_terminal` and `init_states`, or from a data-parallel rank's
`Draws` (draws.py): then it draws the global batch's bags, runs the parity
loop over all of them, as one process would, and keeps the rank's rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from molgym_tpu_torch.device import DeviceLike, resolve_device
from molgym_tpu_torch.draws import Rng, as_draws
from molgym_tpu_torch.envs.reward import RewardFn
from molgym_tpu_torch.periodic import SOLO_CANDIDATE_ZS, Z_TO_BOND_COUNT
from molgym_tpu_torch.spaces import Observation, ObservationSpace


@dataclasses.dataclass
class EnvState:
    elements: torch.Tensor  # int64[B, N] canvas element indices (0 = empty)
    positions: torch.Tensor  # float32[B, N, 3]
    bag: torch.Tensor  # int64[B, Z]
    n_atoms: torch.Tensor  # int64[B]
    formula_cursor: torch.Tensor  # int64[B] next formula in the cycle
    refill_count: torch.Tensor  # int64[B]

    def observation(self) -> Observation:
        return Observation(elements=self.elements, positions=self.positions,
                           bag=self.bag)

    def where(self, cond: torch.Tensor, other: 'EnvState') -> 'EnvState':
        """Per env: this state where cond[b], else `other`'s."""
        def pick(a, b):
            return torch.where(cond.reshape(cond.shape + (1, ) * (a.dim() - 1)),
                               a, b)
        return EnvState(**{f.name: pick(getattr(self, f.name),
                                        getattr(other, f.name))
                           for f in dataclasses.fields(self)})


@dataclasses.dataclass
class StepResult:
    state: EnvState
    observation: Observation
    reward: torch.Tensor  # float32[B]
    done: torch.Tensor  # bool[B]


class MolecularEnv:
    """Vectorized molecular-design environment; holds only static
    configuration, on `device` (cuda unless the caller names another)."""

    def __init__(
        self,
        reward_fn: RewardFn,
        observation_space: ObservationSpace,
        formulas: np.ndarray,  # int[F, Z] bag table (cycled on reset)
        min_atomic_distance: float = 0.6,
        max_solo_distance: float = 2.0,
        min_reward: float = -0.6,
        initial_elements: Optional[np.ndarray] = None,
        initial_positions: Optional[np.ndarray] = None,
        num_refills: int = 0,
        scaffold_halfspaces: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        n_scaffold: int = 0,
        stochastic_size_range: Optional[Tuple[int, int]] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.observation_space = observation_space
        self.reward_fn = reward_fn
        self.canvas_size = observation_space.canvas_size
        self.num_zs = observation_space.num_zs

        def dev(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        self.zs_array = dev(observation_space.zs, torch.int64)
        self.formulas = dev(formulas, torch.int64)
        if self.formulas.dim() != 2 or self.formulas.shape[1] != self.num_zs:
            raise ValueError(f'formulas must be [F, {self.num_zs}], got '
                             f'{tuple(self.formulas.shape)}')
        self.min_atomic_distance = float(min_atomic_distance)
        self.max_solo_distance = float(max_solo_distance)
        self.min_reward = float(min_reward)
        self.num_refills = int(num_refills)
        self.n_scaffold = int(n_scaffold)

        if initial_elements is None:
            initial_elements = np.zeros(self.canvas_size, dtype=np.int64)
            initial_positions = np.zeros((self.canvas_size, 3), dtype=np.float32)
        self.initial_elements = dev(initial_elements, torch.int64)
        self.initial_positions = dev(initial_positions, torch.float32)
        self.initial_n_atoms = int(np.sum(np.asarray(initial_elements) != 0))

        solo = np.isin(np.array(observation_space.zs), np.array(SOLO_CANDIDATE_ZS))
        self.solo_mask = dev(solo, torch.bool)
        if scaffold_halfspaces is not None:
            self.hull_a = dev(scaffold_halfspaces[0], torch.float32)  # [H, 3]
            self.hull_b = dev(scaffold_halfspaces[1], torch.float32)  # [H]
        else:
            self.hull_a = self.hull_b = None
        self._slots = torch.arange(self.canvas_size, device=self.device)

        self.stochastic_size_range = stochastic_size_range
        if stochastic_size_range is not None:
            # bags are drawn from the base formula's element distribution
            base = np.asarray(formulas, dtype=np.float64)[0]
            self.z_probs = dev(base / max(base.sum(), 1.0), torch.float32)
            self.bond_counts = dev(
                [Z_TO_BOND_COUNT.get(int(z), 0) for z in observation_space.zs],
                torch.int64)

    # -- reset ---------------------------------------------------------------

    def _sample_bags(self, num: int, generator: Optional[Rng]
                     ) -> torch.Tensor:
        """int64[num, Z] bags of lo <= size < hi atoms (hi atoms when
        lo == hi) drawn from z_probs, each with even total valence: a bag of
        odd parity is drawn again, at most 64 times. The loop ends as soon
        as no bag of the batch is odd, which the host reads from the device
        once per round. Under Draws, the batch is the global one."""
        if generator is None:
            raise ValueError('a stochastic-bag environment needs the '
                             'torch.Generator its bags are drawn from')
        draws = as_draws(generator)
        return draws.keep(self.draw_bags(draws.rows(num), draws.generator)[0])

    def draw_bags(self, num: int, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, int]:
        """(bags, redraws): `num` bags of _sample_bags's rule, and the rounds
        of its parity loop that drew again."""
        lo, hi = self.stochastic_size_range
        probs = self.z_probs.expand(num, -1)
        slots = torch.arange(hi, device=self.device)

        def draw():
            size = (torch.randint(lo, hi, (num, ), generator=generator,
                                  device=self.device) if lo < hi
                    else torch.full((num, ), hi, device=self.device))
            draws = torch.multinomial(probs, hi, replacement=True,
                                      generator=generator)
            picked = torch.nn.functional.one_hot(draws, self.num_zs)
            return (picked * (slots < size[:, None])[..., None]).sum(dim=1)

        bags = draw()
        for redraws in range(64):
            odd = (bags * self.bond_counts).sum(dim=-1) % 2 != 0
            if not bool(odd.any()):
                return bags, redraws
            bags = torch.where(odd[:, None], draw(), bags)
        return bags, 64

    def reset(self, states: EnvState,
              generator: Optional[Rng] = None
              ) -> Tuple[EnvState, Observation]:
        """Restore every env's (possibly pre-seeded) canvas and load the next
        bag of its formula cycle, or a bag drawn from `generator` by the
        stochastic sampler."""
        b = states.elements.shape[0]
        cursor = states.formula_cursor % self.formulas.shape[0]
        if self.stochastic_size_range is not None:
            bag = self._sample_bags(b, generator)
        else:
            bag = self.formulas[cursor]
        new_state = EnvState(
            elements=self.initial_elements.expand(b, -1).clone(),
            positions=self.initial_positions.expand(b, -1, -1).clone(),
            bag=bag,
            n_atoms=torch.full((b, ), self.initial_n_atoms, dtype=torch.int64,
                               device=self.device),
            formula_cursor=cursor + 1,
            refill_count=torch.zeros_like(cursor),
        )
        return new_state, new_state.observation()

    def init_states(self, num_envs: int,
                    generator: Optional[Rng] = None) -> EnvState:
        """A reset batch of `num_envs` env states, each at formula 0 (or
        with a bag drawn from `generator`)."""
        zeros = torch.zeros(num_envs, dtype=torch.int64, device=self.device)
        proto = EnvState(
            elements=self.initial_elements.expand(num_envs, -1).clone(),
            positions=self.initial_positions.expand(num_envs, -1, -1).clone(),
            bag=torch.zeros((num_envs, self.num_zs), dtype=torch.int64,
                            device=self.device),
            n_atoms=zeros, formula_cursor=zeros, refill_count=zeros)
        states, _ = self.reset(proto, generator)
        return states

    # -- step ----------------------------------------------------------------

    def _is_valid(self, states: EnvState, new_pos: torch.Tensor,
                  element_index: torch.Tensor) -> torch.Tensor:
        occupied = self._slots[None, :] < states.n_atoms[:, None]
        diff = states.positions - new_pos[:, None, :]
        dist = torch.sqrt((diff * diff).sum(dim=-1).clamp(min=1e-12))
        too_close = (occupied & (dist < self.min_atomic_distance)).any(dim=-1)

        is_candidate = self.solo_mask[element_index]
        heavy = occupied & ~self.solo_mask[states.elements]
        near_heavy = (heavy & (dist < self.max_solo_distance)).any(dim=-1)
        covered = (states.n_atoms == 0) | ~is_candidate | near_heavy

        valid = ~too_close & covered
        in_bag = torch.gather(states.bag, 1, element_index[:, None])[:, 0] > 0
        valid = valid & in_bag & (states.n_atoms < self.canvas_size)
        if self.hull_a is not None:
            inside = ((new_pos @ self.hull_a.T + self.hull_b) <= 1e-6).all(dim=-1)
            valid = valid & inside
        return valid

    def reward_inputs(self, states: EnvState, element_index: torch.Tensor,
                      position: torch.Tensor):
        """Validity and the batched reward-function inputs."""
        stop = self.zs_array[element_index] == 0
        valid = self._is_valid(states, position, element_index)
        needs_reward = ~stop & valid
        zs_atomic = self.zs_array[states.elements] * (
            self._slots[None, :] < states.n_atoms[:, None])
        if self.n_scaffold > 0:
            zs_atomic = zs_atomic * (self._slots[None, :] >= self.n_scaffold)
        new_z = self.zs_array[element_index]
        return stop, valid, needs_reward, zs_atomic, new_z

    def step(self, states: EnvState, element_index: torch.Tensor,
             position: torch.Tensor) -> StepResult:
        """Batched step. element_index: int[B]; position: float32[B, 3]."""
        element_index = element_index.long()
        stop, valid, needs_reward, zs_atomic, new_z = self.reward_inputs(
            states, element_index, position)
        raw_reward = self.reward_fn(states.positions, zs_atomic, position,
                                    new_z, needs_reward)
        return self.finalize_step(states, element_index, position, stop,
                                  valid, raw_reward)

    def finalize_step(self, states: EnvState, element_index: torch.Tensor,
                      position: torch.Tensor, stop: torch.Tensor,
                      valid: torch.Tensor, raw_reward: torch.Tensor) -> StepResult:
        """State update given validity and raw rewards."""
        low = raw_reward < self.min_reward
        reward = torch.where(
            stop, torch.zeros_like(raw_reward),
            torch.where(valid, raw_reward.clamp(min=self.min_reward),
                        torch.full_like(raw_reward, self.min_reward))).float()

        place = valid & ~stop
        slot = states.n_atoms.clamp(0, self.canvas_size - 1)
        at_slot = place[:, None] & (self._slots[None, :] == slot[:, None])
        elements = torch.where(at_slot, element_index[:, None], states.elements)
        positions = torch.where(at_slot[..., None], position[:, None, :],
                                states.positions)
        taken = torch.nn.functional.one_hot(element_index, self.num_zs)
        bag = states.bag - place[:, None].long() * taken
        n_atoms = states.n_atoms + place.long()

        canvas_full = n_atoms >= self.canvas_size
        bag_empty = bag.sum(dim=-1) == 0
        refill = bag_empty & (states.refill_count < self.num_refills) & ~canvas_full
        cursor = states.formula_cursor % self.formulas.shape[0]
        bag = torch.where(refill[:, None], self.formulas[cursor], bag)
        formula_cursor = states.formula_cursor + refill.long()
        refill_count = states.refill_count + refill.long()
        bag_empty = bag.sum(dim=-1) == 0

        done = stop | ~valid | (place & low) | canvas_full | bag_empty
        new_states = EnvState(elements=elements, positions=positions, bag=bag,
                              n_atoms=n_atoms, formula_cursor=formula_cursor,
                              refill_count=refill_count)
        return StepResult(state=new_states,
                          observation=new_states.observation(),
                          reward=reward, done=done)

    def reset_if_terminal(self, states: EnvState, dones: torch.Tensor,
                          generator: Optional[Rng] = None
                          ) -> Tuple[EnvState, Observation]:
        """Auto-reset finished envs."""
        reset_states, _ = self.reset(states, generator)
        new_states = reset_states.where(dones, states)
        return new_states, new_states.observation()


def scaffold_halfspaces(scaffold_positions: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Convex-hull halfspaces A, b with {x : A x + b <= 0} the hull interior,
    computed once on the host when the env is built."""
    from scipy.spatial import ConvexHull
    eq = ConvexHull(np.asarray(scaffold_positions, dtype=np.float64)).equations
    return eq[:, :3].astype(np.float32), eq[:, 3].astype(np.float32)
