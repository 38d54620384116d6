"""The random draws of a rank's rows of a global batch.

A data-parallel rank steps envs [lo, hi) of a global batch of `total` envs.
So that W ranks draw what one process draws (the JAX package draws the
global batch from one key and shards the result), every rank seeds the same
generator, makes every draw of the rollout at the global batch's size and
keeps its own rows. `Draws` is that generator with the rank's rows: the
rollout, the env and the policy's samplers take it where they take a
`torch.Generator`, and a plain generator stands for the whole batch (one
process, W = 1), with the same calls and so the same bits.

The batch axis of a draw is not always the first: `batch_dim` names it
(the GMM head's 128 candidates are [128, B, ...], the sphere's grid
[K, B]).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch


class Draws:
    """`generator` drawing for a global batch of `total` rows of which the
    caller keeps [lo, hi); `total` None: the caller's rows are the whole
    batch, and each draw is the plain generator call."""

    def __init__(self, generator: Optional[torch.Generator], lo: int = 0,
                 hi: Optional[int] = None, total: Optional[int] = None):
        if total is not None and not 0 <= lo < hi <= total:
            raise ValueError(f'rows [{lo}, {hi}) of a batch of {total}')
        self.generator = generator
        self.lo, self.hi, self.total = lo, hi, total

    def get_state(self) -> torch.Tensor:
        return self.generator.get_state()

    def set_state(self, state: torch.Tensor) -> None:
        self.generator.set_state(state)

    def rows(self, local: int) -> int:
        """The global batch's row count, for a draw of `local` rows."""
        if self.total is None:
            return local
        if local != self.hi - self.lo:
            raise ValueError(f'a draw of {local} rows where this rank keeps '
                             f'{self.hi - self.lo} of {self.total}')
        return self.total

    def keep(self, x: torch.Tensor, batch_dim: int = 0) -> torch.Tensor:
        """This rank's rows of a global draw `x`."""
        if self.total is None:
            return x
        return x.narrow(batch_dim, self.lo, self.hi - self.lo)

    def _global(self, shape: Sequence[int], batch_dim: int) -> Tuple[int, ...]:
        shape = list(shape)
        shape[batch_dim] = self.rows(shape[batch_dim])
        return tuple(shape)

    def rand(self, shape: Sequence[int], device=None, dtype=None,
             batch_dim: int = 0) -> torch.Tensor:
        """torch.rand of `shape` (the rank's rows along `batch_dim`)."""
        return self.keep(torch.rand(self._global(shape, batch_dim),
                                    generator=self.generator, device=device,
                                    dtype=dtype), batch_dim)

    def randn(self, shape: Sequence[int], device=None, dtype=None,
              batch_dim: int = 0) -> torch.Tensor:
        """torch.randn of `shape` (the rank's rows along `batch_dim`)."""
        return self.keep(torch.randn(self._global(shape, batch_dim),
                                     generator=self.generator, device=device,
                                     dtype=dtype), batch_dim)


Rng = Union[torch.Generator, Draws]


def as_draws(rng: Optional[Rng]) -> Draws:
    """`rng` as Draws: a plain generator draws for the whole batch (None:
    torch's default generator, as torch.rand's generator=None)."""
    return rng if isinstance(rng, Draws) else Draws(rng)

