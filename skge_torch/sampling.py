"""Negative samplers of the port: the shared negative pool.

`SharedNegativeSampler` draws K entities ONCE per step; every positive in
the batch is ranked against every pool entity, for each mode in `modes`
(0 = corrupt the subject, 1 = corrupt the object). Draws are uniform, on
the generator's device. As in the reference's uniform sampler, no
false-negative filtering is applied: a pool entity equal to the true
entity yields a zero-gradient pair.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True, eq=False)
class SharedNegativeSampler:
    n_entities: int
    k: int = 1024
    modes: Tuple[int, ...] = (0, 1)

    def pool(
        self, generator: torch.Generator, pos: torch.Tensor, mask: torch.Tensor
    ) -> torch.Tensor:
        """(k,) int64 entity ids, uniform over [0, n_entities)."""
        return torch.randint(
            0, self.n_entities, (self.k,), generator=generator,
            device=generator.device,
        )
