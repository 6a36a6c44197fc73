"""The (dp, mp) layout of ranks: reads over dp, references over mp.

Ported from quaff_tpu/parallel/mesh.py, with ranks in place of devices:
one rank a device (parallel/distributed.py).  The defaults and checks are
the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class RankMesh:
    """ranks[i, j] is the rank at dp index i and mp index j."""

    ranks: np.ndarray

    @property
    def shape(self) -> dict:
        return {"dp": self.ranks.shape[0], "mp": self.ranks.shape[1]}


def make_mesh(n_ranks: Optional[int] = None, mp: Optional[int] = None
              ) -> RankMesh:
    """A (dp, mp) grid over ranks 0..n_ranks-1 (the world by default).

    mp defaults to the largest power-of-two divisor of n_ranks capped at 2
    (references are usually few; reads are many)."""
    if n_ranks is None:
        from .distributed import world

        n_ranks = world()[1]
    if mp is None:
        mp = 2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1
    dp = n_ranks // mp
    if dp * mp != n_ranks:
        raise ValueError(f"mesh {dp}x{mp} != {n_ranks} devices")
    return RankMesh(np.arange(n_ranks).reshape(dp, mp))
