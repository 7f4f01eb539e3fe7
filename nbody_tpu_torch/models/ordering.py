"""Spatial (Morton / Z-order) body reordering, as in
``nbody_tpu/models/ordering.py``.

With bodies sorted so that index-adjacent bodies are space-adjacent, a
j-tile of the force sweep is spatially compact; the centred distances of
``pallas_fast`` (K12, ``ops/forces_fast.py``) need that for their
accuracy.  A sort is a pure permutation of body identity: gravity is
permutation-equivariant, so trajectories are unchanged up to relabelling.

Codes are 30-bit Morton codes (10 bits an axis), computed in plain torch
on the state's device.  PyTorch has no full ``uint32`` shift / or
arithmetic, so the bits are spread in ``int64`` (the 30-bit codes fit);
the quantisation rounds in float32 exactly as the JAX package does, and
the sort is stable, as ``jnp.argsort`` is, so tied codes keep their index
order and the permutation equals the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .state import SimState


def _spread_bits_10(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so that two zero bits sit between each
    (int64 in and out)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_codes(pos: torch.Tensor, lower: float, upper: float,
                 bits: int = 10) -> torch.Tensor:
    """30-bit Morton codes (int64) for (N,3) float32 positions within
    [lower, upper]^3.  Out-of-box positions clamp to the boundary cells."""
    if bits != 10:
        raise NotImplementedError("only 10 bits/axis supported")
    top = 2 ** bits - 1
    # The JAX package's weakly typed scalars round to float32 first.
    lo = float(np.float32(lower))
    scale = float(np.float32(top / (upper - lower)))
    q = torch.clamp((pos - lo) * scale, 0, top).to(torch.int64)
    sx = _spread_bits_10(q[:, 0])
    sy = _spread_bits_10(q[:, 1])
    sz = _spread_bits_10(q[:, 2])
    return sx | (sy << 1) | (sz << 2)


def morton_permutation(pos: torch.Tensor, lower: float,
                       upper: float) -> torch.Tensor:
    """Permutation (int64) that sorts bodies in Z-order, ties in index
    order."""
    return torch.argsort(morton_codes(pos, lower, upper), stable=True)


def apply_permutation(state: SimState, perm: torch.Tensor) -> SimState:
    return SimState(pos=state.pos[perm], vel=state.vel[perm],
                    acc=state.acc[perm], mass=state.mass[perm])


def morton_sort_state(state: SimState, lower: float, upper: float
                      ) -> Tuple[SimState, torch.Tensor]:
    """Z-order-sort a state.  Returns (sorted_state, perm) where
    ``sorted.pos[i] == pos[perm[i]]`` (perm maps new index -> old index)."""
    perm = morton_permutation(state.pos, lower, upper)
    return apply_permutation(state, perm), perm
