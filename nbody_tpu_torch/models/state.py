"""Simulation state: ``(N, 3)`` positions, velocities and accelerations
beside an ``(N,)`` mass vector, the layout of ``nbody_tpu/models/state.py``.

Padding uses zero-mass ghost bodies at the origin: a ghost adds exactly
zero force, so the kernels need no mask in the hot loop.  The JAX
package's ``FlatState`` is a TPU tiled-copy workaround and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SimState(NamedTuple):
    """State of an N-body system; every tensor has leading dimension N."""

    pos: torch.Tensor   # (N, 3) positions
    vel: torch.Tensor   # (N, 3) velocities
    acc: torch.Tensor   # (N, 3) accelerations from the last step
    mass: torch.Tensor  # (N,)  masses (0 for padding ghosts)

    @property
    def n(self) -> int:
        return self.pos.shape[0]


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_state_to(state: SimState, n_pad: int) -> SimState:
    """Pad with zero-mass ghost bodies up to exactly ``n_pad`` bodies."""
    n = state.n
    if n_pad == n:
        return state
    if n_pad < n:
        raise ValueError(f"cannot pad {n} bodies down to {n_pad}")
    pad3 = state.pos.new_zeros(n_pad - n, 3)
    return SimState(
        pos=torch.cat([state.pos, pad3]),
        vel=torch.cat([state.vel, pad3]),
        acc=torch.cat([state.acc, pad3]),
        mass=torch.cat([state.mass, state.mass.new_zeros(n_pad - n)]),
    )


def unpad_state(state: SimState, n_real: int) -> SimState:
    if state.n == n_real:
        return state
    return SimState(pos=state.pos[:n_real], vel=state.vel[:n_real],
                    acc=state.acc[:n_real], mass=state.mass[:n_real])


def state_to_numpy(state: SimState) -> "dict[str, np.ndarray]":
    """Host copies under the JAX package's keys (pos/vel/acc/mass)."""
    return {k: getattr(state, k).detach().cpu().numpy()
            for k in ("pos", "vel", "acc", "mass")}


def state_from_numpy(arrays, dtype: torch.dtype = torch.float32,
                     device="cuda") -> SimState:
    """A state from arrays under the keys pos/vel/acc/mass, such as
    ``nbody_tpu.models.state.state_to_numpy`` returns.  The tensors are
    copies: the state never aliases the caller's arrays."""
    return SimState(*(torch.tensor(np.asarray(arrays[k]), dtype=dtype,
                                   device=device)
                      for k in ("pos", "vel", "acc", "mass")))
