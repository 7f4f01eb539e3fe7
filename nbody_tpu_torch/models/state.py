"""Simulation state: ``(N, 3)`` positions, velocities and accelerations
beside an ``(N,)`` mass vector, the layout of ``nbody_tpu/models/state.py``.

Padding uses zero-mass ghost bodies at the origin: a ghost adds exactly
zero force, so the kernels need no mask in the hot loop.

``FlatState`` is the JAX package's row-major ``(3N,)`` layout of the same
state.  There it keeps huge-N state out of the TPU's tiled ``(N, 3)``
copies; here a contiguous ``(N, 3)`` tensor and its ``(3N,)`` form share
their memory, so ``flat_from_state`` and ``state_from_flat`` are views
(no copy, no host round trip) and every flat entry point runs the
``(N, 3)`` path on ``.view(-1, 3)``: flat equals regular bit for bit.
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


class FlatState(NamedTuple):
    """The state in flat row-major layout: ``pos``, ``vel`` and ``acc`` are
    ``(3N,)`` (``[x0, y0, z0, x1, ...]``), ``mass`` is ``(N,)``."""

    pos: torch.Tensor
    vel: torch.Tensor
    acc: torch.Tensor
    mass: torch.Tensor

    @property
    def n(self) -> int:
        return self.mass.shape[0]


def is_flat(state) -> bool:
    """True when ``state`` has the flat ``(3N,)`` coordinate layout."""
    return state.pos.ndim == 1


def flat_from_state(state: SimState) -> FlatState:
    """SimState -> FlatState: ``(3N,)`` views of the contiguous ``(N, 3)``
    tensors (a copy only for a non-contiguous one)."""
    return FlatState(pos=state.pos.reshape(-1), vel=state.vel.reshape(-1),
                     acc=state.acc.reshape(-1), mass=state.mass)


def state_from_flat(flat: FlatState) -> SimState:
    """FlatState -> SimState: ``(N, 3)`` views of the ``(3N,)`` tensors
    (or host arrays)."""
    return SimState(pos=flat.pos.reshape(-1, 3), vel=flat.vel.reshape(-1, 3),
                    acc=flat.acc.reshape(-1, 3), mass=flat.mass)


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_state(state: SimState, multiple: int) -> SimState:
    """Pad with zero-mass ghost bodies so N is a multiple of ``multiple``."""
    return pad_state_to(state, round_up(state.n, multiple))


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


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy for numpy arithmetic: bfloat16, which numpy lacks,
    upcast to float32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def state_to_numpy(state: SimState) -> "dict[str, np.ndarray]":
    """Host copies under the JAX package's keys (pos/vel/acc/mass); a
    bfloat16 state comes back as float32."""
    return {k: host_array(getattr(state, k))
            for k in ("pos", "vel", "acc", "mass")}


def state_from_numpy(arrays, dtype: torch.dtype = torch.float32,
                     device="cuda") -> SimState:
    """A state from arrays under the keys pos/vel/acc/mass, such as
    ``nbody_tpu.models.state.state_to_numpy`` returns.  The tensors are
    copies: the state never aliases the caller's arrays."""
    return SimState(*(torch.tensor(np.asarray(arrays[k]), dtype=dtype,
                                   device=device)
                      for k in ("pos", "vel", "acc", "mass")))
