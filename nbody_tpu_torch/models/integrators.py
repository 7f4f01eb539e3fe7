"""Integration schemes, as in ``nbody_tpu/models/integrators.py``.

``reference``: the fused half-kick + drift of the reference
(``v += 0.5 dt a; x += dt v``), which applies only half the acceleration
per step and is kept because it is the validation oracle's contract.
``kdk`` / ``yoshida4``: kick-drift-kick sub-steps of weight ``w * dt``
chained through the force evaluation at the step layer.
"""

from __future__ import annotations

from typing import Tuple

import torch

_CBRT2 = 2.0 ** (1.0 / 3.0)
YOSHIDA4_W1 = 1.0 / (2.0 - _CBRT2)
YOSHIDA4_W0 = 1.0 - 2.0 * YOSHIDA4_W1
YOSHIDA4_WEIGHTS = (YOSHIDA4_W1, YOSHIDA4_W0, YOSHIDA4_W1)

KDK_WEIGHTS = {"kdk": (1.0,), "yoshida4": YOSHIDA4_WEIGHTS}


def reference_update(pos: torch.Tensor, vel: torch.Tensor, acc: torch.Tensor,
                     dt: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused half-kick + drift."""
    vel = vel + 0.5 * dt * acc
    pos = pos + dt * vel
    return pos, vel


def kdk_kick(vel: torch.Tensor, acc: torch.Tensor, dt: float) -> torch.Tensor:
    """Half kick of kick-drift-kick leapfrog."""
    return vel + 0.5 * dt * acc


def kdk_drift(pos: torch.Tensor, vel: torch.Tensor, dt: float) -> torch.Tensor:
    """Full drift of kick-drift-kick leapfrog."""
    return pos + dt * vel
