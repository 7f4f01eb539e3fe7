"""Conservation diagnostics for the validate gates, copied (numpy only)
from ``nbody_tpu/analysis.py`` because the port must run where JAX is not
installed: ``center_of_mass``, ``angular_momentum`` and the scale-relative
momentum / angular-momentum drifts that ``validate`` gates on."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def center_of_mass(pos: np.ndarray, mass: np.ndarray) -> np.ndarray:
    """Mass-weighted mean position, (3,) float64."""
    pos = np.asarray(pos, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    return (mass[:, None] * pos).sum(axis=0) / mass.sum()


def angular_momentum(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
                     center: Optional[np.ndarray] = None) -> np.ndarray:
    """Total angular momentum L = sum_i m_i (r_i - c) x v_i, (3,) float64,
    about the COM by default."""
    pos = np.asarray(pos, dtype=np.float64)
    vel = np.asarray(vel, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    c = center_of_mass(pos, mass) if center is None else np.asarray(center)
    return (mass[:, None] * np.cross(pos - c, vel)).sum(axis=0)


def invariant_drifts(pos: np.ndarray, vel: np.ndarray,
                     mass: np.ndarray) -> Tuple[float, float]:
    """(|P|_max / scale, |L|_max / scale): net momentum and angular
    momentum relative to the sums of their magnitudes, as ``nbody
    validate`` reports them.  Both are conserved exactly by the dynamics
    from the cold start, so they stay at rounding scale."""
    pos = np.asarray(pos, dtype=np.float64)
    vel = np.asarray(vel, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    speed = np.linalg.norm(vel, axis=1)
    p_net = np.abs((mass[:, None] * vel).sum(axis=0)).max()
    p_scale = float((mass * speed).sum()) or 1.0
    l_net = np.abs(angular_momentum(pos, vel, mass)).max()
    com = center_of_mass(pos, mass)
    l_scale = float((mass * np.linalg.norm(pos - com, axis=1)
                     * speed).sum()) or 1.0
    return float(p_net / p_scale), float(l_net / l_scale)
