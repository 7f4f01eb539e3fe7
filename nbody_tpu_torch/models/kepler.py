"""Closed-form two-body (Kepler) gates, as in ``nbody_tpu/models/kepler.py``.

A differential gate (kernel against its plain version, against the JAX
package, against the float64 oracle) cannot catch an error that both sides
share: all of them compute the same force contract

    a_i = sum_j m_j * r_ij / (|r_ij|^2 + eps2)^{3/2}

(no G).  These gates compare the port's step path with exact solutions of
the two-body problem under that contract instead.

**Circular orbits (any eps2).**  Two bodies at separation ``d`` stay on
exact circles about their barycentre with ``w^2 = M_eff / (d^2 +
eps2)^{3/2}``.  The reference scheme (``v += 0.5 dt a; x += dt v``) applies
half the acceleration a step, so its continuum limit is half-force
dynamics: ``integrator="reference"`` takes ``M_eff = M/2`` and the KDK
schemes ``M_eff = M``.

**Elliptic orbits (eps2 = 0).**  Kepler propagation from the eccentric
anomaly (Newton on ``M = E - e sin E``); the bodies sit at ``-/+ m_other /
M`` times the relative vector.

The closed forms are float64 numpy on the host; the two-body states are
``SimState``s on ``device`` in the dtype asked for.  ``run_analytic_gates``
runs the five gates through the port's ``prime_kdk`` / ``run_steps``, one
period each; ``gate_cases`` gives the same states, steps, closed forms and
tolerances to a caller that runs the steps some other way.
"""

from __future__ import annotations

import math
from typing import Iterator, NamedTuple, Tuple

import numpy as np
import torch

from ..config import _DTYPES
from ..utils.device import require_device
from .state import SimState, host_array


def circular_omega(d: float, m_total: float, eps2: float,
                   integrator: str = "kdk") -> float:
    """Angular velocity of the exact circular two-body orbit under the
    force contract; half-force dynamics for ``"reference"``."""
    m_eff = m_total * (0.5 if integrator == "reference" else 1.0)
    return math.sqrt(m_eff / (d * d + eps2) ** 1.5)


def _two_body(pos, vel, m1, m2, dtype, device) -> SimState:
    dt_, device = _DTYPES[dtype], require_device(device)
    return SimState(
        pos=torch.tensor(pos, dtype=dt_, device=device),
        vel=torch.tensor(vel, dtype=dt_, device=device),
        acc=torch.zeros((2, 3), dtype=dt_, device=device),
        mass=torch.tensor([m1, m2], dtype=dt_, device=device))


def two_body_circular(d: float = 1.0, m1: float = 1.0, m2: float = 0.5,
                      eps2: float = 0.0, integrator: str = "kdk",
                      dtype: str = "float32",
                      device="cuda") -> Tuple[SimState, float]:
    """Exact circular-orbit initial state: body 0 at ``-r1 = -d m2/M`` and
    body 1 at ``r2 = d m1/M`` on the x axis, velocities along -/+y for
    ``w = circular_omega(...)``.  Returns (state, w)."""
    m = m1 + m2
    w = circular_omega(d, m, eps2, integrator)
    r1, r2 = d * m2 / m, d * m1 / m
    return _two_body([[-r1, 0.0, 0.0], [r2, 0.0, 0.0]],
                     [[0.0, -w * r1, 0.0], [0.0, w * r2, 0.0]],
                     m1, m2, dtype, device), w


def circular_positions(t: float, d: float = 1.0, m1: float = 1.0,
                       m2: float = 0.5, eps2: float = 0.0,
                       integrator: str = "kdk") -> np.ndarray:
    """Exact (2, 3) float64 positions of the circular orbit at time t."""
    m = m1 + m2
    w = circular_omega(d, m, eps2, integrator)
    r1, r2 = d * m2 / m, d * m1 / m
    c, s = math.cos(w * t), math.sin(w * t)
    return np.array([[-r1 * c, -r1 * s, 0.0],
                     [r2 * c, r2 * s, 0.0]], dtype=np.float64)


def solve_kepler(m_anom: np.ndarray, e: float,
                 tol: float = 1e-14, max_iter: int = 64) -> np.ndarray:
    """Eccentric anomaly E from the mean anomaly by Newton on
    ``E - e sin E - M = 0`` (float64, vectorized)."""
    m_anom = np.asarray(m_anom, dtype=np.float64)
    ecc = np.where(e > 0.8, np.pi * np.ones_like(m_anom), m_anom)
    for _ in range(max_iter):
        f = ecc - e * np.sin(ecc) - m_anom
        ecc_next = ecc - f / (1.0 - e * np.cos(ecc))
        if np.max(np.abs(ecc_next - ecc)) < tol:
            return ecc_next
        ecc = ecc_next
    return ecc


def two_body_elliptic(a: float = 1.0, e: float = 0.5, m1: float = 1.0,
                      m2: float = 0.5, dtype: str = "float32",
                      device="cuda") -> Tuple[SimState, float]:
    """Exact elliptic-orbit initial state at perihelion (for eps2 = 0):
    separation ``a (1 - e)``, relative speed ``sqrt(M (1 + e) / (a (1 -
    e)))``, split barycentrically so the total momentum is zero.  Returns
    (state, period)."""
    m = m1 + m2
    rp = a * (1.0 - e)
    vp = math.sqrt(m * (1.0 + e) / rp)
    period = 2.0 * math.pi * math.sqrt(a ** 3 / m)
    return _two_body([[-rp * m2 / m, 0.0, 0.0], [rp * m1 / m, 0.0, 0.0]],
                     [[0.0, -vp * m2 / m, 0.0], [0.0, vp * m1 / m, 0.0]],
                     m1, m2, dtype, device), period


def elliptic_positions(t: float, a: float = 1.0, e: float = 0.5,
                       m1: float = 1.0, m2: float = 0.5) -> np.ndarray:
    """Exact (2, 3) float64 positions of the elliptic orbit at time t
    (perihelion at t = 0, eps2 = 0)."""
    m = m1 + m2
    n = math.sqrt(m / a ** 3)
    ecc = float(solve_kepler(np.asarray(n * t), e))
    rx = a * (math.cos(ecc) - e)
    ry = a * math.sqrt(1.0 - e * e) * math.sin(ecc)
    rel = np.array([rx, ry, 0.0], dtype=np.float64)
    return np.stack([-rel * m2 / m, rel * m1 / m])


def max_rel_error(pos, ref: np.ndarray, scale: float) -> float:
    """max_i |pos_i - ref_i| / scale: the position error relative to the
    orbit's size.  ``pos`` is a tensor or an array."""
    if isinstance(pos, torch.Tensor):
        pos = host_array(pos)
    err = np.linalg.norm(np.asarray(pos, dtype=np.float64) - ref, axis=1)
    return float(err.max() / scale)


class GateCase(NamedTuple):
    """One closed-form gate: run ``state`` (``prime_kdk`` first unless the
    integrator is ``reference``) for ``steps`` steps of ``dt`` at ``eps2``,
    then hold its positions to ``ref`` within ``tol`` of the scale 1."""

    gate: str
    integrator: str
    dt: float
    eps2: float
    steps: int
    state: SimState
    ref: np.ndarray
    tol: float


def gate_cases(dtype: str = "float32", steps_per_period: int = 2048,
               device="cuda") -> Iterator[GateCase]:
    """The five gates of ``run_analytic_gates``, in its order:

      1. circular, ``reference`` (the half-force closed form)
      2. circular, ``kdk``
      3. circular, ``yoshida4``
      4. elliptic e = 0.6, ``kdk``
      5. elliptic e = 0.6, ``yoshida4``

    Each tolerance is ``C (w dt)^order + noise``, with the JAX package's
    constants (about 8x over the measured float64 errors) and a noise
    term of 5e-5 in float32, 1e-12 otherwise."""
    d_scale, m1, m2, e = 1.0, 1.0, 0.5, 0.6
    noise = 5e-5 if dtype == "float32" else 1e-12
    # Circular, softened (eps2 > 0 exercises the softening term).
    eps2 = 0.01
    for integrator, order, c in (("reference", 1, 0.25), ("kdk", 2, 8.0),
                                 ("yoshida4", 4, 32.0)):
        state, w = two_body_circular(d_scale, m1, m2, eps2, integrator,
                                     dtype, device)
        period = 2.0 * math.pi / w
        dt = period / steps_per_period
        yield GateCase(
            f"circular/{integrator}", integrator, dt, eps2,
            steps_per_period, state,
            circular_positions(period, d_scale, m1, m2, eps2, integrator),
            c * (w * dt) ** order + noise)
    # Elliptic, near-unsoftened: the kernels need eps2 > 0 for the self
    # pair (0 * rsqrt(0) is NaN), and eps2 = 1e-10 perturbs the force by
    # ~6e-10 relative, far below the discretization error.  Perihelion
    # concentrates the error: C_kdk = 600, C_yoshida4 = 1e4.
    for integrator, order, c in (("kdk", 2, 600.0), ("yoshida4", 4, 1e4)):
        state, period = two_body_elliptic(d_scale, e, m1, m2, dtype, device)
        yield GateCase(
            f"elliptic(e=0.6)/{integrator}", integrator,
            period / steps_per_period, 1e-10, steps_per_period, state,
            elliptic_positions(period, d_scale, e, m1, m2),
            c * (2.0 * math.pi / steps_per_period) ** order + noise)


def split_pair(state: SimState, at: int = 256,
               filler=(0.0, 0.0, 50.0)) -> SimState:
    """The two-body ``state`` with body 1 moved to index ``at`` and
    ``at - 1`` massless bodies at rest at ``filler`` between the two.  The
    massless bodies pull on nothing, so bodies 0 and ``at`` follow the
    same closed form; with ``at`` a superblock width they sit in two
    superblocks, and a pair-symmetric kernel computes their pair on its
    pair tile instead of the diagonal tile."""
    pos, vel, acc, mass = state
    fill = pos.new_tensor(filler).expand(at - 1, 3)
    zeros = pos.new_zeros(at - 1, 3)
    return SimState(pos=torch.cat([pos[:1], fill, pos[1:]]),
                    vel=torch.cat([vel[:1], zeros, vel[1:]]),
                    acc=torch.cat([acc[:1], zeros, acc[1:]]),
                    mass=torch.cat([mass[:1], mass.new_zeros(at - 1),
                                    mass[1:]]))


def gate_result(case: GateCase, pos) -> dict:
    """The result line of ``case`` for the two bodies' end positions."""
    err = max_rel_error(pos, case.ref, 1.0)
    return {"gate": case.gate, "steps": case.steps, "max_rel_err": err,
            "tol": case.tol, "ok": err <= case.tol}


def run_analytic_gates(impl: str = "auto", dtype: str = "float32",
                       steps_per_period: int = 2048,
                       block_i: "int | None" = None,
                       block_u: "int | None" = None,
                       device="cuda") -> "list[dict]":
    """Run the five closed-form gates (``gate_cases``) through the step
    path (``prime_kdk``, ``run_steps``) with ``impl``, one period each.

    Returns one dict a gate: ``gate``, ``steps``, ``max_rel_err`` (the
    largest position error relative to the orbit's scale), ``tol`` and
    ``ok``.  ``block_i`` / ``block_u`` are passed to the config as in the
    JAX package; the CUDA kernels use their fixed tiles."""
    from ..config import SimConfig
    from ..ops.step import prime_kdk, run_steps

    kw = {}
    if block_i:
        kw["block_i"] = block_i
    if block_u:
        kw["block_u"] = block_u
    results = []
    for case in gate_cases(dtype, steps_per_period, device):
        cfg = SimConfig(n_bodies=2, dt=case.dt, eps2=case.eps2, impl=impl,
                        dtype=dtype, integrator=case.integrator,
                        device=str(device), **kw)
        state = case.state
        if case.integrator != "reference":
            state = prime_kdk(state, cfg)
        out = run_steps(state, cfg, case.steps)
        results.append(gate_result(case, out.pos))
    return results
