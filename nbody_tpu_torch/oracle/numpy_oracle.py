"""CPU validation oracle — NumPy reimplementation of ``validation.cpp``.

The reference's differential-testing oracle is an OpenMP all-pairs CPU step
with an ``i != j`` guard plus the same fused integration
(``CPU_compute``, ``validation.cpp:28-52``), compared after 1,000 lock-step
steps at 1% relative tolerance per component with min-magnitude scaling
(``verify_still_bodies``, ``validation.cpp:143-163``).

This module is the structurally independent twin: plain NumPy, float64-capable
(float64 is the default so the oracle is *more* accurate than both device
paths), vectorized over i but algorithmically identical.

This file is a copy of ``nbody_tpu/oracle/numpy_oracle.py``: the port must
run where JAX is not installed, and importing anything under ``nbody_tpu``
imports JAX.  ``tests/test_torch_slice.py`` holds the copy equal to the
original.  The native C++/OpenMP oracle is not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def oracle_forces(pos: np.ndarray, mass: np.ndarray, eps2: float,
                  dtype=np.float64) -> np.ndarray:
    """All-pairs softened accelerations with explicit i != j guard
    (validation.cpp:29-36)."""
    pos = np.asarray(pos, dtype=dtype)
    mass = np.asarray(mass, dtype=dtype)
    n = pos.shape[0]
    acc = np.zeros((n, 3), dtype=dtype)
    # Vectorized over j for each i, chunked to bound memory.
    chunk = max(1, min(n, 8 * 1024 * 1024 // max(n, 1)))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        r = pos[None, :, :] - pos[s:e, None, :]       # (C, N, 3)
        d2 = np.sum(r * r, axis=-1) + eps2
        f = mass[None, :] / np.sqrt(d2 * d2 * d2)     # (C, N)
        # i != j guard (validation.cpp:34): zero the diagonal slice.
        idx = np.arange(s, e)
        f[idx - s, idx] = 0.0
        acc[s:e] = np.einsum("cn,cnd->cd", f, r)
    return acc


def oracle_step(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
                eps2: float, dt: float,
                dtype=np.float64) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One CPU_compute step (validation.cpp:28-52): forces, then
    v += 0.5*dt*a; x += dt*v. Returns (pos, vel, acc)."""
    pos = np.asarray(pos, dtype=dtype).copy()
    vel = np.asarray(vel, dtype=dtype).copy()
    acc = oracle_forces(pos, mass, eps2, dtype=dtype)
    vel += 0.5 * dt * acc
    pos += dt * vel
    return pos, vel, acc


def oracle_run(pos, vel, mass, eps2: float, dt: float, steps: int,
               dtype=np.float64, integrator: str = "reference"):
    """Lock-step multi-step oracle run (the CPU side of compareHostToDevice,
    validation.cpp:65-75).

    ``integrator``: "reference" is the reference's fused half-kick + drift;
    "kdk" mirrors ops.step's kick-drift-kick leapfrog (same scheme, CPU
    twin) so KDK device runs can be differentially validated too;
    "yoshida4" is the 4th-order Yoshida composition of three KDK sub-steps
    (weights re-derived here independently of models/integrators.py, in the
    independent-twin spirit of validation.cpp)."""
    pos = np.asarray(pos, dtype=dtype).copy()
    vel = np.asarray(vel, dtype=dtype).copy()
    if integrator in ("kdk", "yoshida4"):
        if integrator == "kdk":
            weights = (1.0,)
        else:
            w1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))   # Yoshida 1990
            weights = (w1, 1.0 - 2.0 * w1, w1)
        acc = oracle_forces(pos, mass, eps2, dtype=dtype)
        for _ in range(steps):
            for w in weights:
                vel = vel + 0.5 * w * dt * acc      # half kick with a(x)
                pos = pos + w * dt * vel            # drift
                acc = oracle_forces(pos, mass, eps2, dtype=dtype)
                vel = vel + 0.5 * w * dt * acc      # half kick, new a
        return pos, vel, acc
    if integrator != "reference":
        raise ValueError(f"unknown integrator {integrator!r}")
    acc = np.zeros_like(pos)
    for _ in range(steps):
        pos, vel, acc = oracle_step(pos, vel, mass, eps2, dt, dtype=dtype)
    return pos, vel, acc


def relative_mismatch(a: np.ndarray, b: np.ndarray, rel_tol: float = 0.01,
                      abs_tol: float = 1e-4) -> np.ndarray:
    """Per-element failure mask in the spirit of verify_still_bodies
    (validation.cpp:143-163): |a-b| <= rel_tol * min(|a|,|b|) passes.

    The reference uses a pure relative check which spuriously fails for
    components near zero; an absolute floor is added (a deliberate fix, noted
    in SURVEY.md C11) rather than reproducing that flaw.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    tol = rel_tol * np.minimum(np.abs(a), np.abs(b)) + abs_tol
    return np.abs(a - b) > tol


def assert_matches_oracle(device_arr, oracle_arr, what: str = "array",
                          rel_tol: float = 0.01, abs_tol: float = 1e-4,
                          max_frac_bad: float = 0.0):
    bad = relative_mismatch(device_arr, oracle_arr, rel_tol, abs_tol)
    frac = float(bad.mean())
    if frac > max_frac_bad:
        idx = np.argwhere(bad)[:5]
        raise AssertionError(
            f"{what}: {frac:.2%} of components exceed rel_tol={rel_tol} "
            f"(first offenders at {idx.tolist()}; device="
            f"{np.asarray(device_arr)[tuple(idx[0])] if len(idx) else '?'} "
            f"oracle={np.asarray(oracle_arr)[tuple(idx[0])] if len(idx) else '?'})")
