"""Diagnostics of a state, copied (numpy only) from ``nbody_tpu/analysis.py``
because the port must run where JAX is not installed: the conservation
measures that ``validate`` gates on (``center_of_mass``,
``angular_momentum``, ``invariant_drifts``) and the structure measures
that hold an ``--init`` preset to its physics (``com_drift``,
``lagrangian_radii``, ``pair_correlation``, ``virial_ratio``).

Conventions are the force contract's (G = 1, Plummer softening: pair
potential ``-m_i m_j / sqrt(|r|^2 + eps2)``).  Everything is host float64
numpy: these are offline diagnostics, and float64 keeps them out of the
noise they measure.  ``analyze_trajectory`` (the NPZ trajectory's series)
is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def center_of_mass(pos: np.ndarray, mass: np.ndarray) -> np.ndarray:
    """Mass-weighted mean position, (3,) float64."""
    pos = np.asarray(pos, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    return (mass[:, None] * pos).sum(axis=0) / mass.sum()


def com_drift(snapshots: np.ndarray, mass: np.ndarray) -> np.ndarray:
    """|COM(t) - COM(0)| per snapshot, (T,) float64.

    With the reference's cold start (v=0) total momentum is exactly zero,
    so any COM motion is integrator/rounding artifact — a cheap
    whole-trajectory health metric.  Accepts a (T, N, 3) array or any
    snapshot sequence (e.g. the streamed-NPZ ``LazySnapshots`` view) —
    snapshots are consumed one at a time.
    """
    coms = np.stack([center_of_mass(np.asarray(s, dtype=np.float64), mass)
                     for s in snapshots])
    return np.linalg.norm(coms - coms[0], axis=1)


def lagrangian_radii(pos: np.ndarray, mass: np.ndarray,
                     fractions: Sequence[float] = (0.1, 0.5, 0.9),
                     center: Optional[np.ndarray] = None) -> np.ndarray:
    """Radii enclosing the given mass fractions (about the COM by default).

    The 0.5 entry is the half-mass radius — the standard collapse /
    expansion indicator for the cold uniform boxes the reference
    initializes (``utils.cpp:23-47`` ranges).
    """
    pos = np.asarray(pos, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    c = center_of_mass(pos, mass) if center is None else np.asarray(center)
    r = np.linalg.norm(pos - c, axis=1)
    order = np.argsort(r)
    cum = np.cumsum(mass[order])
    total = cum[-1]
    out = np.empty(len(fractions), dtype=np.float64)
    for k, f in enumerate(fractions):
        idx = int(np.searchsorted(cum, f * total))
        out[k] = r[order[min(idx, len(r) - 1)]]
    return out


def pair_correlation(pos: np.ndarray, n_bins: int = 64,
                     r_max: Optional[float] = None,
                     chunk: int = 2048,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Radial pair-correlation function g(r) of a finite cloud.

    Normalization: the pair-distance histogram is divided by the expected
    histogram of bodies distributed uniformly in the enclosing sphere
    (computed analytically from the uniform-sphere pair-distance
    density), then rescaled so both histograms carry the same total pair
    count within ``r_max`` — making g a *shape* diagnostic that is
    insensitive to the enclosing-radius estimate (the sample max radius
    is biased by the COM offset).  g ~ 1 then means "uniform"; g > 1,
    clustering at that separation.  ``r_max`` defaults to the enclosing
    radius.  O(N^2) pair distances, chunked to bound the temporary at
    ``chunk * N`` float64s (distances come from the norm expansion
    ``|a|^2 + |b|^2 - 2 a.b`` — exact enough in f64 at domain scale, and
    8x leaner than materializing the (chunk, N, 3) difference tensor).

    Returns ``(r_centers, g)``, each (n_bins,).
    """
    pos = np.asarray(pos, dtype=np.float64)
    n = pos.shape[0]
    if n < 2:
        raise ValueError("pair_correlation needs at least 2 bodies")
    c = pos.mean(axis=0)
    radii = np.linalg.norm(pos - c, axis=1)
    enclosing = float(radii.max()) or 1.0
    if r_max is None:
        r_max = enclosing
    edges = np.linspace(0.0, r_max, n_bins + 1)
    hist = np.zeros(n_bins, dtype=np.float64)
    norms = np.sum(pos * pos, axis=1)              # (N,) |x|^2
    for s in range(0, n, chunk):
        pc = pos[s:s + chunk]
        d2 = norms[s:s + chunk, None] + norms[None, :] - 2.0 * (pc @ pos.T)
        d = np.sqrt(np.maximum(d2, 0.0))           # (chunk, N)
        # Upper triangle only: each unordered pair once, no self-pairs.
        jj = np.arange(n)[None, :]
        ii = (s + np.arange(pc.shape[0]))[:, None]
        d = d[jj > ii]
        hist += np.histogram(d, bins=edges)[0]
    # Uniform-sphere (radius R) pair-distance distribution: with x = s/R
    # in [0, 2] the separation PDF is p(s) = (3 s^2 / R^3)(1 - 3s/(4R)
    # + s^3/(16 R^3)), whose CDF is P(x) = x^3 (32 - 18x + x^3) / 32
    # (P(2) = 1).
    x = np.clip(edges / enclosing, 0.0, 2.0)
    cdf = np.clip(x ** 3 * (32.0 - 18.0 * x + x ** 3) / 32.0, 0.0, 1.0)
    expected = np.diff(cdf)
    if expected.sum() > 0:
        expected *= hist.sum() / expected.sum()
    centers = 0.5 * (edges[:-1] + edges[1:])
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.where(expected > 0, hist / expected, 0.0)
    return centers, g


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


def virial_ratio(pos: np.ndarray, vel: np.ndarray, mass: np.ndarray,
                 eps2: float) -> float:
    """Q = 2K / |W| with the softened potential (Q = 1 in virial
    equilibrium; 0 for the reference's cold start)."""
    vel = np.asarray(vel, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    ke = 0.5 * float(np.sum(mass * np.sum(vel * vel, axis=-1)))
    w = _potential_f64(np.asarray(pos, dtype=np.float64), mass, eps2)
    return 2.0 * ke / abs(w) if w else float("inf")


def _potential_f64(pos: np.ndarray, mass: np.ndarray, eps2: float,
                   chunk: int = 2048) -> float:
    pe = 0.0
    n = pos.shape[0]
    for s in range(0, n, chunk):
        pc = pos[s:s + chunk]
        mc = mass[s:s + chunk]
        r = pos[None, :, :] - pc[:, None, :]
        d2 = np.sum(r * r, axis=-1) + eps2
        with np.errstate(divide="ignore"):
            inv = 1.0 / np.sqrt(d2)
        # Mask self-pairs in place (works at eps2 = 0 too, where the
        # subtract-after trick would hit 1/0).
        rows = np.arange(pc.shape[0])
        inv[rows, s + rows] = 0.0
        pe += float(np.sum(mc[:, None] * mass[None, :] * inv))
    return -0.5 * pe
