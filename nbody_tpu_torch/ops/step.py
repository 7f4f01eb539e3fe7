"""Simulation step and the multi-step driver, as in ``nbody_tpu/ops/step.py``.

PyTorch runs eagerly, so ``run_steps`` is a Python loop over ``step``
(the JAX package compiles the loop into one ``fori_loop`` program); the
kernels queue on the current stream and nothing waits for the card until
a caller synchronises.  The bounded multi-program, flat-state and
trajectory drivers come later.
"""

from __future__ import annotations

from ..config import SimConfig
from ..models.integrators import (KDK_WEIGHTS, kdk_drift, kdk_kick,
                                  reference_update)
from ..models.state import SimState
from .forces import compute_forces, resolve_impl


def step(state: SimState, cfg: SimConfig,
         impl: "str | None" = None) -> SimState:
    """One step: forces from the current positions, then the fused
    half-kick + drift (or the KDK-composed sub-steps)."""
    impl = impl or resolve_impl(cfg)
    if cfg.integrator == "reference":
        acc = compute_forces(state.pos, state.mass, cfg, impl=impl)
        pos, vel = reference_update(state.pos, state.vel, acc, cfg.dt)
        return SimState(pos=pos, vel=vel, acc=acc, mass=state.mass)
    weights = KDK_WEIGHTS.get(cfg.integrator)
    if weights is not None:
        pos, vel, acc = state.pos, state.vel, state.acc
        for w in weights:
            wdt = w * cfg.dt
            vel_half = kdk_kick(vel, acc, wdt)
            pos = kdk_drift(pos, vel_half, wdt)
            acc = compute_forces(pos, state.mass, cfg, impl=impl)
            vel = kdk_kick(vel_half, acc, wdt)
        return SimState(pos=pos, vel=vel, acc=acc, mass=state.mass)
    raise ValueError(f"unknown integrator {cfg.integrator!r}")


def prime_kdk(state: SimState, cfg: SimConfig,
              impl: "str | None" = None) -> SimState:
    """Seed ``state.acc = a(x_0)`` so the first KDK half-kick is
    consistent."""
    acc = compute_forces(state.pos, state.mass, cfg,
                         impl=impl or resolve_impl(cfg))
    return state._replace(acc=acc)


def run_steps(state: SimState, cfg: SimConfig, n_steps: int,
              impl: "str | None" = None) -> SimState:
    """Run ``n_steps`` steps."""
    impl = impl or resolve_impl(cfg)
    for _ in range(n_steps):
        state = step(state, cfg, impl=impl)
    return state
