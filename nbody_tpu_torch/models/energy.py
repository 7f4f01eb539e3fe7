"""Float64 host-side total energy: the host branch of
``nbody_tpu/models/energy.py::energy_f64``, copied (numpy only) because
the port must run where JAX is not installed.

The pair potential consistent with the softened force is the Plummer
potential ``phi_ij = -m_i m_j / sqrt(|r|^2 + eps2)``.  The device path the
JAX package takes above ``MAX_HOST_ENERGY_N`` bodies (kernel K8) is not
ported, so larger states raise.
"""

from __future__ import annotations

import numpy as np

MAX_HOST_ENERGY_N = 262144


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def energy_f64(state, eps2: float,
               max_host_n: int = MAX_HOST_ENERGY_N) -> float:
    """Total (kinetic + softened potential) energy in float64 on the host.
    ``state`` has ``pos``/``vel``/``mass`` as tensors or arrays."""
    pos, vel, mass = _host(state.pos), _host(state.vel), _host(state.mass)
    n = pos.shape[0]
    if n > max_host_n:
        raise NotImplementedError(
            f"energy_f64: N={n} > max_host_n={max_host_n}; the bounded "
            f"device energy (ROADMAP Queue 2 K8) is not ported yet")
    ke = 0.5 * float(np.sum(mass * np.sum(vel * vel, axis=-1)))
    pe = 0.0
    # Bound the (chunk, N, 3) float64 temporary to ~400 MB.
    chunk = max(1, min(n, 16 * 1024 * 1024 // max(n, 1) + 1))
    for s in range(0, n, chunk):
        pc = pos[s:s + chunk]
        mc = mass[s:s + chunk]
        r = pos[None, :, :] - pc[:, None, :]
        d2 = np.sum(r * r, axis=-1) + eps2
        inv = 1.0 / np.sqrt(d2)
        pe += float(np.sum(mc[:, None] * mass[None, :] * inv))
        pe -= float(np.sum(mc * mc)) / np.sqrt(eps2)
    return ke - 0.5 * pe
