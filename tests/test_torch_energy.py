"""K8's plain path and the port's energy diagnostics against the JAX
package: ``pe_rows_plain`` and the symmetric ``pe_total_plain`` against
``pe_rows_pallas`` in interpret mode, ``total_energy_bounded`` against the JAX package's Pallas path and the
float64 host branch, and ``energy_f64``'s delegation above
``max_host_n``.

Tolerances.  Pair-potential sums, port against JAX: relative 2e-6; both
sum float32 terms, the port in 256-term float32 tiles added in float64,
JAX in float32 blocks (the self terms, m_i^2/sqrt(eps2), ride in both).
Total energy against the float64 host sum: relative 1e-4.  The mask-free
kernel's error scales with the self terms' share of the row sums
(pe_pallas.py's docstring: ~3e-5 at N = 3k); the port measured 2.5e-5,
3.4e-5 and 9.9e-6 at N = 700, 1500 and 3000 on these seeded systems, and
JAX's Pallas path 6.7e-4, 2.9e-5 and 4.3e-5.  Port against the JAX
Pallas path: relative 2e-4, the JAX test's own bound for it.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu import SimState as JaxSimState
from nbody_tpu.models import energy as jax_energy
from nbody_tpu.ops.pe_pallas import pe_rows_pallas
from nbody_tpu_torch.models import energy
from nbody_tpu_torch.ops.pe import (PE_TILE, pe_rows, pe_rows_plain,
                                    pe_total, pe_total_plain)

EPS2 = 0.002


def _system(n, seed):
    pos, vel, mass = make_small_system(n, seed=seed)
    vel = vel + np.random.default_rng(seed).normal(
        scale=100.0, size=vel.shape).astype(np.float32)
    return pos, vel, mass


@pytest.mark.parametrize("n,rows", [(600, slice(0, 600)),
                                    (1100, slice(130, 517))])
def test_pe_rows_plain_matches_jax_interpret(n, rows):
    pos, _, mass = _system(n, seed=81)
    want = float(pe_rows_pallas(jnp.asarray(pos[rows]),
                                jnp.asarray(mass[rows]), jnp.asarray(pos),
                                jnp.asarray(mass), EPS2, interpret=True))
    t = torch.from_numpy
    got = pe_rows_plain(t(pos[rows]), t(mass[rows]), t(pos), t(mass), EPS2)
    assert got.dtype == torch.float64
    assert got.shape == (rows.stop - rows.start,)
    assert abs(float(got.sum()) - want) / abs(want) < 2e-6
    # The wrapper takes the plain version for CPU tensors, launching
    # nothing; the self terms are included.
    before = pe_rows.launches
    again = pe_rows(t(pos[rows]), t(mass[rows]), t(pos), t(mass), EPS2)
    assert torch.equal(again, got) and pe_rows.launches == before
    m = mass[rows].astype(np.float64)
    assert (got.numpy() > m * m / np.sqrt(EPS2)).all()


def test_pe_rows_plain_tiles_and_f64_host_sum():
    """Per row, against an exact float64 sum: the float32 error comes
    only from the 256-term tiles."""
    n = 3 * PE_TILE + 17
    pos, _, mass = _system(n, seed=82)
    t = torch.from_numpy
    got = pe_rows_plain(t(pos), t(mass), t(pos), t(mass), EPS2).numpy()
    p, m = pos.astype(np.float64), mass.astype(np.float64)
    d2 = ((p[None] - p[:, None]) ** 2).sum(-1) + EPS2
    want = m * (m[None, :] / np.sqrt(d2)).sum(1)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# N = 600: three tiles (odd nb); 3 * 256 + 17 and 4 * 256 + 5: a ragged
# last tile with an even tile count, whose half offset is taken once.
@pytest.mark.parametrize("n", [600, 3 * PE_TILE + 17, 4 * PE_TILE + 5])
def test_pe_total_plain_matches_jax_interpret_and_f64(n):
    pos, _, mass = _system(n, seed=85)
    j = jnp.asarray
    want = float(pe_rows_pallas(j(pos), j(mass), j(pos), j(mass), EPS2,
                                interpret=True))
    t = torch.from_numpy
    got = pe_total_plain(t(pos), t(mass), EPS2)
    assert got.dtype == torch.float64 and got.dim() == 0
    assert abs(float(got) - want) / abs(want) < 2e-6
    p, m = pos.astype(np.float64), mass.astype(np.float64)
    d2 = ((p[None] - p[:, None]) ** 2).sum(-1) + EPS2
    exact = float((m[:, None] * m[None, :] / np.sqrt(d2)).sum())
    assert abs(float(got) - exact) / exact < 1e-6
    # Each unordered pair once: the one-sided row sums give the same total.
    rows = pe_rows_plain(t(pos), t(mass), t(pos), t(mass), EPS2)
    assert abs(float(got) - float(rows.sum())) / exact < 1e-6
    # The wrapper takes the plain version for CPU tensors, launching
    # nothing.
    before = pe_total.launches
    assert torch.equal(pe_total(t(pos), t(mass), EPS2), got)
    assert pe_total.launches == before


def test_pe_total_plain_massless_bodies_and_eps2_zero():
    """A real massless body adds exactly 0; the zero-mass ghosts past N
    add nothing; with eps2 = 0 the self pairs give inf, not a masked
    value."""
    n = 2 * PE_TILE + 40
    pos, _, mass = _system(n, seed=86)
    t = torch.from_numpy
    zero = mass.copy()
    zero[[3, 300, n - 1]] = 0.0
    keep = np.ones(n, bool)
    keep[[3, 300, n - 1]] = False
    got = float(pe_total_plain(t(pos), t(zero), EPS2))
    want = float(pe_total_plain(t(np.ascontiguousarray(pos[keep])),
                                t(np.ascontiguousarray(zero[keep])), EPS2))
    assert abs(got - want) / want < 1e-6
    assert float(pe_total_plain(t(pos), t(mass), 0.0)) == float("inf")


def test_total_energy_bounded_matches_jax_and_host_f64():
    n = 1500
    pos, vel, mass = _system(n, seed=83)
    jax_state = JaxSimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                            acc=jnp.zeros((n, 3), jnp.float32),
                            mass=jnp.asarray(mass))
    exact = jax_energy.energy_f64(jax_state, EPS2)
    jax_pallas = jax_energy.total_energy_bounded(jax_state, EPS2,
                                                 use_pallas=True)
    state = nt.state_from_numpy({"pos": pos, "vel": vel,
                                 "acc": np.zeros_like(pos), "mass": mass},
                                device="cpu")
    port = energy.total_energy_bounded(state, EPS2)
    assert energy.energy_f64(state, EPS2) == exact
    assert abs(port - exact) / abs(exact) < 1e-4
    assert abs(port - jax_pallas) / abs(exact) < 2e-4
    assert abs(jax_pallas - exact) / abs(exact) < 2e-4
    ke = float(energy.kinetic_energy(state.vel, state.mass))
    np.testing.assert_allclose(
        ke, float(jax_energy.kinetic_energy(jax_state.vel, jax_state.mass)),
        rtol=1e-6)


def test_energy_f64_delegates_above_max_host_n(monkeypatch):
    n = 700
    pos, vel, mass = _system(n, seed=84)
    state = nt.state_from_numpy({"pos": pos, "vel": vel,
                                 "acc": np.zeros_like(pos), "mass": mass},
                                device="cpu")
    exact = energy.energy_f64(state, EPS2)
    monkeypatch.setattr(energy, "_delegation_warned", False)
    with pytest.warns(UserWarning, match="delegating"):
        delegated = energy.energy_f64(state, EPS2, max_host_n=100)
    assert delegated == energy.total_energy_bounded(state, EPS2)
    assert abs(delegated - exact) / abs(exact) < 1e-4
    # Warned once per process; numpy inputs delegate too.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        host = nt.SimState(pos=pos, vel=vel, acc=pos, mass=mass)
        assert energy.energy_f64(host, EPS2, max_host_n=100) == delegated
    jax_delegated = jax_energy.energy_f64(
        JaxSimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                    acc=jnp.zeros((n, 3), jnp.float32),
                    mass=jnp.asarray(mass)), EPS2, max_host_n=100)
    assert abs(delegated - jax_delegated) / abs(exact) < 1e-4
