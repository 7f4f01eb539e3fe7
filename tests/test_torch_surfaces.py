"""The last public functions of the JAX package's modules in the port:
``models/energy.py``'s ``potential_energy``, ``total_energy`` and
``total_momentum``, ``models/state.py``'s ``pad_state`` and
``utils/timing.py``'s ``measure_steps``, each against its JAX counterpart
on the same seeded numpy inputs.

Tolerance: the energies in float32 at rel 1e-5 (both sum row chunks of
float32 terms, in different orders), in float64 at rel 1e-12 (JAX with
x64 on; rel 1e-10 against ``energy_f64``, which subtracts the self pairs
after summing); the momentum within 1e-6 (float32) or 1e-13 (float64) of
N times its largest term; the padded state bit for bit (copies and
zeros); ``measure_steps``' state, an ``xla`` run on both sides at N = 96,
at the exact tier's rel 1e-4 + 1e-6·max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu import SimState as JaxSimState
from nbody_tpu import pad_state as jax_pad_state
from nbody_tpu import run_steps as jax_run_steps
from nbody_tpu.models import energy as jax_energy
from nbody_tpu.oracle.numpy_oracle import relative_mismatch
from nbody_tpu.utils.timing import measure_steps as jax_measure_steps
from nbody_tpu_torch.models import energy
from nbody_tpu_torch.models.state import pad_state
from nbody_tpu_torch.utils.timing import measure_steps


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def system(n, seed, dtype=np.float32, massless=()):
    pos, vel, mass = make_small_system(n, seed=seed)
    mass[list(massless)] = 0.0
    acc = np.random.default_rng(seed + 1).normal(size=(n, 3))
    return tuple(a.astype(dtype) for a in (pos, vel, acc, mass))


@pytest.mark.parametrize("n,chunk", [(300, 2048), (300, 64), (257, 100)])
def test_potential_and_total_energy_match_jax_float32(n, chunk):
    pos, vel, acc, mass = system(n, seed=n + chunk, massless=(0, n - 1))
    got = energy.potential_energy(torch.from_numpy(pos),
                                  torch.from_numpy(mass), 0.002, chunk=chunk)
    want = jax_energy.potential_energy(jnp.asarray(pos), jnp.asarray(mass),
                                       0.002, chunk=chunk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    port = nt.SimState(*(torch.from_numpy(a) for a in (pos, vel, acc, mass)))
    jstate = JaxSimState(*(jnp.asarray(a) for a in (pos, vel, acc, mass)))
    np.testing.assert_allclose(float(energy.total_energy(port, 1e6)),
                               float(jax_energy.total_energy(jstate, 1e6)),
                               rtol=1e-5)


def test_energies_match_jax_and_float64_sum_in_float64(x64):
    pos, vel, acc, mass = system(200, seed=3, dtype=np.float64)
    port = nt.SimState(*(torch.from_numpy(a) for a in (pos, vel, acc, mass)))
    jstate = JaxSimState(*(jnp.asarray(a) for a in (pos, vel, acc, mass)))
    got = energy.total_energy(port, 0.002)
    assert got.dtype == torch.float64
    want = jax_energy.total_energy(jstate, 0.002)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    # ...and the host float64 sum of the drift gates, which subtracts the
    # self pairs after summing (rel 1e-10: that cancellation's rounding).
    np.testing.assert_allclose(float(got), energy.energy_f64(port, 0.002),
                               rtol=1e-10)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_total_momentum_matches_jax(dtype, x64):
    _, vel, _, mass = system(333, seed=9, dtype=dtype)
    got = energy.total_momentum(torch.from_numpy(vel),
                                torch.from_numpy(mass)).numpy()
    want = np.asarray(jax_energy.total_momentum(jnp.asarray(vel),
                                                jnp.asarray(mass)))
    assert got.shape == (3,) and got.dtype == dtype
    scale = np.abs(mass[:, None] * vel).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=(1e-6 if dtype == np.float32 else 1e-13)
                               * scale * len(mass))


@pytest.mark.parametrize("n,multiple", [(300, 256), (256, 256), (5, 8),
                                        (1000, 128)])
def test_pad_state_matches_jax(n, multiple):
    arrs = system(n, seed=n)
    got = pad_state(nt.SimState(*(torch.from_numpy(a) for a in arrs)),
                    multiple)
    want = jax_pad_state(JaxSimState(*(jnp.asarray(a) for a in arrs)),
                         multiple)
    assert got.n % multiple == 0 and got.n == want.n
    for k in ("pos", "vel", "acc", "mass"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))


def test_measure_steps_matches_jax():
    pos, vel, acc, mass = system(96, seed=12)
    cfg = nt.SimConfig(n_bodies=96, impl="xla", device="cpu", chunk=32)
    calls = []

    def fn(state, steps):
        calls.append(steps)
        return nt.run_steps(state, cfg, steps)

    port = nt.SimState(*(torch.from_numpy(a) for a in (pos, vel, acc, mass)))
    out, secs = measure_steps(fn, port, 3)
    assert calls == [3, 3] and secs > 0.0
    _, _ = measure_steps(fn, port, 2, warmup=False)
    assert calls == [3, 3, 2]
    jcfg = JaxSimConfig(n_bodies=96, impl="xla", chunk=32)
    jout, jsecs = jax_measure_steps(
        lambda s, k: jax_run_steps(s, jcfg, k),
        JaxSimState(*(jnp.asarray(a) for a in (pos, vel, acc, mass))), 3)
    assert jsecs > 0.0
    for k in ("pos", "vel", "acc"):
        want = np.asarray(getattr(jout, k))
        assert relative_mismatch(getattr(out, k).numpy(), want, 1e-4,
                                 1e-6 * np.abs(want).max()).sum() == 0
