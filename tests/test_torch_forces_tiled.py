"""K1 (the one-sided exact tile) of the PyTorch port against the JAX
package's ``forces_pallas(variant="vpu")`` and the float64 oracle.

On the CPU the port's wrapper runs the kernel's plain PyTorch twin (the
CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the same twin); the JAX side runs Pallas in interpret mode, as
its own suite does.

Tolerances: against JAX, every component within ``rel 1e-4`` plus an
absolute floor of ``1e-6 * max|a|`` (both are float32 exact tiers that
sum in different orders); against the oracle, the 1% gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_small_system
from nbody_tpu.ops.forces_pallas import forces_pallas, rect_forces_pallas
from nbody_tpu.oracle.numpy_oracle import (assert_matches_oracle,
                                           oracle_forces, relative_mismatch)
from nbody_tpu_torch.ops.forces_tiled import (forces_tiled,
                                              rect_forces_tiled,
                                              rect_forces_tiled_plain)

EPS2 = 0.002


def assert_close_exact(got, want, what):
    bad = relative_mismatch(got, want, 1e-4, 1e-6 * np.abs(want).max())
    assert bad.sum() == 0, (
        f"{what}: {int(bad.sum())}/{bad.size} components differ; max "
        f"rel {np.abs(got - want).max() / np.abs(want).max():.3e}")


@pytest.mark.parametrize("n", [256, 700, 1280])
def test_k1_twin_matches_jax_and_oracle(n):
    pos, _, mass = make_small_system(n, seed=51)
    acc = forces_tiled(torch.from_numpy(pos), torch.from_numpy(mass),
                       EPS2).numpy()
    ref_jax = np.asarray(forces_pallas(jnp.asarray(pos), jnp.asarray(mass),
                                       EPS2, block_i=128, block_j=256,
                                       variant="vpu"))
    assert_close_exact(acc, ref_jax, f"K1 twin vs JAX vpu, N={n}")
    assert_matches_oracle(acc, oracle_forces(pos, mass, EPS2),
                          f"K1 twin vs oracle, N={n}")


def test_k1_rect_matches_jax_rect():
    """The rect form (i-set against a different j-set), as the ring will
    use it; padded shapes for the JAX side."""
    pos_i, _, _ = make_small_system(256, seed=52)
    pos_j, _, mass_j = make_small_system(512, seed=53)
    acc = rect_forces_tiled(torch.from_numpy(pos_i), torch.from_numpy(pos_j),
                            torch.from_numpy(mass_j), EPS2).numpy()
    ref = np.asarray(rect_forces_pallas(
        jnp.asarray(pos_i), jnp.asarray(pos_j), jnp.asarray(mass_j), EPS2,
        block_i=128, block_j=256, variant="vpu"))
    assert_close_exact(acc, ref, "K1 rect twin vs JAX rect")


def test_k1_wrapper_contract():
    """float32 (N,3) + (N,) contiguous on CPU or CUDA, else ValueError;
    the plain twin is what a CPU tensor gets, and no launch is counted."""
    pos, _, mass = make_small_system(300, seed=54)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    before = forces_tiled.launches
    np.testing.assert_array_equal(
        forces_tiled(p, m, EPS2).numpy(),
        rect_forces_tiled_plain(p, p, m, EPS2).numpy())
    assert forces_tiled.launches == before
    with pytest.raises(ValueError, match="float32"):
        forces_tiled(p.double(), m.double(), EPS2)
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        forces_tiled(p[:, :2].contiguous(), m, EPS2)
    with pytest.raises(ValueError, match="mass"):
        forces_tiled(p, m[:-1], EPS2)
    with pytest.raises(ValueError, match="contiguous"):
        forces_tiled(p.t().contiguous().t(), m, EPS2)
    with pytest.raises(ValueError, match="no kernel"):
        forces_tiled(p.to("meta"), m.to("meta"), EPS2)
