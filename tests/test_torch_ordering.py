"""The port's Morton ordering (``models/ordering.py``) against the JAX
package's ``nbody_tpu/models/ordering.py``, and the properties its own
tests hold: locality, physics invariance, a stable sort.

Codes and permutations must equal the JAX package's bit for bit: both
quantise in float32 the same way, spread the bits the same way (int64
here, uint32 there) and sort stably.  Physics invariance uses the JAX
test's tolerance (rel 1e-5, abs 1e-1 on positions after 5 steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu import SimState as JaxSimState
from nbody_tpu.models.ordering import morton_codes as jax_morton_codes
from nbody_tpu.models.ordering import morton_sort_state as jax_sort_state
from nbody_tpu_torch.models.ordering import (apply_permutation, morton_codes,
                                             morton_permutation,
                                             morton_sort_state)


def _port_state(pos, vel, mass):
    return nt.SimState(pos=torch.from_numpy(pos), vel=torch.from_numpy(vel),
                       acc=torch.from_numpy(pos * 1e-3),
                       mass=torch.from_numpy(mass))


@pytest.mark.parametrize("spread", [1e5, 1.3e5])
def test_codes_equal_jax_bit_for_bit(spread):
    """Uniform bodies in the box, and (spread 1.3e5) bodies outside it,
    which clamp to the boundary cells."""
    rng = np.random.default_rng(41)
    pos = rng.uniform(-spread, spread, (4096, 3)).astype(np.float32)
    got = morton_codes(torch.from_numpy(pos), -1e5, 1e5).numpy()
    want = np.asarray(jax_morton_codes(jnp.asarray(pos), -1e5, 1e5))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.dtype == np.int64 and 0 <= got.min() and got.max() < 1 << 30


def test_codes_known_values():
    pos = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    codes = morton_codes(pos, 0.0, 1.0).numpy()
    assert codes[0] == 0
    assert codes[1] == (1 << 30) - 1      # all 30 bits set
    # One cell step along x, y, z sets bits 0, 1, 2.
    step = 1.0 / 1023
    one = torch.tensor([[step, 0, 0], [0, step, 0], [0, 0, step]]) * 1.0001
    assert morton_codes(one, 0.0, 1.0).tolist() == [1, 2, 4]
    # Far outside the box: the corner cells.
    far = torch.tensor([[-5.0, -5.0, -5.0], [5.0, 5.0, 5.0]])
    assert morton_codes(far, 0.0, 1.0).tolist() == [0, (1 << 30) - 1]


def test_permutation_equals_jax_with_tied_codes():
    """Bodies on a coarse lattice share cells, so many codes tie; a stable
    sort keeps tied bodies in index order, as ``jnp.argsort`` does."""
    rng = np.random.default_rng(42)
    cells = rng.integers(0, 6, (3000, 3)).astype(np.float32)
    pos = (cells * 3e4 - 8e4 + rng.uniform(0, 50, (3000, 3))).astype(
        np.float32)
    vel = rng.normal(size=(3000, 3)).astype(np.float32)
    mass = rng.uniform(1e5, 1e9, 3000).astype(np.float32)
    codes = morton_codes(torch.from_numpy(pos), -1e5, 1e5)
    assert len(torch.unique(codes)) < 300          # heavy ties
    state, perm = morton_sort_state(_port_state(pos, vel, mass), -1e5, 1e5)
    jax_state, jax_perm = jax_sort_state(
        JaxSimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                    acc=jnp.asarray(pos * 1e-3), mass=jnp.asarray(mass)),
        -1e5, 1e5)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jax_perm))
    for k in ("pos", "vel", "acc", "mass"):
        np.testing.assert_array_equal(getattr(state, k).numpy(),
                                      np.asarray(getattr(jax_state, k)))


def test_locality():
    """Sorted order shrinks the spatial extent of index blocks."""
    pos, vel, mass = make_small_system(2048, seed=50)
    sorted_state, _ = morton_sort_state(_port_state(pos, vel, mass),
                                        -1e5, 1e5)

    def mean_block_extent(p, block=64):
        p = np.asarray(p).reshape(-1, block, 3)
        return float(np.mean(p.max(axis=1) - p.min(axis=1)))

    assert mean_block_extent(sorted_state.pos) < 0.6 * mean_block_extent(pos)


def test_permutation_preserves_physics():
    """Running then sorting equals sorting then running, up to the
    relabelling and float32 reduction-order noise."""
    n = 256
    pos, vel, mass = make_small_system(n, seed=51)
    state = _port_state(pos, vel, mass)
    cfg = nt.SimConfig(n_bodies=n, impl="xla_nxn", device="cpu")
    sorted_state, perm = morton_sort_state(state, -1e5, 1e5)
    out_sorted = nt.run_steps(sorted_state, cfg, 5)
    out_plain = apply_permutation(nt.run_steps(state, cfg, 5), perm)
    np.testing.assert_allclose(out_sorted.pos.numpy(), out_plain.pos.numpy(),
                               rtol=1e-5, atol=1e-1)
    assert torch.equal(out_sorted.mass, out_plain.mass)


def test_sort_is_stable_identity_for_sorted_input():
    pos, vel, mass = make_small_system(512, seed=52)
    s1, _ = morton_sort_state(_port_state(pos, vel, mass), -1e5, 1e5)
    perm = morton_permutation(s1.pos, -1e5, 1e5)
    assert torch.equal(perm, torch.arange(512))
