"""K2 (the Newton's-third-law exact tier) of the PyTorch port against the
JAX package's ``forces_pallas_sym(variant="vpu2")`` and the float64
oracle, plus the port's own contract: the tile-pair enumeration, offset
chunking, momentum closure and real zero-mass bodies.

On the CPU the wrapper runs the kernels' plain twin, which has the
kernels' tiles, enumeration, slot layout and reduction order.  Tolerances
as in test_torch_forces_tiled.py: rel 1e-4 + 1e-6 * max|a| against JAX,
the 1% gate against the oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_small_system
from nbody_tpu.ops.forces_pallas_sym import forces_pallas_sym
from nbody_tpu.oracle.numpy_oracle import (assert_matches_oracle,
                                           oracle_forces, relative_mismatch)
from nbody_tpu_torch.ops.forces_sym import (SYM_TILE, forces_sym,
                                            forces_sym_plain, offset_chunks,
                                            tile_pairs)

EPS2 = 0.002


def assert_close_exact(got, want, what):
    bad = relative_mismatch(got, want, 1e-4, 1e-6 * np.abs(want).max())
    assert bad.sum() == 0, (
        f"{what}: {int(bad.sum())}/{bad.size} components differ; max "
        f"rel {np.abs(got - want).max() / np.abs(want).max():.3e}")


# The shapes of tests/test_pallas_sym.py::test_sym_vpu2_matches_oracle plus
# N=2048 (an even tile count on both sides: 8 JAX superblocks of 256, 8
# port tiles of 256).
@pytest.mark.parametrize("n,bi,bu,pnb", [
    (384, 64, 128, None),
    (700, 64, 128, None),
    (2048, 128, 256, None),
    (3000, 64, 256, 5),
])
def test_k2_twin_matches_jax_vpu2_and_oracle(n, bi, bu, pnb):
    pos, _, mass = make_small_system(n, seed=31)
    acc = forces_sym(torch.from_numpy(pos), torch.from_numpy(mass),
                     EPS2).numpy()
    ref_jax = np.asarray(forces_pallas_sym(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=bi, block_u=bu,
        panel_nb=pnb, variant="vpu2"))
    assert_close_exact(acc, ref_jax, f"K2 twin vs JAX vpu2, N={n}")
    assert_matches_oracle(acc, oracle_forces(pos, mass, EPS2),
                          f"K2 twin vs oracle, N={n}")


@pytest.mark.parametrize("nb", [1, 2, 3, 4, 7, 8, 12, 33])
def test_k2_enumeration_visits_each_tile_pair_once(nb):
    pairs = tile_pairs(nb)
    unordered = [frozenset(p) for p in pairs]
    assert all(len(p) == 2 for p in unordered)          # no diagonal tile
    assert len(unordered) == len(set(unordered)) == nb * (nb - 1) // 2


def test_k2_offset_chunks_cover_offsets_and_respect_budget():
    n_pad = 12 * SYM_TILE
    per_offset = 2 * n_pad * 3 * 4
    for budget in (per_offset, 2 * per_offset, 5 * per_offset, 1 << 31):
        chunks = offset_chunks(12, n_pad, budget)
        offsets = [lo + k for lo, dc in chunks for k in range(dc)]
        assert offsets == list(range(1, 7))
        assert all(dc * per_offset <= budget for _, dc in chunks)
    with pytest.raises(ValueError, match="budget"):
        offset_chunks(12, n_pad, per_offset - 1)
    # N = 1,048,576: 2048 offsets in 2 GiB chunks of 85.
    chunks = offset_chunks(4096, 4096 * SYM_TILE)
    assert chunks[0] == (1, 85) and sum(dc for _, dc in chunks) == 2048


def test_k2_chunked_offsets_are_bit_equal():
    """Folding the offsets chunk by chunk keeps the reduction order, so
    the result is bit-equal to one chunk."""
    pos, _, mass = make_small_system(3000, seed=32)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    whole = forces_sym_plain(p, m, EPS2)
    n_pad = 12 * SYM_TILE
    for k in (1, 4):
        np.testing.assert_array_equal(
            forces_sym_plain(p, m, EPS2, slot_budget=k * 24 * n_pad).numpy(),
            whole.numpy())


def test_k2_momentum_closure():
    """Each pair enters both sides with one shared weight, so the net
    force sum_i m_i a_i vanishes to rounding."""
    pos, _, mass = make_small_system(1500, seed=33)
    acc = forces_sym(torch.from_numpy(pos), torch.from_numpy(mass),
                     EPS2).numpy().astype(np.float64)
    m = mass.astype(np.float64)[:, None]
    net = np.abs((m * acc).sum(0)).max()
    scale = (m * np.abs(acc)).sum()
    assert net / scale < 1e-6, net / scale


def test_k2_real_zero_mass_bodies_are_correct():
    """A real body of mass 0 feels the full field (its row is recomputed
    one-sided) and pulls on nothing.  The JAX vpu2 path returns only its
    diagonal terms, so this is gated against the oracle, not JAX."""
    pos, _, mass = make_small_system(700, seed=34)
    mass[[1, 300, 699]] = 0.0
    acc = forces_sym(torch.from_numpy(pos), torch.from_numpy(mass),
                     EPS2).numpy()
    ref = oracle_forces(pos, mass, EPS2)
    assert_close_exact(acc, ref, "K2 twin with zero-mass bodies vs oracle")
    assert np.abs(acc[[1, 300, 699]]).min() > 0


def test_k2_wrapper_contract():
    pos, _, mass = make_small_system(300, seed=35)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    before = forces_sym.launches
    forces_sym(p, m, EPS2)
    assert forces_sym.launches == before
    with pytest.raises(ValueError, match="float32"):
        forces_sym(p.double(), m.double(), EPS2)
    with pytest.raises(ValueError, match="no kernel"):
        forces_sym(p.to("meta"), m.to("meta"), EPS2)
