"""K14d, the fold schedule of the exact pair-symmetric tiers (K2's math,
``vpu2``, and K7's, ``vpu``), against the JAX package's
``forces_pallas_sym(schedule="fold")``, the float64 oracle and the classic
K2/K7 twins; its offset chunking and real massless bodies.

On the CPU the wrappers run the kernels' plain twin: superblocks of
``block_u`` bodies, the superblock offsets, each superblock's column sums
folded across its 256-row tiles in row-tile order, one-sided exact
diagonal superblocks.  The JAX side runs Pallas in interpret mode at
``block_i=256, block_u=U``, the port's row tile and superblock: U of 512,
768, 1024 (the default) and 2048, two to eight row tiles a superblock, the
kernel's cluster size.
Tolerances: the exact tier's rel 1e-4 + 1e-6·max|a| against JAX and the
oracle's 1% gate; against the classic twins ``rtol=1e-4, atol=1e-2``, as
``tests/test_pallas_sym.py::test_sym_fold_schedule`` holds JAX's fold to
JAX's classic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_small_system
from nbody_tpu.ops.forces_pallas_sym import forces_pallas_sym as jax_sym
from nbody_tpu.oracle.numpy_oracle import (assert_matches_oracle,
                                           oracle_forces, relative_mismatch)
from nbody_tpu_torch.ops import forces_sym

EPS2 = 0.002
FOLD = {"vpu2": forces_sym.forces_sym_fold,
        "vpu": forces_sym.forces_sym_vpu_fold}
CLASSIC = {"vpu2": forces_sym.forces_sym, "vpu": forces_sym.forces_sym_vpu}


def assert_close_exact(got, want, what):
    bad = relative_mismatch(got, want, 1e-4, 1e-6 * np.abs(want).max())
    assert bad.sum() == 0, (
        f"{what}: {int(bad.sum())}/{bad.size} components differ; max "
        f"rel {np.abs(got - want).max() / np.abs(want).max():.3e}")


@pytest.mark.parametrize("variant", ["vpu", "vpu2"])
@pytest.mark.parametrize("n", [1536, 1300])
def test_fold_twin_matches_jax_fold_oracle_and_classic(variant, n):
    """Three superblocks of U=512 (two row tiles each): N=1536 whole,
    N=1300 ragged (its last superblock holds ghosts)."""
    u = 512
    pos, _, mass = make_small_system(n, seed=151)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    acc = FOLD[variant](p, m, EPS2, block_u=u).numpy()
    ref_jax = np.asarray(jax_sym(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=256, block_u=u,
        variant=variant, schedule="fold"))
    assert_close_exact(acc, ref_jax, f"fold {variant} twin vs JAX, N={n}")
    assert_matches_oracle(acc, oracle_forces(pos, mass, EPS2),
                          f"fold {variant} twin vs oracle, N={n}")
    np.testing.assert_allclose(acc, CLASSIC[variant](p, m, EPS2).numpy(),
                               rtol=1e-4, atol=1e-2)


# (block_u, N): three and eight row tiles a superblock on an odd and an
# even superblock count, each ragged (the last superblock holds ghosts).
SUB_CASES = [(768, 2000), (768, 2900), (2048, 5000), (2048, 7000)]


def jax_fold(pos, mass, variant, block_u):
    return np.asarray(jax_sym(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=256,
        block_u=block_u, variant=variant, schedule="fold"))


@pytest.mark.parametrize("variant", ["vpu", "vpu2"])
@pytest.mark.parametrize("block_u,n", SUB_CASES)
def test_fold_twin_matches_jax_fold_at_three_and_eight_row_tiles(
        variant, block_u, n):
    """The twin's grouping (row sums a 256-column tile, added across the
    column tiles; column sums a row tile, added across the row tiles) at
    the cluster sizes 3 and 8, against JAX's fold at the same superblock."""
    pos, _, mass = make_small_system(n, seed=156)
    acc = FOLD[variant](torch.from_numpy(pos), torch.from_numpy(mass), EPS2,
                        block_u=block_u).numpy()
    assert_close_exact(acc, jax_fold(pos, mass, variant, block_u),
                       f"fold {variant} twin vs JAX, U={block_u}, N={n}")


@pytest.mark.parametrize("variant", ["vpu", "vpu2"])
def test_fold_real_massless_bodies_at_eight_row_tiles(variant):
    """Massless bodies in the first, a middle and the ragged last
    superblock at U=2048: every row at the oracle's exact tolerance, and
    against JAX's fold on every row where JAX is right (all of them for
    vpu; vpu2's JAX leaves a massless row its diagonal superblock only,
    where the port recomputes it one-sided)."""
    n, block_u, zero = 5000, 2048, [1, 2100, 4999]
    pos, _, mass = make_small_system(n, seed=157)
    mass[zero] = 0.0
    acc = FOLD[variant](torch.from_numpy(pos), torch.from_numpy(mass), EPS2,
                        block_u=block_u).numpy()
    assert_close_exact(acc, oracle_forces(pos, mass, EPS2),
                       f"fold {variant} U=2048 with massless bodies vs "
                       f"oracle")
    rows = (np.arange(n) if variant == "vpu"
            else np.setdiff1d(np.arange(n), zero))
    ref = jax_fold(pos, mass, variant, block_u)
    assert_close_exact(acc[rows], ref[rows],
                       f"fold {variant} U=2048 with massless bodies vs JAX")


@pytest.mark.parametrize("variant", ["vpu", "vpu2"])
def test_fold_at_the_default_superblock_matches_jax(variant):
    """The default U=1024 on an odd superblock count with a ragged tail,
    against JAX's fold at block_u=1024."""
    pos, _, mass = make_small_system(2900, seed=158)
    acc = FOLD[variant](torch.from_numpy(pos), torch.from_numpy(mass),
                        EPS2).numpy()
    assert_close_exact(acc, jax_fold(pos, mass, variant,
                                     forces_sym.FOLD_BLOCK_U),
                       f"fold {variant} twin vs JAX, default U, N=2900")


@pytest.mark.parametrize("variant", ["vpu", "vpu2"])
def test_fold_at_the_default_superblock_and_an_even_count(variant):
    """The default U=1024 at N=4000: four superblocks, an even count, so
    the half offset is taken by half the superblocks, as in K2's sweep."""
    pos, _, mass = make_small_system(4000, seed=152)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    acc = FOLD[variant](p, m, EPS2).numpy()
    assert forces_sym.FOLD_BLOCK_U == 1024
    assert_close_exact(acc, CLASSIC[variant](p, m, EPS2).numpy(),
                       f"fold {variant} vs classic, N=4000")


@pytest.mark.parametrize("variant", ["vpu", "vpu2"])
def test_fold_chunked_offsets_are_bit_equal(variant):
    """Folding the superblock offsets chunk by chunk keeps the reduction
    order, so the result is bit-equal to one chunk."""
    pos, _, mass = make_small_system(2500, seed=153)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    whole = FOLD[variant](p, m, EPS2, block_u=512)
    n_pad = 5 * 512
    for k in (1, 2):
        np.testing.assert_array_equal(
            FOLD[variant](p, m, EPS2, block_u=512,
                          slot_budget=k * 24 * n_pad).numpy(),
            whole.numpy())


@pytest.mark.parametrize("variant", ["vpu", "vpu2"])
def test_fold_real_massless_bodies_are_correct(variant):
    """K7's fold needs no recompute; K2's recomputes a massless row
    one-sided, as classic K2 does.  Either way each row matches the
    oracle at the exact tolerance."""
    pos, _, mass = make_small_system(1300, seed=154)
    zero = [1, 600, 1299]
    mass[zero] = 0.0
    acc = FOLD[variant](torch.from_numpy(pos), torch.from_numpy(mass), EPS2,
                        block_u=512).numpy()
    assert_close_exact(acc, oracle_forces(pos, mass, EPS2),
                       f"fold {variant} with massless bodies vs oracle")
    assert np.abs(acc[zero]).min() > 0


@pytest.mark.parametrize("variant", ["vpu", "vpu2"])
def test_fold_wrapper_contract(variant):
    pos, _, mass = make_small_system(300, seed=155)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    wrapper = FOLD[variant]
    before = wrapper.launches
    plain = (forces_sym.forces_sym_vpu_plain if variant == "vpu"
             else forces_sym.forces_sym_plain)
    np.testing.assert_array_equal(wrapper(p, m, EPS2).numpy(),
                                  plain(p, m, EPS2, block_u=1024).numpy())
    assert wrapper.launches == before
    with pytest.raises(ValueError, match="float32"):
        wrapper(p.double(), m.double(), EPS2)
    with pytest.raises(ValueError, match="no kernel"):
        wrapper(p.to("meta"), m.to("meta"), EPS2)
    for bad in (384, 0, 256 * (forces_sym.FOLD_SUB_MAX + 1)):
        with pytest.raises(ValueError, match="block_u"):
            wrapper(p, m, EPS2, block_u=bad)
