"""K1 (the one-sided exact tile) of the PyTorch port against the JAX
package's ``forces_pallas(variant="vpu")`` and the float64 oracle, and
the twin's decomposition into j tiles and slices (``k1_slices``).

On the CPU the port's wrapper runs the kernel's plain PyTorch twin (the
CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it
against the same twin); the JAX side runs Pallas in interpret mode, as
its own suite does.

Tolerances: against JAX, every component within ``rel 1e-4`` plus an
absolute floor of ``1e-6 * max|a|`` (both are float32 exact tiers that
sum in different orders); against the oracle, the 1% gate.  The slice
count changes the twin's sums at rounding only (rel 1e-5 + 1e-7·max|a|),
and on a long rect sweep the tile partials take it no further from a
float64 sum than the single running sum of K1's earlier kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_small_system
from nbody_tpu.ops.forces_pallas import forces_pallas, rect_forces_pallas
from nbody_tpu.oracle.numpy_oracle import (assert_matches_oracle,
                                           oracle_forces, relative_mismatch)
from nbody_tpu_torch.ops.forces_tiled import (K1_BLOCK_ROWS, K1_ITEMS,
                                              K1_TILE, forces_tiled,
                                              k1_slices, rect_forces_tiled,
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


@pytest.mark.parametrize("slices", [None, 1, 2, 5])
def test_k1_ragged_rect_slices_match_jax_rect(slices):
    """A 256 x 1500 rect sweep (a ragged last j tile) in the wrapper's
    slices (one tile each at this size) and in 1, 2 and 5 slices of
    several tiles against JAX's rect form, whose j set is padded to whole
    256-body blocks with zero-mass bodies at the origin (they add 0)."""
    pos_i, _, _ = make_small_system(256, seed=55)
    pos_j, _, mass_j = make_small_system(1500, seed=56)
    args = (torch.from_numpy(pos_i), torch.from_numpy(pos_j),
            torch.from_numpy(mass_j), EPS2)
    acc = (rect_forces_tiled(*args) if slices is None
           else rect_forces_tiled_plain(*args, slices=slices)).numpy()
    pad = 1536 - 1500
    ref = np.asarray(rect_forces_pallas(
        jnp.asarray(pos_i), jnp.asarray(np.pad(pos_j, ((0, pad), (0, 0)))),
        jnp.asarray(np.pad(mass_j, (0, pad))), EPS2, block_i=128,
        block_j=256, variant="vpu"))
    assert_close_exact(acc, ref, f"K1 rect twin, {slices} slices, vs JAX")


@pytest.mark.parametrize("ni,nj", [(8192, 8192), (1 << 18, 1 << 18),
                                   (1 << 20, 1 << 20), (700, 700),
                                   (256, 1500), (3000, 129)])
def test_k1_slices_cover_every_tile_once(ni, nj):
    """The slices split the j tiles evenly and in order, none empty; at
    most one a tile; enough work items to fill an H100 where the j tiles
    allow (N = 8192: 16 row blocks x 64 one-tile slices; the 262,144²
    ring sweep: 512 x 4; N = 1M: the row blocks alone)."""
    tiles = -(-nj // K1_TILE)
    slices, tps = k1_slices(ni, nj)
    assert 1 <= slices <= tiles and (slices - 1) * tps < tiles <= slices * tps
    items = -(-ni // K1_BLOCK_ROWS) * slices
    assert items >= K1_ITEMS or slices == tiles or slices == 1
    want = {(8192, 8192): (64, 1), (1 << 18, 1 << 18): (4, 512),
            (1 << 20, 1 << 20): (1, 8192)}
    assert want.get((ni, nj), (slices, tps)) == (slices, tps)
    for asked in (1, 2, 3, tiles, 10 * tiles):
        s, t = k1_slices(ni, nj, asked)
        assert s <= min(asked, tiles) and (s - 1) * t < tiles <= s * t


def test_k1_twin_slice_count_changes_rounding_only():
    """N = 1280 (10 j tiles) in 1 to 10 slices: the same sums up to
    float32 rounding, and the wrapper's count is one of them."""
    pos, _, mass = make_small_system(1280, seed=57)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    base = rect_forces_tiled_plain(p, p, m, EPS2, slices=1).numpy()
    outs = {s: rect_forces_tiled_plain(p, p, m, EPS2, slices=s).numpy()
            for s in range(1, 11)}
    for s, got in outs.items():
        bad = relative_mismatch(got, base, 1e-5, 1e-7 * np.abs(base).max())
        assert bad.sum() == 0, f"{s} slices vs one: {int(bad.sum())} off"
    assert len({o.tobytes() for o in outs.values()}) > 1
    np.testing.assert_array_equal(forces_tiled(p, m, EPS2).numpy(),
                                  outs[k1_slices(1280, 1280)[0]])


def test_k1_tile_partials_beat_a_running_sum_on_a_long_sweep():
    """64 rows against 65,536 bodies: the twin's tile and slice partials
    are no further from a float64 sum than one float32 running sum of the
    same float32 terms over all 65,536 columns (K1's earlier kernel)."""
    pos_i, _, _ = make_small_system(64, seed=58)
    pos_j, _, mass_j = make_small_system(1 << 16, seed=59)
    twin = rect_forces_tiled_plain(torch.from_numpy(pos_i),
                                   torch.from_numpy(pos_j),
                                   torch.from_numpy(mass_j), EPS2).numpy()
    r = pos_j[None, :, :] - pos_i[:, None, :]                # float32
    d2 = (r * r).sum(-1) + np.float32(EPS2)
    f = mass_j[None, :] / np.sqrt(d2 * d2 * d2)
    running = np.add.accumulate(f[:, :, None] * r, axis=1)[:, -1]
    assert running.dtype == np.float32
    r64 = pos_j[None, :, :].astype(np.float64) - pos_i[:, None, :]
    d64 = (r64 * r64).sum(-1) + EPS2
    ref = ((mass_j[None, :] / np.sqrt(d64 ** 3))[:, :, None] * r64).sum(1)
    err_twin = np.abs(twin - ref).sum()
    err_run = np.abs(running - ref).sum()
    assert err_twin <= err_run, (err_twin, err_run)


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
