"""K12 (``pallas_fast``: centred distances from a K=18 bf16 cross product,
hi/lo bf16 accumulation) of the PyTorch port against the JAX package's
``forces_pallas(variant="fast")`` and the float64 oracle, on Morton-sorted
bodies, and through ``run_steps`` and the CLI.

On the CPU the wrapper runs the kernel's plain twin (128-wide j-tiles,
each with its own centroid, the same packs and roundings); the JAX side
runs Pallas in interpret mode at ``block_j=128``, so the two centre on the
same tiles.

Tolerances.  Against the oracle, the JAX test's gate
(``tests/test_pallas.py::test_pallas_fast_matches_oracle_sorted``): at
most 1e-3 of components outside the 1% gate.  Against JAX: every
component within rel 5e-3 + 1e-4·max|a|.  Each side carries the tier's
own error, the float32 cancellation of the centred expansion
``|u|^2 - 2 u.v + |v|^2`` (p99 ~6e-4 against the oracle on these inputs,
single components up to ~2e-3), and the two make it with other float32
summation orders (the cross product, the centroid), so the errors do not
cancel between them: measured up to 1.6e-3 of a component's value.

One deliberate difference: a pair whose centred d2 falls below 2^-11 of
``|u|^2 + eps2 + |v|^2`` takes the direct distance in the port (the JAX
kernel's force for such a pair can be ~1e7 times too large, ROADMAP
Queue 3).  No pair of the parity inputs is that close.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu import SimState as JaxSimState
from nbody_tpu import run_steps as jax_run_steps
from nbody_tpu.models.ordering import morton_permutation
from nbody_tpu.models.state import state_to_numpy as jax_state_to_numpy
from nbody_tpu.ops.forces_pallas import (_pack_u18, _pack_v18, forces_pallas,
                                         rect_forces_pallas)
from nbody_tpu.oracle.numpy_oracle import (assert_matches_oracle,
                                           oracle_forces, oracle_run,
                                           relative_mismatch)
from nbody_tpu_torch import cli
from nbody_tpu_torch.ops import forces_fast as k12
from nbody_tpu_torch.ops.forces_fast import (CLOSE_PAIR_SCALE, FAST_TILE_J,
                                             close_pairs, forces_fast,
                                             j_splits, pack_u18, pack_v18,
                                             rect_forces_fast,
                                             rect_forces_fast_plain)

EPS2 = 0.002


def sorted_system(n, seed):
    pos, vel, mass = make_small_system(n, seed=seed)
    perm = np.asarray(morton_permutation(jnp.asarray(pos), -1e5, 1e5))
    return pos[perm], vel[perm], mass[perm]


def assert_close_fast(got, want, what):
    bad = relative_mismatch(got, want, 5e-3, 1e-4 * np.abs(want).max())
    assert bad.sum() == 0, (
        f"{what}: {int(bad.sum())}/{bad.size} components differ; max "
        f"rel {np.abs(got - want).max() / np.abs(want).max():.3e}")


@pytest.mark.parametrize("n", [512, 1000])
def test_k12_twin_matches_jax_and_oracle_sorted(n):
    pos, _, mass = sorted_system(n, seed=121)
    acc = forces_fast(torch.from_numpy(pos), torch.from_numpy(mass),
                      EPS2).numpy()
    ref_jax = np.asarray(forces_pallas(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=256,
        block_j=FAST_TILE_J, variant="fast"))
    assert_close_fast(acc, ref_jax, f"K12 twin vs JAX fast, N={n}")
    assert_matches_oracle(acc, oracle_forces(pos, mass, EPS2),
                          f"K12 twin vs oracle, N={n}", max_frac_bad=1e-3)


@pytest.mark.parametrize("n", [300, 700])
def test_k12_self_mask_on_diagonal_tiles_matches_jax(n):
    """The twin masks the self-pair only on the j-tiles that overlap the
    i-set, as the kernel masks it only on the tile that holds a warp's
    diagonal; JAX masks by index on every tile.  N is no multiple of 64
    or 128, so the last row block and the last j-tile are ragged."""
    pos, _, mass = sorted_system(n, seed=128)
    acc = forces_fast(torch.from_numpy(pos), torch.from_numpy(mass),
                      EPS2).numpy()
    ref_jax = np.asarray(forces_pallas(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=256,
        block_j=FAST_TILE_J, variant="fast"))
    assert_close_fast(acc, ref_jax, f"K12 twin vs JAX fast, N={n}")
    assert np.isfinite(acc).all()


@pytest.mark.parametrize("seed", [129, 130])
def test_k12_close_pair_thresholds_are_the_scaled_sum(seed):
    """The row's threshold CLOSE_PAIR_SCALE (|u|^2 + eps2) plus the
    column's CLOSE_PAIR_SCALE |v|^2 is CLOSE_PAIR_SCALE (|u|^2 + eps2 +
    |v|^2) to the bit (a power of two commutes with rounding), so the test
    the kernel makes with one add and one compare is the earlier test;
    with planted near pairs some of them fall under it."""
    pos, _, mass = sorted_system(512, seed=seed)
    pos[1] = pos[0] + np.float32([40.0, -30.0, 10.0])
    pos[300] = pos[299] + np.float32([200.0, 100.0, -50.0])
    p = torch.from_numpy(pos)
    xj = p[256:384]
    c = xj.mean(0)
    u, v = p - c, xj - c
    un2e = (u * u).sum(1)[:, None] + EPS2
    vn2 = (v * v).sum(1)[None, :]
    split = un2e * CLOSE_PAIR_SCALE + vn2 * CLOSE_PAIR_SCALE
    assert torch.equal(split, (un2e + vn2) * CLOSE_PAIR_SCALE)
    close = close_pairs(p, p, torch.from_numpy(mass), EPS2)
    assert close[0, 1] and close[1, 0]
    assert 0 < int(close.sum()) < close.numel() // 100


@pytest.mark.parametrize("ni,nj,want", [
    (8192, 8192, (8, 8)),            # 32 row blocks: 8 ranges of 8 tiles
    (1 << 20, 1 << 20, (1, 8192)),   # 4096 row blocks fill the card
    (256, 100, (1, 1)),              # one ragged tile
    (300, 0, (1, 1)),                # an empty j-set: one ghost tile
    (1000, 3000, (24, 1)),           # 4 row blocks: a range a tile
])
def test_k12_j_splits_cover_every_tile_once(ni, nj, want):
    splits, per = j_splits(ni, nj)
    assert (splits, per) == want
    tiles = max(1, -(-nj // FAST_TILE_J))
    assert (splits - 1) * per < tiles <= splits * per


@pytest.mark.parametrize("target", [1, 8, 264])
def test_k12_j_split_combine_matches_jax(target, monkeypatch):
    """The partial sums of each j range, added in range order: one range
    (target 1), ranges of two tiles (8) and a range a tile (264) at N=700
    (3 row blocks, 6 j-tiles), each against JAX, and the three within
    float32 summation order of each other."""
    pos, _, mass = sorted_system(700, seed=131)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    monkeypatch.setattr(k12, "FAST_TARGET_BLOCKS", target)
    assert j_splits(700, 700) == {1: (1, 6), 8: (3, 2), 264: (6, 1)}[target]
    acc = forces_fast(p, m, EPS2).numpy()
    ref_jax = np.asarray(forces_pallas(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=256,
        block_j=FAST_TILE_J, variant="fast"))
    assert_close_fast(acc, ref_jax, f"K12 twin, target {target}, vs JAX")
    monkeypatch.setattr(k12, "FAST_TARGET_BLOCKS", 1)
    whole = forces_fast(p, m, EPS2).numpy()
    np.testing.assert_allclose(acc, whole, rtol=1e-5,
                               atol=1e-6 * np.abs(whole).max())


def test_k12_close_pair_takes_the_direct_distance():
    """A pair closer than the centred expansion's float32 error (about
    2^-21 (|u|^2 + |v|^2), here ~5e3 against a true d2 of 14) takes the
    direct |x_j - x_i|^2 in the port, so the two rows are as right as the
    mxu tier's (K10), whose hi/lo accumulation K12 shares (its own error
    for so close a pair is ~8%, |x|/|r| times 2^-17).  The JAX kernel
    keeps the centred value, and its force there is ~6e5 times too large
    (ROADMAP Queue 3: the fault that makes uniform-box runs blow up); the
    port does not copy it."""
    pos, _, mass = sorted_system(256, seed=127)
    pos[1] = pos[0] + np.float32([3.0, -2.0, 1.0])
    ref = oracle_forces(pos, mass, EPS2)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    close = close_pairs(p, p, m, EPS2)
    assert close.shape == (256, 256) and close[0, 1] and close[1, 0]
    acc = forces_fast(p, m, EPS2).numpy()

    def row_err(variant):
        a = np.asarray(forces_pallas(
            jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=256,
            block_j=FAST_TILE_J, variant=variant)) if variant else acc
        return (np.linalg.norm(a[:2] - ref[:2], axis=1)
                / np.linalg.norm(ref[:2], axis=1))

    mxu = row_err("mxu")
    assert (row_err(None) <= 1.05 * mxu).all(), (row_err(None), mxu)
    assert (row_err("fast") > 100 * mxu).all()
    assert_matches_oracle(acc[2:], ref[2:], "K12 twin, the other rows",
                          max_frac_bad=1e-3)


@pytest.mark.parametrize("self_tile", [True, False])
def test_k12_rect_matches_jax_rect(self_tile):
    """With ``self_tile`` the i-set is a prefix of the j-set and its
    self-pairs are masked; without, the sets are disjoint."""
    pos_j, _, mass_j = sorted_system(512, seed=122)
    pos_i = (pos_j[:256].copy() if self_tile
             else sorted_system(256, seed=123)[0])
    acc = rect_forces_fast(torch.from_numpy(pos_i), torch.from_numpy(pos_j),
                           torch.from_numpy(mass_j), EPS2,
                           self_tile=self_tile).numpy()
    ref = np.asarray(rect_forces_pallas(
        jnp.asarray(pos_i), jnp.asarray(pos_j), jnp.asarray(mass_j), EPS2,
        block_i=128, block_j=FAST_TILE_J, variant="fast",
        self_tile=self_tile))
    assert_close_fast(acc, ref, f"K12 rect twin vs JAX, "
                                f"self_tile={self_tile}")
    assert np.isfinite(acc).all()


def test_k18_packs_are_the_jax_packs():
    rng = np.random.default_rng(124)
    u = rng.uniform(-3e4, 3e4, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        pack_u18(torch.from_numpy(u)).numpy(),
        np.asarray(_pack_u18(jnp.asarray(u)), np.float32))
    np.testing.assert_array_equal(
        pack_v18(torch.from_numpy(u)).numpy(),
        np.asarray(_pack_v18(jnp.asarray(u)), np.float32))


def test_k12_wrapper_contract():
    pos, _, mass = sorted_system(300, seed=125)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    before = forces_fast.launches
    np.testing.assert_array_equal(
        forces_fast(p, m, EPS2).numpy(),
        rect_forces_fast_plain(p, p, m, EPS2, True).numpy())
    assert forces_fast.launches == before
    with pytest.raises(ValueError, match="float32"):
        forces_fast(p.double(), m.double(), EPS2)
    with pytest.raises(ValueError, match="no kernel"):
        forces_fast(p.to("meta"), m.to("meta"), EPS2)
    with pytest.raises(ValueError, match="prefix"):
        rect_forces_fast(p, p[:100].contiguous(), m[:100].contiguous(), EPS2,
                         self_tile=True)


def test_run_steps_matches_jax_and_oracle_sorted():
    """Three reference steps at N=512 from Morton-sorted bodies, against
    JAX ``run_steps`` at the same j-tile (the 1% gate with the slice
    tests' absolute floors) and against the oracle (the tier's 1e-3)."""
    n, steps = 512, 3
    pos, vel, mass = sorted_system(n, seed=126)
    jax_cfg = JaxSimConfig(n_bodies=n, impl="pallas_fast", block_i=128,
                           block_j=FAST_TILE_J, resident=False)
    jax_out = jax_state_to_numpy(jax_run_steps(
        JaxSimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                    acc=jnp.zeros((n, 3), jnp.float32),
                    mass=jnp.asarray(mass)), jax_cfg, steps))
    cfg = nt.SimConfig(n_bodies=n, impl="pallas_fast", device="cpu")
    state = nt.state_from_numpy(
        {"pos": pos, "vel": vel, "acc": np.zeros_like(pos), "mass": mass},
        device="cpu")
    out = nt.state_to_numpy(nt.run_steps(state, cfg, steps))
    rpos, rvel, _ = oracle_run(pos, vel, mass, EPS2, cfg.dt, steps)
    for k, abs_tol, ref in (("pos", 1.0, rpos), ("vel", 1e-2, rvel)):
        assert_matches_oracle(out[k], jax_out[k], f"{k} vs JAX",
                              abs_tol=abs_tol)
        assert_matches_oracle(out[k], ref, f"{k} vs oracle", abs_tol=abs_tol,
                              max_frac_bad=1e-3)


def test_cli_validate_and_bench_on_cpu(capsys):
    common = ["--impl", "pallas_fast", "--device", "cpu"]
    rc = cli.main(["validate", "--n", "300", "--long-steps", "0",
                   "--max-bad-frac", "1e-3", "--max-bad-frac-acc", "1e-3",
                   *common])
    out = capsys.readouterr().out
    assert rc == 0 and "Verification PASSED" in out, out
    assert "impl=pallas_fast" in out
    assert cli.main(["bench", "--n", "300", "--steps", "2", *common]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["impl"] == "pallas_fast" and res["finite"]
