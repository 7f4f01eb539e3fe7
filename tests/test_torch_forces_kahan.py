"""K11 (``pallas_kahan``, the exact one-sided tile with Kahan-compensated
accumulation across j-tiles) of the PyTorch port against the JAX
package's ``forces_pallas(variant="vpu_kahan")`` and the float64 oracle,
and through ``run_steps`` and the CLI.

On the CPU the wrapper runs the kernel's plain twin: K1's 128-wide
j-tiles and slices, each tile's sum Kahan-added into its slice's (s, c),
the slices merged by an exact two-sum with the compensations carried and
folded in once.  The JAX side runs Pallas in interpret mode at
``block_j=128``, so both compensate across the same tiles.  Tolerances:
the exact tier's rel 1e-4 + 1e-6·max|a| against JAX, the oracle's 1%
gate, and, as the JAX package's own test asks
(``tests/test_pallas.py::test_pallas_kahan_matches_oracle``), a largest
error against the oracle no worse than 1.5 times K1's.  Against one
sweep's two-sum over the same tiles (``single_sweep`` below, JAX's
order), the sliced twin is held no less accurate to within half a unit
in the last place a component: the two round their last addition
differently.
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
from nbody_tpu.models.state import state_to_numpy as jax_state_to_numpy
from nbody_tpu.ops.forces_pallas import forces_pallas, rect_forces_pallas
from nbody_tpu.oracle.numpy_oracle import (assert_matches_oracle,
                                           oracle_forces, oracle_run,
                                           relative_mismatch)
from nbody_tpu_torch import cli
from nbody_tpu_torch.ops.forces_tiled import (K1_TILE, forces_tiled,
                                              forces_tiled_kahan, k1_slices,
                                              kahan_add,
                                              rect_forces_tiled_kahan,
                                              rect_forces_tiled_plain,
                                              two_sum)

EPS2 = 0.002


def assert_close_exact(got, want, what):
    bad = relative_mismatch(got, want, 1e-4, 1e-6 * np.abs(want).max())
    assert bad.sum() == 0, (
        f"{what}: {int(bad.sum())}/{bad.size} components differ; max "
        f"rel {np.abs(got - want).max() / np.abs(want).max():.3e}")


@pytest.mark.parametrize("n", [700, 1024])
def test_k11_twin_matches_jax_and_oracle(n):
    pos, _, mass = make_small_system(n, seed=111)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    acc = forces_tiled_kahan(p, m, EPS2).numpy()
    ref_jax = np.asarray(forces_pallas(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=64,
        block_j=K1_TILE, variant="vpu_kahan"))
    assert_close_exact(acc, ref_jax, f"K11 twin vs JAX vpu_kahan, N={n}")
    ref = oracle_forces(pos, mass, EPS2)
    assert_matches_oracle(acc, ref, f"K11 twin vs oracle, N={n}")
    plain = forces_tiled(p, m, EPS2).numpy()
    assert np.abs(acc - ref).max() <= 1.5 * np.abs(plain - ref).max()


def test_k11_compensation_is_carried():
    """Against a twin with the compensation dropped (plain K1), the
    compensated sum differs: the two-sum is not folded away."""
    pos, _, mass = make_small_system(2048, seed=112)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    kahan = rect_forces_tiled_plain(p, p, m, EPS2, kahan=True)
    assert not torch.equal(kahan, rect_forces_tiled_plain(p, p, m, EPS2))
    ref = oracle_forces(pos, mass, EPS2)
    err_k = np.abs(kahan.numpy() - ref).sum()
    err_p = np.abs(forces_tiled(p, m, EPS2).numpy() - ref).sum()
    assert err_k <= err_p


def tile_sums(pos_i, pos_j, mass_j):
    """The twin's float32 contributions of each K1_TILE-body j tile."""
    p_i, p_j, m_j = (torch.from_numpy(x) for x in (pos_i, pos_j, mass_j))
    return [rect_forces_tiled_plain(p_i, p_j[k:k + K1_TILE],
                                    m_j[k:k + K1_TILE], EPS2)
            for k in range(0, p_j.shape[0], K1_TILE)]


def single_sweep(tiles):
    """One sweep's Kahan two-sum over the tiles, in tile order (JAX's
    ``_force_kernel_vpu_kahan``): the reference the slices are held to."""
    s = c = torch.zeros_like(tiles[0])
    for t in tiles:
        s, c = kahan_add(s, c, t)
    return s


@pytest.mark.parametrize("slices", [1, 2, "tile"])
def test_k11_slices_match_jax_and_are_no_less_accurate(slices):
    """The twin in one slice, two, and one a tile (12 tiles) against JAX,
    and against float64 no less accurate than K1's twin in the same
    slices and, to within half an ulp a component, than one sweep."""
    pos, _, mass = make_small_system(1500, seed=117)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    tiles = -(-1500 // K1_TILE)
    n = tiles if slices == "tile" else slices
    assert k1_slices(1500, 1500, n, kahan=True) == (n, -(-tiles // n))
    acc = rect_forces_tiled_plain(p, p, m, EPS2, kahan=True,
                                  slices=n).numpy()
    ref_jax = np.asarray(forces_pallas(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=64,
        block_j=K1_TILE, variant="vpu_kahan"))
    assert_close_exact(acc, ref_jax, f"K11 twin in {n} slices vs JAX")
    ref = oracle_forces(pos, mass, EPS2)
    err = np.abs(acc - ref).sum()
    k1 = rect_forces_tiled_plain(p, p, m, EPS2, slices=n).numpy()
    assert err <= np.abs(k1 - ref).sum()
    one = single_sweep(tile_sums(pos, pos, mass)).numpy()
    half_ulp = 0.5 * np.spacing(np.abs(one)).astype(np.float64).sum()
    assert err <= np.abs(one - ref).sum() + half_ulp
    if n == 1:
        np.testing.assert_array_equal(acc, one)


def test_k11_one_tile_slices_carry_the_compensation():
    """At N = 2048 the plan is 16 slices of one tile: no slice has a
    compensation of its own, and the merge's carried error is all that
    sets K11 apart from K1's plain sum of the same slots.  The result is
    not K1's, is closer to the exact sum of the tiles than K1's, and at
    least as close as one sweep's two-sum."""
    pos, _, mass = make_small_system(2048, seed=118)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    assert k1_slices(2048, 2048, kahan=True) == (16, 1)
    kahan = forces_tiled_kahan(p, m, EPS2)
    plain = forces_tiled(p, m, EPS2)
    assert not torch.equal(kahan, plain)
    tiles = tile_sums(pos, pos, mass)
    exact = sum(t.double() for t in tiles)
    err = (kahan.double() - exact).abs().sum()
    assert err < (plain.double() - exact).abs().sum()
    assert err <= (single_sweep(tiles).double() - exact).abs().sum()


def test_two_sum_is_exact():
    """The merge's two-sum: a + b = s + e exactly, for operands of any
    relative size and sign."""
    rng = np.random.default_rng(119)
    a = (rng.standard_normal(4096)
         * 10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    b = (rng.standard_normal(4096)
         * 10.0 ** rng.integers(-8, 8, 4096)).astype(np.float32)
    s, e = two_sum(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(a.astype(np.float64) + b.astype(np.float64),
                                  s.double().numpy() + e.double().numpy())


def test_k11_slice_plan():
    """K11 takes K1's plan (16 row blocks x 64 slices of one tile at
    N = 8192, 512 x 4 on the 1M ring's 262,144-body sweep, one slice at
    1M) within a slot budget of a sum and a compensation a slot."""
    for n in (2048, 8192, 1 << 18, 1 << 20):
        assert k1_slices(n, n, kahan=True) == k1_slices(n, n)
    assert k1_slices(8192, 8192, kahan=True) == (64, 1)
    assert k1_slices(1 << 18, 1 << 18, kahan=True) == (4, 512)
    assert k1_slices(1 << 20, 1 << 20, kahan=True) == (1, 8192)
    assert k1_slices(8192, 1 << 25, kahan=True) == (128, 2048)


def test_k11_rect_matches_jax_rect():
    """The rect form the ring uses (``parallel/ring.py``): an i-set
    against a different j-set."""
    pos_i, _, _ = make_small_system(256, seed=113)
    pos_j, _, mass_j = make_small_system(512, seed=114)
    acc = rect_forces_tiled_kahan(torch.from_numpy(pos_i),
                                  torch.from_numpy(pos_j),
                                  torch.from_numpy(mass_j), EPS2).numpy()
    ref = np.asarray(rect_forces_pallas(
        jnp.asarray(pos_i), jnp.asarray(pos_j), jnp.asarray(mass_j), EPS2,
        block_i=128, block_j=K1_TILE, variant="vpu_kahan"))
    assert_close_exact(acc, ref, "K11 rect twin vs JAX rect")


@pytest.mark.parametrize("slices", [1, 3, "tile"])
def test_k11_rect_slices_match_jax_rect(slices):
    """The ring's form on ragged sets (300 x 1500 bodies, 12 j tiles) in
    one slice, three, and one a tile, against JAX's rect vpu_kahan, which
    takes whole blocks: it gets the sets padded with massless bodies at
    the origin, as the twin pads the last tile."""
    pos_i, _, _ = make_small_system(300, seed=120)
    pos_j, _, mass_j = make_small_system(1500, seed=121)
    n = -(-1500 // K1_TILE) if slices == "tile" else slices
    acc = rect_forces_tiled_plain(torch.from_numpy(pos_i),
                                  torch.from_numpy(pos_j),
                                  torch.from_numpy(mass_j), EPS2, kahan=True,
                                  slices=n).numpy()
    pad_i, pad_j = 384 - 300, 1536 - 1500
    ref = np.asarray(rect_forces_pallas(
        jnp.asarray(np.concatenate([pos_i, np.zeros((pad_i, 3), np.float32)])),
        jnp.asarray(np.concatenate([pos_j, np.zeros((pad_j, 3), np.float32)])),
        jnp.asarray(np.concatenate([mass_j, np.zeros(pad_j, np.float32)])),
        EPS2, block_i=128, block_j=K1_TILE, variant="vpu_kahan"))[:300]
    assert_close_exact(acc, ref, f"K11 rect twin in {n} slices vs JAX rect")


def test_k11_wrapper_contract():
    pos, _, mass = make_small_system(300, seed=115)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    before = (forces_tiled.launches, forces_tiled_kahan.launches)
    np.testing.assert_array_equal(
        forces_tiled_kahan(p, m, EPS2).numpy(),
        rect_forces_tiled_plain(p, p, m, EPS2, kahan=True).numpy())
    assert (forces_tiled.launches, forces_tiled_kahan.launches) == before
    with pytest.raises(ValueError, match="float32"):
        forces_tiled_kahan(p.double(), m.double(), EPS2)
    with pytest.raises(ValueError, match="no kernel"):
        forces_tiled_kahan(p.to("meta"), m.to("meta"), EPS2)
    with pytest.raises(ValueError, match="pos_i"):
        rect_forces_tiled_kahan(p.double(), p, m, EPS2)


def test_run_steps_matches_jax_and_oracle():
    n, steps = 512, 3
    pos, vel, mass = make_small_system(n, seed=116)
    jax_cfg = JaxSimConfig(n_bodies=n, impl="pallas_kahan", block_i=128,
                           block_j=K1_TILE, resident=False)
    jax_out = jax_state_to_numpy(jax_run_steps(
        JaxSimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                    acc=jnp.zeros((n, 3), jnp.float32),
                    mass=jnp.asarray(mass)), jax_cfg, steps))
    cfg = nt.SimConfig(n_bodies=n, impl="pallas_kahan", device="cpu")
    state = nt.state_from_numpy(
        {"pos": pos, "vel": vel, "acc": np.zeros_like(pos), "mass": mass},
        device="cpu")
    out = nt.state_to_numpy(nt.run_steps(state, cfg, steps))
    rpos, rvel, _ = oracle_run(pos, vel, mass, EPS2, cfg.dt, steps)
    for k, abs_tol, ref in (("pos", 1.0, rpos), ("vel", 1e-2, rvel)):
        assert_matches_oracle(out[k], jax_out[k], f"{k} vs JAX",
                              abs_tol=abs_tol)
        assert_matches_oracle(out[k], ref, f"{k} vs oracle", abs_tol=abs_tol)


def test_cli_validate_run_bench_on_cpu(tmp_path, capsys):
    common = ["--impl", "pallas_kahan", "--device", "cpu"]
    rc = cli.main(["validate", "--n", "300", "--long-steps", "0", *common])
    out = capsys.readouterr().out
    assert rc == 0 and "Verification PASSED" in out, out
    assert "impl=pallas_kahan" in out
    assert cli.main(["run", "--n", "300", "--steps", "3", "--quiet",
                     *common]) == 0
    capsys.readouterr()
    assert cli.main(["bench", "--n", "300", "--steps", "2", *common]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["impl"] == "pallas_kahan" and res["finite"]
