"""K9 / K10 (the one-sided tensor-core tiers ``turbo`` and ``mxu``) of the
PyTorch port against the JAX package's ``forces_pallas(variant=...)`` and
the float64 oracle, the twin's slices (``tc_slices``) and self-pair mask,
and the tiers through ``run_steps`` and the CLI.

On the CPU the wrappers run the kernels' plain twins (the same j-tiles,
slices, trimmed geometry, bf16 roundings and per-tile correction); the JAX
side runs Pallas in interpret mode at ``block_j = TC_TILE_J``, so both
apply the cancelling correction ``sum f x_j - x_i sum f`` over the same
tiles.

Tolerances.  Against JAX: every component within rel 1e-3 + 1e-4·max|a|.
The two round nearly the same bf16 weights (the twin's d2 is fused, JAX's
is not, which flips a rare bf16 rounding by an ulp, ~0.4% of one pair);
what differs beside that is the float32 grouping inside the correction,
whose terms are ~|x|·sum f against a net of ~|r|·sum f, measured at up to
4.4e-5·max|a| on these inputs, and the slices' partial sums.  Against
the oracle, the JAX tests' own tier gates: mxu at most 1e-3 of components
outside the 1% gate (``tests/test_pallas.py``); turbo, on unsorted bodies
(the port has no Morton sort yet), p99 < 5e-2 and a bad fraction < 0.1.
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
from nbody_tpu.ops.forces_pallas_sym import _mass_folded_pack, _pack8
from nbody_tpu.oracle.numpy_oracle import (assert_matches_oracle,
                                           oracle_forces, oracle_run,
                                           relative_mismatch)
from nbody_tpu_torch import cli
from nbody_tpu_torch.ops import forces_sym_tc
from nbody_tpu_torch.ops.forces_tiled_tc import (
    TC_BLOCK_ROWS, TC_ITEMS, TC_TILE_J, forces_tiled_mxu, forces_tiled_tc,
    forces_tiled_turbo, mass_folded_pack, pair_inv_fma, position_pack,
    rect_forces_tiled_tc, rect_forces_tiled_tc_plain, tc_slices,
    tile_result, weight_limbs)

EPS2 = 0.002
IMPLS = {"turbo": "pallas_turbo", "mxu": "pallas_mxu"}
WRAPPERS = {"turbo": forces_tiled_turbo, "mxu": forces_tiled_mxu}


def assert_close_tier(got, want, what):
    bad = relative_mismatch(got, want, 1e-3, 1e-4 * np.abs(want).max())
    assert bad.sum() == 0, (
        f"{what}: {int(bad.sum())}/{bad.size} components differ; max "
        f"rel {np.abs(got - want).max() / np.abs(want).max():.3e}")


def assert_tier_gate(acc, ref, variant, what):
    if variant == "mxu":
        assert_matches_oracle(acc, ref, what, max_frac_bad=1e-3)
        return
    err = np.abs(acc - ref) / (np.abs(ref) + 1e-30)
    assert np.percentile(err, 99) < 5e-2, what
    assert relative_mismatch(acc, ref, 0.01, 1e-4).mean() < 0.1, what


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
@pytest.mark.parametrize("n", [512, 1000])
def test_k9_k10_twin_matches_jax_and_oracle(variant, n):
    pos, _, mass = make_small_system(n, seed=71)
    acc = forces_tiled_tc(torch.from_numpy(pos), torch.from_numpy(mass),
                          EPS2, variant).numpy()
    ref_jax = np.asarray(forces_pallas(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=256,
        block_j=TC_TILE_J, variant=variant))
    assert_close_tier(acc, ref_jax, f"K9/K10 {variant} twin vs JAX, N={n}")
    assert_tier_gate(acc, oracle_forces(pos, mass, EPS2), variant,
                     f"{variant} twin vs oracle, N={n}")


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
@pytest.mark.parametrize("self_tile", [True, False])
def test_k9_k10_rect_matches_jax_rect(variant, self_tile):
    """The rect form: with ``self_tile`` the i-set is a prefix of the
    j-set and its self-pairs are masked; without, the sets are disjoint
    and nothing is masked."""
    pos_j, _, mass_j = make_small_system(512, seed=72)
    pos_i = (pos_j[:256].copy() if self_tile
             else make_small_system(256, seed=73)[0])
    acc = rect_forces_tiled_tc(torch.from_numpy(pos_i),
                               torch.from_numpy(pos_j),
                               torch.from_numpy(mass_j), EPS2, variant,
                               self_tile=self_tile).numpy()
    ref = np.asarray(rect_forces_pallas(
        jnp.asarray(pos_i), jnp.asarray(pos_j), jnp.asarray(mass_j), EPS2,
        block_i=128, block_j=TC_TILE_J, variant=variant,
        self_tile=self_tile))
    assert_close_tier(acc, ref, f"{variant} rect twin vs JAX rect, "
                                f"self_tile={self_tile}")


@pytest.mark.parametrize("which", ["position", "mass_folded"])
def test_packs_are_the_jax_packs_interleaved(which):
    """The packs hold the JAX package's bf16 values, hi and lo columns
    interleaved: [x_hi x_lo y_hi y_lo z_hi z_lo | 1 0 or m_hi m_lo]."""
    pos, _, mass = make_small_system(64, seed=74)
    if which == "position":
        got = position_pack(torch.from_numpy(pos)).numpy()
        want = np.asarray(_pack8(jnp.asarray(pos), 64), np.float32)
    else:
        got = mass_folded_pack(torch.from_numpy(pos),
                               torch.from_numpy(mass)).numpy()
        want = np.asarray(_mass_folded_pack(jnp.asarray(pos),
                                            jnp.asarray(mass)[:, None], 64),
                          np.float32)
    np.testing.assert_array_equal(got, want[:, [0, 3, 1, 4, 2, 5, 6, 7]])


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
def test_k9_k10_wrapper_contract(variant):
    pos, _, mass = make_small_system(300, seed=75)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    wrapper = WRAPPERS[variant]
    before = wrapper.launches
    np.testing.assert_array_equal(
        wrapper(p, m, EPS2).numpy(),
        rect_forces_tiled_tc_plain(p, p, m, EPS2, variant, True).numpy())
    assert wrapper.launches == before
    with pytest.raises(ValueError, match="float32"):
        wrapper(p.double(), m.double(), EPS2)
    with pytest.raises(ValueError, match="no kernel"):
        wrapper(p.to("meta"), m.to("meta"), EPS2)
    with pytest.raises(ValueError, match="prefix"):
        rect_forces_tiled_tc(p, p[:100].contiguous(), m[:100].contiguous(),
                             EPS2, variant, self_tile=True)
    with pytest.raises(ValueError, match="variant"):
        forces_tiled_tc(p, m, EPS2, "fast")


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
def test_run_steps_matches_jax_and_oracle(variant):
    """Three reference steps at N=512 through ``run_steps``: against JAX
    ``run_steps`` at the same j-tile, the 1% gate with the slice tests'
    absolute floors; against the oracle, the tier's bad fraction."""
    n, steps, impl = 512, 3, IMPLS[variant]
    pos, vel, mass = make_small_system(n, seed=76)
    jax_cfg = JaxSimConfig(n_bodies=n, impl=impl, block_i=128,
                           block_j=TC_TILE_J, resident=False)
    jax_out = jax_state_to_numpy(jax_run_steps(
        JaxSimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                    acc=jnp.zeros((n, 3), jnp.float32),
                    mass=jnp.asarray(mass)), jax_cfg, steps))
    cfg = nt.SimConfig(n_bodies=n, impl=impl, device="cpu")
    state = nt.state_from_numpy(
        {"pos": pos, "vel": vel, "acc": np.zeros_like(pos), "mass": mass},
        device="cpu")
    out = nt.state_to_numpy(nt.run_steps(state, cfg, steps))
    rpos, rvel, _ = oracle_run(pos, vel, mass, EPS2, cfg.dt, steps)
    frac = 1e-3 if variant == "mxu" else 0.1
    for k, abs_tol, ref in (("pos", 1.0, rpos), ("vel", 1e-2, rvel)):
        assert_matches_oracle(out[k], jax_out[k], f"{k} vs JAX ({impl})",
                              abs_tol=abs_tol)
        assert_matches_oracle(out[k], ref, f"{k} vs oracle ({impl})",
                              abs_tol=abs_tol, max_frac_bad=frac)


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
def test_cli_validate_run_resume_bench_on_cpu(variant, tmp_path, capsys):
    impl = IMPLS[variant]
    frac = "1e-3" if variant == "mxu" else "0.1"
    common = ["--impl", impl, "--device", "cpu"]
    rc = cli.main(["validate", "--n", "300", "--long-steps", "0",
                   "--max-bad-frac", frac, "--max-bad-frac-acc", frac,
                   *common])
    out = capsys.readouterr().out
    assert rc == 0 and "Verification PASSED" in out, out
    assert f"impl={impl}" in out
    a, b, c = (str(tmp_path / f"{x}.npz") for x in "abc")
    assert cli.main(["run", "--n", "300", "--steps", "4", "--checkpoint", a,
                     "--quiet", *common]) == 0
    assert cli.main(["run", "--resume", a, "--steps", "2", "--checkpoint", b,
                     "--quiet", "--device", "cpu"]) == 0
    assert cli.main(["run", "--n", "300", "--steps", "6", "--checkpoint", c,
                     "--quiet", *common]) == 0
    with np.load(b) as zb, np.load(c) as zc:
        assert int(zb["step"]) == int(zc["step"]) == 6
        for k in ("pos", "vel", "acc"):
            np.testing.assert_array_equal(zb[k], zc[k])
    capsys.readouterr()
    assert cli.main(["bench", "--n", "300", "--steps", "2", *common]) == 0
    res = json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    assert res["impl"] == impl and res["finite"] and not res["resident"]


# -- the (row block, j slice) design: slices, the diagonal mask, the
# trimmed geometry

N_SLICED = 700          # six j tiles, the last ragged
SLICES = {"one": 1, "two": 2, "per tile": -(-N_SLICED // TC_TILE_J)}


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
@pytest.mark.parametrize("slices", list(SLICES))
def test_k9_k10_twin_in_slices_matches_jax_and_oracle(variant, slices):
    """The twin in one slice, two and one a tile (N = 700, six j tiles)
    against JAX's ``forces_pallas(block_j=128)`` and the float64 oracle at
    the tier gate."""
    pos, _, mass = make_small_system(N_SLICED, seed=77)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    acc = rect_forces_tiled_tc_plain(p, p, m, EPS2, variant, True,
                                     slices=SLICES[slices]).numpy()
    ref_jax = np.asarray(forces_pallas(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=128,
        block_j=TC_TILE_J, variant=variant))
    assert_close_tier(acc, ref_jax, f"{variant} twin in {slices} slices vs "
                                    f"JAX")
    assert_tier_gate(acc, oracle_forces(pos, mass, EPS2), variant,
                     f"{variant} twin in {slices} slices vs oracle")


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
@pytest.mark.parametrize("self_tile", [True, False])
@pytest.mark.parametrize("slices", [1, 3])
def test_k9_k10_rect_twin_in_slices_matches_jax_rect(variant, self_tile,
                                                     slices):
    """The rect form in one and three slices (256 rows against 768 bodies,
    six j tiles; JAX's rect form takes whole blocks): with ``self_tile``
    the rows are a prefix of the bodies, without they are a set of their
    own; against JAX's ``rect_forces_pallas``."""
    pos_j, _, mass_j = make_small_system(768, seed=78)
    pos_i = (pos_j[:256].copy() if self_tile
             else make_small_system(256, seed=79)[0])
    acc = rect_forces_tiled_tc_plain(
        torch.from_numpy(pos_i), torch.from_numpy(pos_j),
        torch.from_numpy(mass_j), EPS2, variant, self_tile,
        slices=slices).numpy()
    ref = np.asarray(rect_forces_pallas(
        jnp.asarray(pos_i), jnp.asarray(pos_j), jnp.asarray(mass_j), EPS2,
        block_i=128, block_j=TC_TILE_J, variant=variant,
        self_tile=self_tile))
    assert_close_tier(acc, ref, f"{variant} rect twin in {slices} slices, "
                                f"self_tile={self_tile}")


def masked_every_tile(pos_i, pos_j, mass_j, eps2, variant, slices):
    """The twin's sums with the self-pair mask applied to every tile by
    index equality (where the kernel and the twin mask only the tiles
    whose j range meets the rows)."""
    tile, ni, nj = TC_TILE_J, pos_i.shape[0], pos_j.shape[0]
    nj_pad = -(-nj // tile) * tile
    pos_j = torch.cat([pos_j, pos_j.new_zeros(nj_pad - nj, 3)])
    mass_j = torch.cat([mass_j, mass_j.new_zeros(nj_pad - nj)])
    rows = torch.arange(ni)[:, None]
    n_slices, tps = tc_slices(ni, nj, slices)
    acc = None
    for k in range(n_slices):
        part = torch.zeros_like(pos_i)
        for s in range(k * tps * tile, min((k + 1) * tps * tile, nj_pad),
                       tile):
            xj = pos_j[s:s + tile]
            f = mass_j[None, s:s + tile] * pair_inv_fma(pos_i, xj, eps2)
            f = torch.where(rows == torch.arange(s, s + tile)[None, :],
                            torch.zeros_like(f), f)
            pack = position_pack(xj)
            part = part + tile_result(
                sum(w @ pack for w in weight_limbs(f, variant)), pos_i)
        acc = part if acc is None else acc + part
    return acc


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
@pytest.mark.parametrize("case", ["square, two slices",
                                  "rect prefix, one slice a tile",
                                  "square, eps2 = 0"])
def test_k9_k10_diagonal_mask_hits_exactly_the_self_pairs(variant, case):
    """Slice boundaries inside the diagonal (N = 700 in two slices: the
    boundary at body 384; 300 rows of 700 bodies in six slices: at 128 and
    256): the twin, which masks only the tiles that meet the rows, equals
    bit for bit a twin that masks every tile.  At eps2 = 0 a self-pair's
    weight is infinite: the mask is a select, and every row is finite."""
    pos, _, mass = make_small_system(N_SLICED, seed=80)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    pi, slices, eps2 = {
        "square, two slices": (p, 2, EPS2),
        "rect prefix, one slice a tile": (p[:300].contiguous(), 6, EPS2),
        "square, eps2 = 0": (p, 3, 0.0)}[case]
    got = rect_forces_tiled_tc_plain(pi, p, m, eps2, variant, True,
                                     slices=slices)
    assert torch.isfinite(got).all()
    assert torch.equal(got, masked_every_tile(pi, p, m, eps2, variant,
                                              slices))


def test_pair_inv_fma_moved_keeps_its_bits():
    """``pair_inv_fma`` lives in ``ops/forces_tiled_tc.py`` now; the
    pair-symmetric tiers import it from there, and it gives the bits of
    each fused multiply-add rounded once from float64 (numpy here)."""
    assert forces_sym_tc.pair_inv_fma is pair_inv_fma
    pos, _, _ = make_small_system(200, seed=81)
    xi, xj = pos[:64], pos
    eps2 = np.float64(np.float32(EPS2))
    d2 = np.full((64, 200), eps2)
    for e in range(3):
        de = (xj[None, :, e] - xi[:, None, e]).astype(np.float64)
        d2 = (de * de + d2).astype(np.float32).astype(np.float64)
    d2 = torch.from_numpy(d2.astype(np.float32))
    want = torch.rsqrt(d2 * d2 * d2)
    got = pair_inv_fma(torch.from_numpy(xi), torch.from_numpy(xj), EPS2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("ni,nj", [(8192, 8192), (1 << 20, 1 << 20),
                                   (2048, 2048), (2048, 8192), (700, 700),
                                   (300, 1500), (3000, 129)])
def test_tc_slices_cover_every_tile_once(ni, nj):
    """The slices split the j tiles evenly and in order, none empty, at
    most one a tile; enough work items to fill an H100 where the j tiles
    allow (N = 8192: 64 row blocks x 32 two-tile slices; a 2048-body ring
    shard pair: 16 x 16 one-tile slices; N = 1M: the row blocks alone)."""
    tiles = -(-nj // TC_TILE_J)
    slices, tps = tc_slices(ni, nj)
    assert 1 <= slices <= tiles and (slices - 1) * tps < tiles <= slices * tps
    items = -(-ni // TC_BLOCK_ROWS) * slices
    assert items >= TC_ITEMS or slices == tiles or slices == 1
    want = {(8192, 8192): (32, 2), (2048, 2048): (16, 1),
            (1 << 20, 1 << 20): (1, 8192)}
    assert want.get((ni, nj), (slices, tps)) == (slices, tps)
    for asked in (1, 2, 3, tiles, 10 * tiles):
        s, t = tc_slices(ni, nj, asked)
        assert s <= min(asked, tiles) and (s - 1) * t < tiles <= s * t
