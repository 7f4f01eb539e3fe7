"""K5 / K6 (the pair-symmetric tensor-core tiers ``turbo`` and ``mxu``) of
the PyTorch port against the JAX package's
``forces_pallas_sym(variant=...)`` and the float64 oracle, the port's own
contract (offset chunking, real zero-mass bodies, the exact diagonal), and
the tiers through ``run_steps`` and the CLI.

On the CPU the wrappers run the kernels' plain twin, which has K2's tiles,
enumeration, slot layout and reduction order.  The JAX side runs Pallas in
interpret mode at ``block_i=128, block_u=256``: its diagonal superblocks
are then the port's 256-wide diagonal tiles (exact float32 on both sides),
and every other pair goes through bf16 on both.  At the JAX default
``block_u`` (1024-2048) many more pairs would take the exact path.

Tolerances.  Against JAX: every component within rel 1e-3 + 1e-4·max|a|
(the float32 grouping of the cancelling correction differs; see
test_torch_forces_tiled_tc.py).  Against the oracle, the gates of
``tests/test_pallas_sym.py``: turbo p99 < 5e-2 and a bad fraction < 0.1;
mxu p99 < 5e-3 and a bad fraction < 5e-3.
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
from nbody_tpu.ops.forces_pallas_sym import forces_pallas_sym
from nbody_tpu.ops.forces_pallas_sym import \
    rect_forces_sym as jax_rect_forces_sym
from nbody_tpu.oracle.numpy_oracle import (assert_matches_oracle,
                                           oracle_forces, oracle_run,
                                           relative_mismatch)
from nbody_tpu_torch import cli
from nbody_tpu_torch.ops.forces_sym import (SLOT_BUDGET_BYTES, SYM_TILE,
                                            descale_plain, sweep_plain)
from nbody_tpu_torch.ops import ablation_sym
from nbody_tpu_torch.ops.forces_sym_tc import (_pair_tiles, _turbo_weights,
                                               forces_sym_mxu,
                                               forces_sym_tc,
                                               forces_sym_tc_plain,
                                               forces_sym_turbo,
                                               forces_sym_turbop,
                                               pair_inv_fma,
                                               rect_forces_sym_tc_plain)
from nbody_tpu_torch.ops.forces_tiled_tc import (bf16_split,
                                                  mass_folded_pack, pair_inv,
                                                  tile_result)
from nbody_tpu_torch.ops.forces_torch import rect_forces
from nbody_tpu_torch.parallel import rdma_ring

EPS2 = 0.002
IMPLS = {"turbo": "pallas_sym_turbo", "mxu": "pallas_sym_mxu"}
WRAPPERS = {"turbo": forces_sym_turbo, "mxu": forces_sym_mxu}
GATES = {"turbo": (5e-2, 0.1), "mxu": (5e-3, 5e-3)}   # p99, bad fraction


def assert_close_tier(got, want, what):
    bad = relative_mismatch(got, want, 1e-3, 1e-4 * np.abs(want).max())
    assert bad.sum() == 0, (
        f"{what}: {int(bad.sum())}/{bad.size} components differ; max "
        f"rel {np.abs(got - want).max() / np.abs(want).max():.3e}")


def assert_tier_gate(acc, ref, variant, what):
    p99, frac = GATES[variant]
    err = np.abs(acc - ref) / (np.abs(ref) + 1e-30)
    assert np.percentile(err, 99) < p99, what
    assert relative_mismatch(acc, ref, 0.01, 1e-4).mean() < frac, what


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
@pytest.mark.parametrize("n", [700, 2048])
def test_k5_k6_twin_matches_jax_and_oracle(variant, n):
    pos, _, mass = make_small_system(n, seed=81)
    acc = forces_sym_tc(torch.from_numpy(pos), torch.from_numpy(mass),
                        EPS2, variant).numpy()
    ref_jax = np.asarray(forces_pallas_sym(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=128,
        block_u=SYM_TILE, variant=variant))
    assert_close_tier(acc, ref_jax, f"K5/K6 {variant} twin vs JAX, N={n}")
    assert_tier_gate(acc, oracle_forces(pos, mass, EPS2), variant,
                     f"{variant} twin vs oracle, N={n}")


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
def test_k5_k6_chunked_offsets_are_bit_equal(variant):
    """Folding the offsets chunk by chunk keeps the reduction order, so
    the result is bit-equal to one chunk."""
    pos, _, mass = make_small_system(3000, seed=82)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    whole = forces_sym_tc_plain(p, m, EPS2, variant)
    n_pad = 12 * SYM_TILE
    for k in (1, 4):
        np.testing.assert_array_equal(
            forces_sym_tc_plain(p, m, EPS2, variant,
                                slot_budget=k * 24 * n_pad).numpy(),
            whole.numpy())


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
def test_k5_k6_real_zero_mass_bodies_are_correct(variant):
    """A real body of mass 0 feels the full field from its slots alone
    (its weights carry its partners' masses) and pulls on nothing.  A row
    counted twice, or missing its off-diagonal part, would be off by
    ~100%; each massless row must be within the tier's p99 of the
    oracle."""
    pos, _, mass = make_small_system(700, seed=83)
    zero = [1, 300, 699]
    mass[zero] = 0.0
    acc = forces_sym_tc(torch.from_numpy(pos), torch.from_numpy(mass),
                        EPS2, variant).numpy()
    ref = oracle_forces(pos, mass, EPS2)
    assert_tier_gate(acc, ref, variant, f"{variant} with zero-mass bodies")
    row_err = (np.linalg.norm(acc[zero] - ref[zero], axis=1)
               / np.linalg.norm(ref[zero], axis=1))
    assert row_err.max() < GATES[variant][0], row_err


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
def test_one_tile_is_the_exact_diagonal(variant):
    """At N <= 256 there is no off-diagonal tile: the result is the exact
    float32 diagonal pass, within the exact tier's rel 1e-4 + 1e-6·max of
    the direct form."""
    pos, _, mass = make_small_system(200, seed=84)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    acc = forces_sym_tc(p, m, EPS2, variant).numpy()
    ref = rect_forces(p, p, m, EPS2).numpy()
    bad = relative_mismatch(acc, ref, 1e-4, 1e-6 * np.abs(ref).max())
    assert bad.sum() == 0


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
def test_k5_k6_wrapper_contract(variant):
    pos, _, mass = make_small_system(300, seed=85)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    wrapper = WRAPPERS[variant]
    before = wrapper.launches
    np.testing.assert_array_equal(
        wrapper(p, m, EPS2).numpy(),
        forces_sym_tc_plain(p, m, EPS2, variant).numpy())
    assert wrapper.launches == before
    with pytest.raises(ValueError, match="float32"):
        wrapper(p.double(), m.double(), EPS2)
    with pytest.raises(ValueError, match="no kernel"):
        wrapper(p.to("meta"), m.to("meta"), EPS2)
    with pytest.raises(ValueError, match="variant"):
        forces_sym_tc(p, m, EPS2, "turbo3")


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
def test_run_steps_matches_jax_and_oracle(variant):
    """Three reference steps at N=512 through ``run_steps``, the JAX side
    at ``block_i=128, block_u=256``: against JAX the 1% gate with the
    slice tests' absolute floors; against the oracle the tier's bad
    fraction."""
    n, steps, impl = 512, 3, IMPLS[variant]
    pos, vel, mass = make_small_system(n, seed=86)
    jax_cfg = JaxSimConfig(n_bodies=n, impl=impl, block_i=128,
                           block_u=SYM_TILE, block_j=128, resident=False)
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
    for k, abs_tol, ref in (("pos", 1.0, rpos), ("vel", 1e-2, rvel)):
        assert_matches_oracle(out[k], jax_out[k], f"{k} vs JAX ({impl})",
                              abs_tol=abs_tol)
        assert_matches_oracle(out[k], ref, f"{k} vs oracle ({impl})",
                              abs_tol=abs_tol,
                              max_frac_bad=GATES[variant][1])


@pytest.mark.parametrize("variant", ["turbo", "mxu"])
def test_cli_validate_run_resume_bench_on_cpu(variant, tmp_path, capsys):
    impl = IMPLS[variant]
    frac = str(GATES[variant][1])
    common = ["--impl", impl, "--device", "cpu"]
    rc = cli.main(["validate", "--n", "700", "--long-steps", "0",
                   "--max-bad-frac", frac, "--max-bad-frac-acc", frac,
                   *common])
    out = capsys.readouterr().out
    assert rc == 0 and "Verification PASSED" in out, out
    assert f"impl={impl}" in out
    a, b, c = (str(tmp_path / f"{x}.npz") for x in "abc")
    assert cli.main(["run", "--n", "700", "--steps", "4", "--checkpoint", a,
                     "--quiet", *common]) == 0
    assert cli.main(["run", "--resume", a, "--steps", "2", "--checkpoint", b,
                     "--quiet", "--device", "cpu"]) == 0
    assert cli.main(["run", "--n", "700", "--steps", "6", "--checkpoint", c,
                     "--quiet", *common]) == 0
    with np.load(b) as zb, np.load(c) as zc:
        assert int(zb["step"]) == int(zc["step"]) == 6
        for k in ("pos", "vel", "acc"):
            np.testing.assert_array_equal(zb[k], zc[k])
    capsys.readouterr()
    assert cli.main(["bench", "--n", "700", "--steps", "2", *common]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["impl"] == impl and res["finite"] and not res["resident"]


def test_trimmed_geometry_rounds_each_fma_once():
    """K5's d2 is fma(dz, dz, fma(dy, dy, fma(dx, dx, eps2))), each step
    rounded once to float32: the twin's inv is the float64 value of the
    exact geometry to float32 rounding, and differs from the unfused
    pair_inv on some pairs (the bits the trimmed kernel changes)."""
    pos, _, _ = make_small_system(256, seed=87)
    x = torch.from_numpy(pos)[None]
    fused = pair_inv_fma(x, x, EPS2)[0].double().numpy()
    plain = pair_inv(x, x, EPS2)[0].double().numpy()
    r = (pos[None, :, :] - pos[:, None, :]).astype(np.float64)
    d2 = (r * r).sum(-1) + np.float64(np.float32(EPS2))
    np.testing.assert_allclose(fused, d2 ** -1.5, rtol=1e-6)
    assert (fused != plain).any()
    np.testing.assert_allclose(fused, plain, rtol=2e-6)


@pytest.mark.parametrize("n", [1029, 1536])
def test_k5_trimmed_twin_matches_jax_turbo_and_turbop(n):
    """The K5 twin with its trimmed geometry against JAX's turbo in
    interpret mode at the tier tolerance, on a ragged set with an even
    tile count (1029: the half offset) and on whole tiles; the turbop twin
    is the turbo twin bit for bit."""
    pos, _, mass = make_small_system(n, seed=88)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    acc = forces_sym_turbo(p, m, EPS2).numpy()
    ref_jax = np.asarray(forces_pallas_sym(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=128,
        block_u=SYM_TILE, variant="turbo"))
    assert_close_tier(acc, ref_jax, f"K5 trimmed twin vs JAX, N={n}")
    np.testing.assert_array_equal(forces_sym_turbop(p, m, EPS2).numpy(), acc)


def _turbof_square_twin(pos, mass, trimmed):
    """turbof's square twin with the tiles of ``_pair_tiles(trimmed=)``:
    the slot sums descaled by 1/m plus the exact diagonal."""
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    pt, mt, raw = sweep_plain(p, m, SLOT_BUDGET_BYTES, lambda xi, mi, xj, mj:
                              _pair_tiles(xi, mi, xj, mj, EPS2, "turbof",
                                          trimmed=trimmed))
    return descale_plain(pt, mt, raw, p, m, EPS2)


def test_trimmed_geometry_belongs_to_turbo_k2rect_not_k13():
    """turbo, turbop, turbo2, turbof and mxu take the trimmed geometry in
    the square and rect twins, and so do K15's tmm_noj and tmm_nomm, which
    ablate K5's tile; K13's turbo, turbo2 and mxu tiles keep pair_inv, as
    its kernel does (K13 refuses turbof)."""
    pos, _, mass = make_small_system(512, seed=89)
    x = torch.from_numpy(pos).view(2, 256, 3)
    mm = torch.from_numpy(mass).view(2, 256)
    xi, mi, xj, mj = x[:1], mm[:1], x[1:], mm[1:]
    fused = _pair_tiles(xi, mi, xj, mj, EPS2, "turbo")
    unfused = _pair_tiles(xi, mi, xj, mj, EPS2, "turbo", trimmed=False)
    # tmm_noj: K5's trimmed row half; tmm_nomm: the sums of K5's trimmed
    # bf16 weights.  Some bits differ from the same on pair_inv.
    noj = ablation_sym._pair_tiles(EPS2, "tmm_noj")(xi, mi, xj, mj)[0]
    assert torch.equal(noj, fused[0])
    assert not torch.equal(noj, unfused[0])
    nomm = ablation_sym._pair_tiles(EPS2, "tmm_nomm")(xi, mi, xj, mj)[0]
    wi, wj = _turbo_weights(xi, mi, xj, mj, EPS2, trimmed=False)
    assert not torch.equal(nomm[..., 0], wi.sum(2) + wj.sum(2))
    ring = rdma_ring._tile_both("turbo", EPS2)(xi, mi, xj, mj)
    for a, b in zip(ring, unfused):
        assert torch.equal(a, b)
    for a, b in zip(_pair_tiles(xi, mi, xj, mj, EPS2, "turbop"), fused):
        assert torch.equal(a, b)
    fused_mxu = _pair_tiles(xi, mi, xj, mj, EPS2, "mxu")
    assert any(not torch.equal(a, b) for a, b in zip(
        fused_mxu, _pair_tiles(xi, mi, xj, mj, EPS2, "mxu", trimmed=False)))
    pa, ma, pb, mb = (torch.from_numpy(np.ascontiguousarray(v)) for v in
                      (pos[:256], mass[:256], pos[256:], mass[256:]))
    acc_a, acc_b = rect_forces_sym_tc_plain(pa, ma, pb, mb, EPS2, "turbo")
    d_a, d_b = fused
    assert torch.equal(acc_a, d_a[0]) and torch.equal(acc_b, d_b[0])
    # turbo2: the square and rect twins trimmed, K13's tile not.
    fused2 = _pair_tiles(xi, mi, xj, mj, EPS2, "turbo2")
    unfused2 = _pair_tiles(xi, mi, xj, mj, EPS2, "turbo2", trimmed=False)
    assert any(not torch.equal(a, b) for a, b in zip(fused2, unfused2))
    for a, b in zip(rdma_ring._tile_both("turbo2", EPS2)(xi, mi, xj, mj),
                    unfused2):
        assert torch.equal(a, b)
    acc_a, acc_b = rect_forces_sym_tc_plain(pa, ma, pb, mb, EPS2, "turbo2")
    assert torch.equal(acc_a, fused2[0][0])
    assert torch.equal(acc_b, fused2[1][0])
    acc_a, acc_b = rect_forces_sym_tc_plain(pa, ma, pb, mb, EPS2, "mxu")
    assert torch.equal(acc_a, fused_mxu[0][0])
    assert torch.equal(acc_b, fused_mxu[1][0])
    # turbof: the square and rect twins trimmed; its rect sums are
    # mass-scaled, descaled by 1/m.  Its weight m_i m_j inv changes its
    # bf16 rounding with a unit of inv far more rarely than turbo2's
    # bf16(inv) (no pair of the 512 bodies above), so it takes four tile
    # pairs of 2048 bodies, where a few do.
    pos, _, mass = make_small_system(2048, seed=94)
    x = torch.from_numpy(pos).view(8, 256, 3)
    mm = torch.from_numpy(mass).view(8, 256)
    fusedf = _pair_tiles(x[:4], mm[:4], x[4:], mm[4:], EPS2, "turbof")
    unfusedf = _pair_tiles(x[:4], mm[:4], x[4:], mm[4:], EPS2, "turbof",
                           trimmed=False)
    assert any(not torch.equal(a, b) for a, b in zip(fusedf, unfusedf))
    for k in range(4):
        acc_a, acc_b = rect_forces_sym_tc_plain(x[k], mm[k], x[4 + k],
                                                mm[4 + k], EPS2, "turbof")
        assert torch.equal(acc_a, fusedf[0][k] * (1.0 / mm[k])[:, None])
        assert torch.equal(acc_b, fusedf[1][k] * (1.0 / mm[4 + k])[:, None])
    square = forces_sym_tc_plain(torch.from_numpy(pos),
                                 torch.from_numpy(mass), EPS2, "turbof")
    assert torch.equal(square, _turbof_square_twin(pos, mass, True))
    assert not torch.equal(square, _turbof_square_twin(pos, mass, False))


@pytest.mark.parametrize("n", [512, 1000])
def test_k14a_trimmed_twin_matches_jax_turbo2_and_oracle(n):
    """The K14a twin with its trimmed geometry against JAX's turbo2 in
    interpret mode at the tier tolerance (rel 1e-3 + 1e-4·max|a|) and
    against the float64 oracle at turbo's gate (p99 < 5e-2, bad fraction
    < 0.1 at 1%): 512 is two whole tiles (one offset, the half offset of
    an even tile count), 1000 four tiles, the last ragged."""
    pos, _, mass = make_small_system(n, seed=90)
    acc = forces_sym_tc(torch.from_numpy(pos), torch.from_numpy(mass),
                        EPS2, "turbo2").numpy()
    ref_jax = np.asarray(forces_pallas_sym(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=128,
        block_u=SYM_TILE, variant="turbo2"))
    assert_close_tier(acc, ref_jax, f"K14a trimmed twin vs JAX, N={n}")
    assert_tier_gate(acc, oracle_forces(pos, mass, EPS2), "turbo",
                     f"K14a trimmed twin vs oracle, N={n}")


@pytest.mark.parametrize("shape", [(512, None), (1000, None), (256, 256)])
def test_k14b_trimmed_twin_matches_jax_turbof_and_oracle(shape):
    """The K14b twin with its trimmed geometry against JAX's turbof in
    interpret mode at the tier tolerance (rel 1e-3 + 1e-4·max|a|) and
    against the float64 oracle at turbo's gate (p99 < 5e-2, bad fraction
    < 0.1 at 1%): 512 is two whole tiles (the half offset of an even tile
    count), 1000 four tiles, the last ragged; (256, 256) the rect form
    (K2-rect turbof, one tile pair) against JAX's ``rect_forces_sym``,
    each side against the float64 cross sums."""
    na, nb = shape
    if nb is None:
        pos, _, mass = make_small_system(na, seed=92)
        acc = forces_sym_tc(torch.from_numpy(pos), torch.from_numpy(mass),
                            EPS2, "turbof").numpy()
        ref_jax = np.asarray(forces_pallas_sym(
            jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=128,
            block_u=SYM_TILE, variant="turbof"))
        assert_close_tier(acc, ref_jax, f"K14b trimmed twin vs JAX, N={na}")
        assert_tier_gate(acc, oracle_forces(pos, mass, EPS2), "turbo",
                         f"K14b trimmed twin vs oracle, N={na}")
        return
    pos, _, mass = make_small_system(na + nb, seed=93)
    sets = (pos[:na], mass[:na], pos[na:], mass[na:])
    got = rect_forces_sym_tc_plain(*(torch.from_numpy(v) for v in sets),
                                   EPS2, "turbof")
    want = jax_rect_forces_sym(*(jnp.asarray(v) for v in sets), EPS2,
                               block_i=256, block_u=SYM_TILE,
                               variant="turbof")
    pa, ma, pb, mb = (v.astype(np.float64) for v in sets)
    for side, g, w, xi, xj, mj in (("a", got[0], want[0], pa, pb, mb),
                                   ("b", got[1], want[1], pb, pa, ma)):
        r = xj[None] - xi[:, None]
        d2 = (r * r).sum(-1) + EPS2
        ref = ((mj[None] / d2 ** 1.5)[..., None] * r).sum(1)
        what = f"K2-rect turbof trimmed twin acc_{side}, {na}x{nb}"
        assert_close_tier(g.numpy(), np.asarray(w), what + " vs JAX")
        assert_tier_gate(g.numpy(), ref, "turbo", what + " vs float64")


@pytest.mark.parametrize("n", [512, 1000])
def test_k6_trimmed_twin_matches_jax_mxu_and_oracle(n):
    """The K6 twin with its trimmed geometry against JAX's mxu in
    interpret mode at the tier tolerance (rel 1e-3 + 1e-4·max|a|) and
    against the float64 oracle at the sym mxu gate (p99 < 5e-3, bad
    fraction < 5e-3 at 1%): 512 is two whole tiles (the half offset of an
    even tile count), 1000 four tiles, the last ragged."""
    pos, _, mass = make_small_system(n, seed=91)
    acc = forces_sym_mxu(torch.from_numpy(pos), torch.from_numpy(mass),
                         EPS2).numpy()
    ref_jax = np.asarray(forces_pallas_sym(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=128,
        block_u=SYM_TILE, variant="mxu"))
    assert_close_tier(acc, ref_jax, f"K6 trimmed twin vs JAX, N={n}")
    assert_tier_gate(acc, oracle_forces(pos, mass, EPS2), "mxu",
                     f"K6 trimmed twin vs oracle, N={n}")


def _mxu_tiles(inv, xi, mi, xj, mj):
    """K6's tile from a given inv: the hi/lo limbs against both
    mass-folded packs, each side's per-tile correction."""
    hi, lo = bf16_split(inv)
    pj, pi = mass_folded_pack(xj, mj), mass_folded_pack(xi, mi)
    return (tile_result(hi @ pj + lo @ pj, xi),
            tile_result(hi.transpose(1, 2) @ pi + lo.transpose(1, 2) @ pi,
                        xj))


def _two_tiles(seed):
    pos, _, mass = make_small_system(512, seed=seed)
    x = torch.from_numpy(pos).view(2, 256, 3)
    m = torch.from_numpy(mass).view(2, 256)
    return x[:1], m[:1], x[1:], m[1:]


def test_k6_twin_rounds_with_pair_inv_fma():
    """The mxu twin's tile is the hi/lo product of pair_inv_fma's inv,
    bit for bit; pair_inv's inv gives other hi/lo limbs on some pairs,
    and so another tile."""
    xi, mi, xj, mj = _two_tiles(92)
    got = _pair_tiles(xi, mi, xj, mj, EPS2, "mxu")
    fused = pair_inv_fma(xi, xj, EPS2)
    unfused = pair_inv(xi, xj, EPS2)
    for a, b in zip(got, _mxu_tiles(fused, xi, mi, xj, mj)):
        assert torch.equal(a, b)
    limbs = [torch.stack(bf16_split(inv)) for inv in (fused, unfused)]
    assert (limbs[0] != limbs[1]).any()
    assert any(not torch.equal(a, b) for a, b in
               zip(got, _mxu_tiles(unfused, xi, mi, xj, mj)))


def test_k13_mxu_twin_keeps_pair_inv():
    """K13's mxu tile (``rdma_ring._tile_both``) keeps the unfused
    geometry: the hi/lo product of pair_inv's inv, not K6's."""
    xi, mi, xj, mj = _two_tiles(93)
    ring = rdma_ring._tile_both("mxu", EPS2)(xi, mi, xj, mj)
    for a, b in zip(ring, _mxu_tiles(pair_inv(xi, xj, EPS2), xi, mi, xj,
                                     mj)):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in
               zip(ring, _pair_tiles(xi, mi, xj, mj, EPS2, "mxu")))
