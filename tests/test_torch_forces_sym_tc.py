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
from nbody_tpu.oracle.numpy_oracle import (assert_matches_oracle,
                                           oracle_forces, oracle_run,
                                           relative_mismatch)
from nbody_tpu_torch import cli
from nbody_tpu_torch.ops.forces_sym import SYM_TILE
from nbody_tpu_torch.ops.forces_sym_tc import (_pair_tiles, forces_sym_mxu,
                                               forces_sym_tc,
                                               forces_sym_tc_plain,
                                               forces_sym_turbo,
                                               forces_sym_turbop,
                                               pair_inv_fma,
                                               rect_forces_sym_tc_plain)
from nbody_tpu_torch.ops.forces_tiled_tc import pair_inv
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


def test_trimmed_geometry_belongs_to_turbo_k2rect_not_k13():
    """turbo and turbop take the trimmed geometry in the square and rect
    twins; mxu keeps pair_inv; K13's turbo tile keeps pair_inv, as its
    kernel does."""
    pos, _, mass = make_small_system(512, seed=89)
    x = torch.from_numpy(pos).view(2, 256, 3)
    mm = torch.from_numpy(mass).view(2, 256)
    xi, mi, xj, mj = x[:1], mm[:1], x[1:], mm[1:]
    fused = _pair_tiles(xi, mi, xj, mj, EPS2, "turbo")
    unfused = _pair_tiles(xi, mi, xj, mj, EPS2, "turbo", trimmed=False)
    ring = rdma_ring._tile_both("turbo", EPS2)(xi, mi, xj, mj)
    for a, b in zip(ring, unfused):
        assert torch.equal(a, b)
    for a, b in zip(_pair_tiles(xi, mi, xj, mj, EPS2, "turbop"), fused):
        assert torch.equal(a, b)
    for a, b in zip(_pair_tiles(xi, mi, xj, mj, EPS2, "mxu"),
                    _pair_tiles(xi, mi, xj, mj, EPS2, "mxu", trimmed=False)):
        assert torch.equal(a, b)
    pa, ma, pb, mb = (torch.from_numpy(np.ascontiguousarray(v)) for v in
                      (pos[:256], mass[:256], pos[256:], mass[256:]))
    acc_a, acc_b = rect_forces_sym_tc_plain(pa, ma, pb, mb, EPS2, "turbo")
    d_a, d_b = fused
    assert torch.equal(acc_a, d_a[0]) and torch.equal(acc_b, d_b[0])
