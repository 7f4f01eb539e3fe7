"""K14a-c (the pair-symmetric tensor-core variants ``turbo2``, ``turbof``
and ``turbop``) of the PyTorch port against the JAX package's
``forces_pallas_sym(variant=...)`` and the float64 oracle; the variant /
schedule entry point ``forces_pallas_sym``; and ``pallas_sym_turbo2``
through ``run_steps`` and the CLI.

On the CPU the wrappers run the kernels' plain twin, which has K2's tiles,
enumeration, slot layout and reduction order.  The JAX side runs Pallas in
interpret mode at ``block_i=128, block_u=256``, where its diagonal
superblocks are the port's 256-wide diagonal tiles.  Tolerances: against
JAX every component within rel 1e-3 + 1e-4·max|a| (the tensor-core tiers'
tolerance, see test_torch_forces_sym_tc.py); against the oracle turbo's
gates of ``tests/test_pallas_sym.py``, p99 < 5e-2 and a bad fraction <
0.1.
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
from nbody_tpu.ops.forces_pallas_sym import forces_pallas_sym as jax_sym
from nbody_tpu.ops.forces_pallas_sym import \
    resolve_schedule as jax_resolve_schedule
from nbody_tpu.oracle.numpy_oracle import (assert_matches_oracle,
                                           oracle_forces, oracle_run,
                                           relative_mismatch)
from nbody_tpu_torch import cli
from nbody_tpu_torch.ops import forces_sym, forces_sym_tc
from nbody_tpu_torch.ops.forces_sym import SYM_TILE
from nbody_tpu_torch.ops.forces_sym_variants import (SYM_SCHEDULES,
                                                     SYM_VARIANTS,
                                                     forces_pallas_sym,
                                                     resolve_schedule)

EPS2 = 0.002
TURBO_GATE = (5e-2, 0.1)                  # p99, bad fraction
WRAPPERS = {"turbo2": forces_sym_tc.forces_sym_turbo2,
            "turbof": forces_sym_tc.forces_sym_turbof,
            "turbop": forces_sym_tc.forces_sym_turbop}


def assert_close(got, want, what, rel=1e-3, floor=1e-4):
    bad = relative_mismatch(got, want, rel, floor * np.abs(want).max())
    assert bad.sum() == 0, (
        f"{what}: {int(bad.sum())}/{bad.size} components differ; max "
        f"rel {np.abs(got - want).max() / np.abs(want).max():.3e}")


def assert_turbo_gate(acc, ref, what):
    err = np.abs(acc - ref) / (np.abs(ref) + 1e-30)
    assert np.percentile(err, 99) < TURBO_GATE[0], what
    assert relative_mismatch(acc, ref, 0.01, 1e-4).mean() < TURBO_GATE[1], what


def jax_forces(pos, mass, variant, **kw):
    return np.asarray(jax_sym(jnp.asarray(pos), jnp.asarray(mass), EPS2,
                              block_i=128, block_u=SYM_TILE, variant=variant,
                              **kw))


@pytest.mark.parametrize("variant", ["turbo2", "turbof"])
@pytest.mark.parametrize("n", [1024, 2048])
def test_k14ab_twin_matches_jax_and_oracle(variant, n):
    pos, _, mass = make_small_system(n, seed=141)
    acc = WRAPPERS[variant](torch.from_numpy(pos), torch.from_numpy(mass),
                            EPS2).numpy()
    assert_close(acc, jax_forces(pos, mass, variant),
                 f"{variant} twin vs JAX, N={n}")
    assert_turbo_gate(acc, oracle_forces(pos, mass, EPS2),
                      f"{variant} twin vs oracle, N={n}")


def test_turbof_real_massless_bodies_match_the_oracle():
    """turbof's sums are mass-scaled: a real body of mass 0 has its row
    recomputed one-sided, so it matches the float64 oracle at the exact
    tier's tolerance, and every other row keeps turbo's gate.  (JAX maps
    1/0 to 0 and leaves such a body with its diagonal terms only; its
    result is not a gate here.)"""
    pos, _, mass = make_small_system(1024, seed=142)
    zero = [1, 300, 1023]
    mass[zero] = 0.0
    acc = forces_sym_tc.forces_sym_turbof(torch.from_numpy(pos),
                                          torch.from_numpy(mass),
                                          EPS2).numpy()
    ref = oracle_forces(pos, mass, EPS2)
    assert_close(acc[zero], ref[zero], "turbof massless rows vs oracle",
                 rel=1e-4, floor=1e-6)
    assert_turbo_gate(acc, ref, "turbof with massless bodies vs oracle")


@pytest.mark.parametrize("n", [1024, 700])
def test_turbop_twin_bit_equals_turbo(n):
    """turbop defers turbo's j-side products and changes neither a value
    nor an add order: bit-equal to turbo, as the JAX package tests."""
    pos, _, mass = make_small_system(n, seed=143)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    np.testing.assert_array_equal(
        forces_sym_tc.forces_sym_turbop(p, m, EPS2).numpy(),
        forces_sym_tc.forces_sym_turbo(p, m, EPS2).numpy())


def test_turbop_twin_matches_jax_turbop():
    pos, _, mass = make_small_system(1024, seed=144)
    acc = forces_sym_tc.forces_sym_turbop(torch.from_numpy(pos),
                                          torch.from_numpy(mass),
                                          EPS2).numpy()
    assert_close(acc, jax_forces(pos, mass, "turbop"),
                 "turbop twin vs JAX turbop")


@pytest.mark.parametrize("variant", ["turbo2", "turbof"])
def test_k14ab_chunked_offsets_are_bit_equal(variant):
    pos, _, mass = make_small_system(3000, seed=145)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    whole = forces_sym_tc.forces_sym_tc_plain(p, m, EPS2, variant)
    np.testing.assert_array_equal(
        forces_sym_tc.forces_sym_tc_plain(
            p, m, EPS2, variant, slot_budget=24 * 12 * SYM_TILE).numpy(),
        whole.numpy())


@pytest.mark.parametrize("variant", sorted(WRAPPERS))
def test_k14abc_wrapper_contract(variant):
    pos, _, mass = make_small_system(300, seed=146)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    wrapper = WRAPPERS[variant]
    before = wrapper.launches
    np.testing.assert_array_equal(
        wrapper(p, m, EPS2).numpy(),
        forces_sym_tc.forces_sym_tc_plain(p, m, EPS2, variant).numpy())
    assert wrapper.launches == before
    with pytest.raises(ValueError, match="float32"):
        wrapper(p.double(), m.double(), EPS2)
    with pytest.raises(ValueError, match="no kernel"):
        wrapper(p.to("meta"), m.to("meta"), EPS2)


def test_resolve_schedule_matches_jax():
    """The port's copy of ``resolve_schedule``: classic by default for
    every variant, fold only for the exact tiers, unknown names refused."""
    for variant in SYM_VARIANTS:
        assert resolve_schedule(None, variant) == "classic"
        assert jax_resolve_schedule(None, variant) == "classic"
        assert resolve_schedule("classic", variant) == "classic"
    for variant in ("vpu", "vpu2"):
        assert resolve_schedule("fold", variant) == "fold"
    for variant in ("turbo", "mxu", "turbo2", "turbof", "turbop"):
        with pytest.raises(ValueError, match="fold"):
            resolve_schedule("fold", variant)
        with pytest.raises(ValueError):
            jax_resolve_schedule("fold", variant)
    with pytest.raises(ValueError, match="schedule"):
        resolve_schedule("bogus", "vpu2")
    pos, _, mass = make_small_system(300, seed=147)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    with pytest.raises(ValueError, match="variant"):
        forces_pallas_sym(p, m, EPS2, variant="vpu3")
    with pytest.raises(ValueError, match="fold"):
        forces_pallas_sym(p, m, EPS2, variant="turbo", schedule="fold")
    with pytest.raises(ValueError, match="block_u"):
        forces_pallas_sym(p, m, EPS2, variant="turbo", block_u=512)
    with pytest.raises(ValueError, match="block_u"):
        forces_pallas_sym(p, m, EPS2, variant="vpu", schedule="fold",
                          block_u=640)


ROUTES = [("vpu2", "classic", forces_sym.forces_sym),
          ("vpu", "classic", forces_sym.forces_sym_vpu),
          ("turbo", "classic", forces_sym_tc.forces_sym_turbo),
          ("mxu", "classic", forces_sym_tc.forces_sym_mxu),
          ("turbo2", "classic", forces_sym_tc.forces_sym_turbo2),
          ("turbof", "classic", forces_sym_tc.forces_sym_turbof),
          ("turbop", "classic", forces_sym_tc.forces_sym_turbop),
          ("vpu2", "fold", forces_sym.forces_sym_fold),
          ("vpu", "fold", forces_sym.forces_sym_vpu_fold)]


@pytest.mark.parametrize("variant,schedule,wrapper", ROUTES,
                         ids=[f"{v}-{s}" for v, s, _ in ROUTES])
def test_entry_point_routes_each_variant(variant, schedule, wrapper):
    """``forces_pallas_sym`` reaches each variant's kernel wrapper: the
    same result bit for bit (``schedule=None`` is classic)."""
    assert {v for v, _, _ in ROUTES} == set(SYM_VARIANTS)
    assert set(SYM_SCHEDULES) == {"classic", "fold"}
    pos, _, mass = make_small_system(600, seed=148)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    got = forces_pallas_sym(p, m, EPS2, variant=variant,
                            schedule=None if schedule == "classic"
                            else schedule)
    np.testing.assert_array_equal(got.numpy(), wrapper(p, m, EPS2).numpy())


def test_run_steps_turbo2_matches_jax_and_oracle():
    """Three reference steps at N=512 with ``impl="pallas_sym_turbo2"``
    (now accepted by ``SimConfig``), the JAX side at ``block_i=128,
    block_u=256``: against JAX the 1% gate with the slice tests' absolute
    floors; against the oracle turbo's bad fraction."""
    n, steps, impl = 512, 3, "pallas_sym_turbo2"
    pos, vel, mass = make_small_system(n, seed=149)
    jax_cfg = JaxSimConfig(n_bodies=n, impl=impl, block_i=128,
                           block_u=SYM_TILE, block_j=128, resident=False)
    jax_out = jax_state_to_numpy(jax_run_steps(
        JaxSimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                    acc=jnp.zeros((n, 3), jnp.float32),
                    mass=jnp.asarray(mass)), jax_cfg, steps))
    cfg = nt.SimConfig(n_bodies=n, impl=impl, device="cpu")
    assert nt.resolve_impl(cfg) == impl
    state = nt.state_from_numpy(
        {"pos": pos, "vel": vel, "acc": np.zeros_like(pos), "mass": mass},
        device="cpu")
    out = nt.state_to_numpy(nt.run_steps(state, cfg, steps))
    rpos, rvel, _ = oracle_run(pos, vel, mass, EPS2, cfg.dt, steps)
    for k, abs_tol, ref in (("pos", 1.0, rpos), ("vel", 1e-2, rvel)):
        assert_matches_oracle(out[k], jax_out[k], f"{k} vs JAX ({impl})",
                              abs_tol=abs_tol)
        assert_matches_oracle(out[k], ref, f"{k} vs oracle ({impl})",
                              abs_tol=abs_tol, max_frac_bad=TURBO_GATE[1])


def test_cli_validate_run_bench_turbo2_on_cpu(tmp_path, capsys):
    impl = "pallas_sym_turbo2"
    common = ["--impl", impl, "--device", "cpu"]
    rc = cli.main(["validate", "--n", "700", "--long-steps", "0",
                   "--max-bad-frac", "0.1", "--max-bad-frac-acc", "0.1",
                   *common])
    out = capsys.readouterr().out
    assert rc == 0 and "Verification PASSED" in out, out
    assert f"impl={impl}" in out
    end = str(tmp_path / "end.npz")
    assert cli.main(["run", "--n", "700", "--steps", "3", "--checkpoint",
                     end, "--quiet", *common]) == 0
    with np.load(end) as z:
        assert int(z["step"]) == 3 and np.isfinite(z["pos"]).all()
    capsys.readouterr()
    assert cli.main(["bench", "--n", "700", "--steps", "2", *common]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["impl"] == impl and res["finite"] and not res["resident"]
