"""K7 (``pallas_sym``, the classic exact Newton's-third-law tile) of the
PyTorch port against the JAX package's ``forces_pallas_sym(variant="vpu")``
and the float64 oracle; its own contract (offset chunking, real massless
bodies, momentum closure); ``pallas_sym`` routing to the resident kernels
as in the JAX package; and the tier through ``run_steps`` and the CLI.

On the CPU the wrapper runs the kernels' plain twin (K2's tiles,
enumeration, slot layout and reduction order; one-sided weights, no
descale).  The JAX side runs Pallas in interpret mode at ``block_i=128,
block_u=256``, where its diagonal superblocks are the port's 256-wide
diagonal tiles.  Tolerances: the exact tier's rel 1e-4 + 1e-6·max|a|
against JAX and against the oracle's direct sum (both float32 exact tiers
that sum in other orders), and the oracle's 1% gate.
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
from nbody_tpu.models.simulation import Simulation as JaxSimulation
from nbody_tpu.models.state import state_to_numpy as jax_state_to_numpy
from nbody_tpu.ops.forces_pallas_sym import forces_pallas_sym
from nbody_tpu.ops.resident import should_use_resident as jax_use_resident
from nbody_tpu.oracle.numpy_oracle import (assert_matches_oracle,
                                           oracle_forces, oracle_run,
                                           relative_mismatch)
from nbody_tpu_torch import cli
from nbody_tpu_torch.ops.forces_sym import (SYM_TILE, forces_sym_vpu,
                                            forces_sym_vpu_plain)
from nbody_tpu_torch.ops.resident import should_use_resident

EPS2 = 0.002


def assert_close_exact(got, want, what):
    bad = relative_mismatch(got, want, 1e-4, 1e-6 * np.abs(want).max())
    assert bad.sum() == 0, (
        f"{what}: {int(bad.sum())}/{bad.size} components differ; max "
        f"rel {np.abs(got - want).max() / np.abs(want).max():.3e}")


@pytest.mark.parametrize("n", [700, 2048])
def test_k7_twin_matches_jax_vpu_and_oracle(n):
    pos, _, mass = make_small_system(n, seed=101)
    acc = forces_sym_vpu(torch.from_numpy(pos), torch.from_numpy(mass),
                         EPS2).numpy()
    ref_jax = np.asarray(forces_pallas_sym(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=128,
        block_u=SYM_TILE, variant="vpu"))
    assert_close_exact(acc, ref_jax, f"K7 twin vs JAX vpu, N={n}")
    assert_matches_oracle(acc, oracle_forces(pos, mass, EPS2),
                          f"K7 twin vs oracle, N={n}")


def test_k7_real_massless_bodies_are_right_without_recompute():
    """No descale: a real body of mass 0 feels the full field from its
    slots and pulls on nothing, as in the JAX vpu variant (unlike vpu2)."""
    pos, _, mass = make_small_system(700, seed=102)
    zero = [1, 300, 699]
    mass[zero] = 0.0
    acc = forces_sym_vpu(torch.from_numpy(pos), torch.from_numpy(mass),
                         EPS2).numpy()
    assert_close_exact(acc, oracle_forces(pos, mass, EPS2),
                       "K7 twin with massless bodies vs oracle")
    ref_jax = np.asarray(forces_pallas_sym(
        jnp.asarray(pos), jnp.asarray(mass), EPS2, block_i=128,
        block_u=SYM_TILE, variant="vpu"))
    assert_close_exact(acc, ref_jax, "K7 twin with massless bodies vs JAX")
    assert np.abs(acc[zero]).min() > 0


def test_k7_chunked_offsets_are_bit_equal():
    pos, _, mass = make_small_system(3000, seed=103)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    whole = forces_sym_vpu_plain(p, m, EPS2)
    n_pad = 12 * SYM_TILE
    for k in (1, 4):
        np.testing.assert_array_equal(
            forces_sym_vpu_plain(p, m, EPS2,
                                 slot_budget=k * 24 * n_pad).numpy(),
            whole.numpy())


def test_k7_momentum_closure():
    """Both sides of a pair carry m_i m_j inv up to one rounding, so the
    net force sum_i m_i a_i vanishes to rounding."""
    pos, _, mass = make_small_system(1500, seed=104)
    acc = forces_sym_vpu(torch.from_numpy(pos), torch.from_numpy(mass),
                         EPS2).numpy().astype(np.float64)
    m = mass.astype(np.float64)[:, None]
    assert np.abs((m * acc).sum(0)).max() / (m * np.abs(acc)).sum() < 1e-6


def test_k7_wrapper_contract():
    pos, _, mass = make_small_system(300, seed=105)
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    before = forces_sym_vpu.launches
    np.testing.assert_array_equal(forces_sym_vpu(p, m, EPS2).numpy(),
                                  forces_sym_vpu_plain(p, m, EPS2).numpy())
    assert forces_sym_vpu.launches == before
    with pytest.raises(ValueError, match="float32"):
        forces_sym_vpu(p.double(), m.double(), EPS2)
    with pytest.raises(ValueError, match="no kernel"):
        forces_sym_vpu(p.to("meta"), m.to("meta"), EPS2)


@pytest.mark.parametrize("n,resident", [(512, None), (512, True),
                                        (512, False), (8192, True),
                                        (1 << 20, None)])
def test_pallas_sym_routes_to_resident_as_in_jax(n, resident):
    """The resident kernels stand in for every exact pair-symmetric
    request in both packages.  Forced (True) and refused (False) agree;
    under auto each package uses its own measured window."""
    cfg = nt.SimConfig(n_bodies=n, impl="pallas_sym", resident=resident)
    jax_cfg = JaxSimConfig(n_bodies=n, impl="pallas_sym", resident=resident)
    port = should_use_resident(cfg, "pallas_sym")
    if resident is not None:
        assert port is resident is jax_use_resident(jax_cfg, "pallas_sym")
    else:
        assert not port                          # outside the auto window
    assert should_use_resident(cfg.replace(n_bodies=8192, resident=None),
                               "pallas_sym")


def test_pallas_sym_resident_run_matches_jax():
    """``Simulation(impl="pallas_sym", resident=True)`` rides the resident
    path (K2's math) in both packages; 4 steps from the same arrays."""
    n = 256
    pos, vel, mass = make_small_system(n, seed=106)
    arrays = {"pos": pos, "vel": vel, "acc": np.zeros_like(pos),
              "mass": mass}
    jax_res = JaxSimulation(
        JaxSimConfig(n_bodies=n, impl="pallas_sym", resident=True),
        state=JaxSimState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    ).run(n_steps=4, log_every=0)
    sim = nt.Simulation(nt.SimConfig(n_bodies=n, impl="pallas_sym",
                                     resident=True, device="cpu"),
                        state=nt.state_from_numpy(arrays, device="cpu"))
    assert sim._resident
    got = nt.state_to_numpy(sim.run(n_steps=4, log_every=0).state)
    want = jax_state_to_numpy(jax_res.state)
    assert_matches_oracle(got["pos"], want["pos"], "pos", abs_tol=1.0)
    assert_matches_oracle(got["vel"], want["vel"], "vel", abs_tol=1e-2)


def test_run_steps_matches_jax_and_oracle():
    """Three reference steps at N=512 through ``run_steps`` (per step: K7
    itself), against JAX ``run_steps`` at ``block_i=128, block_u=256`` and
    the oracle: the 1% gate with the slice tests' absolute floors."""
    n, steps = 512, 3
    pos, vel, mass = make_small_system(n, seed=107)
    jax_cfg = JaxSimConfig(n_bodies=n, impl="pallas_sym", block_i=128,
                           block_u=SYM_TILE, resident=False)
    jax_out = jax_state_to_numpy(jax_run_steps(
        JaxSimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                    acc=jnp.zeros((n, 3), jnp.float32),
                    mass=jnp.asarray(mass)), jax_cfg, steps))
    cfg = nt.SimConfig(n_bodies=n, impl="pallas_sym", resident=False,
                       device="cpu")
    state = nt.state_from_numpy(
        {"pos": pos, "vel": vel, "acc": np.zeros_like(pos), "mass": mass},
        device="cpu")
    out = nt.state_to_numpy(nt.run_steps(state, cfg, steps))
    rpos, rvel, _ = oracle_run(pos, vel, mass, EPS2, cfg.dt, steps)
    for k, abs_tol, ref in (("pos", 1.0, rpos), ("vel", 1e-2, rvel)):
        assert_matches_oracle(out[k], jax_out[k], f"{k} vs JAX",
                              abs_tol=abs_tol)
        assert_matches_oracle(out[k], ref, f"{k} vs oracle", abs_tol=abs_tol)


def test_cli_validate_run_resume_bench_on_cpu(tmp_path, capsys):
    common = ["--impl", "pallas_sym", "--device", "cpu"]
    rc = cli.main(["validate", "--n", "600", "--long-steps", "0", *common])
    out = capsys.readouterr().out
    assert rc == 0 and "Verification PASSED" in out, out
    assert "impl=pallas_sym " in out
    a, b, c = (str(tmp_path / f"{x}.npz") for x in "abc")
    assert cli.main(["run", "--n", "600", "--steps", "4", "--checkpoint", a,
                     "--quiet", *common]) == 0
    assert cli.main(["run", "--resume", a, "--steps", "2", "--checkpoint", b,
                     "--quiet", "--device", "cpu"]) == 0
    assert cli.main(["run", "--n", "600", "--steps", "6", "--checkpoint", c,
                     "--quiet", *common]) == 0
    with np.load(b) as zb, np.load(c) as zc:
        assert int(zb["step"]) == int(zc["step"]) == 6
        for k in ("pos", "vel", "acc"):
            np.testing.assert_array_equal(zb[k], zc[k])
    capsys.readouterr()
    assert cli.main(["bench", "--n", "600", "--steps", "2", *common]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["impl"] == "pallas_sym" and res["finite"]
    assert not res["resident"]
