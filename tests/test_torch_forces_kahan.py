"""K11 (``pallas_kahan``, the exact one-sided tile with Kahan-compensated
accumulation across j-tiles) of the PyTorch port against the JAX
package's ``forces_pallas(variant="vpu_kahan")`` and the float64 oracle,
and through ``run_steps`` and the CLI.

On the CPU the wrapper runs the kernel's plain twin (K1's 128-wide
j-tiles, each tile's sum two-summed into the running sum); the JAX side
runs Pallas in interpret mode at ``block_j=128``, so both compensate
across the same tiles.  Tolerances: the exact tier's rel 1e-4 +
1e-6·max|a| against JAX, the oracle's 1% gate, and, as the JAX package's
own test asks (``tests/test_pallas.py::test_pallas_kahan_matches_oracle``),
a largest error against the oracle no worse than 1.5 times K1's.
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
                                              forces_tiled_kahan,
                                              rect_forces_tiled_kahan,
                                              rect_forces_tiled_plain)

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
