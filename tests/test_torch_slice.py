"""The port's main path as a whole on the CPU: ``run_steps`` against the
JAX package from the same numpy state, the state round trip, the copied
oracle / energy / analysis against their originals, the CLI, and the
package importing without JAX.

The port runs the kernels' plain twins here (``device="cpu"``); the JAX
side runs Pallas in interpret mode.  Step gates are those of
``tests/test_pallas_sym.py::test_sym_in_step_loop``: the 1% relative
gate with absolute floors of 1.0 for positions and 1e-2 for velocities.
"""

import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu import SimState as JaxSimState
from nbody_tpu import run_steps as jax_run_steps
from nbody_tpu.analysis import angular_momentum as jax_angular_momentum
from nbody_tpu.models.energy import energy_f64 as jax_energy_f64
from nbody_tpu.models.state import pad_state_to as jax_pad_state_to
from nbody_tpu.models.state import state_from_numpy as jax_state_from_numpy
from nbody_tpu.models.state import state_to_numpy as jax_state_to_numpy
from nbody_tpu.oracle import numpy_oracle as jax_oracle
from nbody_tpu_torch import analysis, cli
from nbody_tpu_torch.models.energy import energy_f64
from nbody_tpu_torch.models.state import pad_state_to, round_up, unpad_state
from nbody_tpu_torch.oracle import numpy_oracle as port_oracle

EPS2 = 0.002


@pytest.mark.parametrize("impl", ["pallas", "pallas_sym2", "xla"])
def test_run_steps_matches_jax_and_oracle(impl):
    n, steps = 512, 5
    pos, vel, mass = make_small_system(n, seed=61)
    jax_cfg = JaxSimConfig(n_bodies=n, impl=impl, block_i=64, block_j=128,
                           block_u=128, resident=False)
    jax_out = jax_run_steps(
        JaxSimState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                    acc=jnp.zeros((n, 3), jnp.float32),
                    mass=jnp.asarray(mass)), jax_cfg, steps)
    cfg = nt.SimConfig(n_bodies=n, impl=impl, device="cpu")
    state = nt.state_from_numpy(
        {"pos": pos, "vel": vel, "acc": np.zeros_like(pos), "mass": mass},
        device="cpu")
    out = nt.state_to_numpy(nt.run_steps(state, cfg, steps))
    rpos, rvel, racc = jax_oracle.oracle_run(pos, vel, mass, EPS2, cfg.dt,
                                             steps)
    for what, ref in (("JAX", jax_state_to_numpy(jax_out)),
                      ("oracle", {"pos": rpos, "vel": rvel, "acc": racc})):
        jax_oracle.assert_matches_oracle(out["pos"], ref["pos"],
                                         f"pos vs {what} ({impl})",
                                         abs_tol=1.0)
        jax_oracle.assert_matches_oracle(out["vel"], ref["vel"],
                                         f"vel vs {what} ({impl})",
                                         abs_tol=1e-2)


def test_state_numpy_round_trip_between_packages():
    pos, vel, mass = make_small_system(100, seed=62)
    arrays = {"pos": pos, "vel": vel + 1.5, "acc": pos * 1e-3, "mass": mass}
    jax_state = jax_state_from_numpy(arrays)
    port = nt.state_from_numpy(jax_state_to_numpy(jax_state), device="cpu")
    assert port.n == 100 and port.pos.dtype == torch.float32
    back = nt.state_to_numpy(port)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    again = jax_state_to_numpy(jax_state_from_numpy(back))
    for k, v in arrays.items():
        np.testing.assert_array_equal(again[k], v)
    # Zero-mass ghost padding, as the JAX package pads.
    n_pad = round_up(100, 64)
    padded = nt.state_to_numpy(pad_state_to(port, n_pad))
    jax_padded = jax_state_to_numpy(jax_pad_state_to(jax_state, n_pad))
    for k in arrays:
        np.testing.assert_array_equal(padded[k], jax_padded[k])
    assert unpad_state(pad_state_to(port, n_pad), 100).n == 100
    with pytest.raises(ValueError):
        pad_state_to(port, 50)


def test_copied_oracle_energy_and_analysis_equal_originals():
    pos, vel, mass = make_small_system(200, seed=63)
    vel = vel + np.random.default_rng(1).normal(size=vel.shape).astype(
        np.float32)
    np.testing.assert_array_equal(port_oracle.oracle_forces(pos, mass, EPS2),
                                  jax_oracle.oracle_forces(pos, mass, EPS2))
    for integrator in ("reference", "kdk", "yoshida4"):
        for a, b in zip(port_oracle.oracle_run(pos, vel, mass, EPS2, 0.1, 3,
                                               integrator=integrator),
                        jax_oracle.oracle_run(pos, vel, mass, EPS2, 0.1, 3,
                                              integrator=integrator)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        port_oracle.relative_mismatch(pos, pos * 1.001),
        jax_oracle.relative_mismatch(pos, pos * 1.001))
    host = nt.SimState(pos=pos, vel=vel, acc=np.zeros_like(pos), mass=mass)
    assert energy_f64(host, EPS2) == jax_energy_f64(
        JaxSimState(pos=pos, vel=vel, acc=np.zeros_like(pos), mass=mass),
        EPS2)
    np.testing.assert_array_equal(analysis.angular_momentum(pos, vel, mass),
                                  jax_angular_momentum(pos, vel, mass))


@pytest.mark.parametrize("impl", ["auto", "pallas", "pallas_sym2"])
def test_cli_validate_on_cpu(impl, capsys):
    rc = cli.main(["validate", "--n", "256", "--long-steps", "0",
                   "--impl", impl, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Verification PASSED" in out
    assert "[OK ] pos: 0.0000%" in out


def test_cli_validate_long_horizon_and_refusals(capsys):
    rc = cli.main(["validate", "--n", "256", "--steps", "5",
                   "--long-steps", "10", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[OK ] momentum" in out and "[OK ] angular momentum" in out
    # --init presets are ported: validate starts from the preset.
    assert cli.main(["validate", "--n", "256", "--init", "plummer",
                     "--steps", "5", "--long-steps", "0", "--dt", "0.001",
                     "--device", "cpu"]) == 0
    assert cli.main(["validate", "--n", "256", "--steps", "5",
                     "--long-steps", "10", "--oracle", "native",
                     "--device", "cpu"]) == 0
    assert cli.main(["validate", "--n", "256", "--steps", "5",
                     "--long-steps", "0", "--shards", "2", "--comm", "rdma",
                     "--device", "cpu"]) == 0
    assert cli.main(["validate", "--n", "256", "--shards", "2",
                     "--long-steps", "0", "--device", "cpu"]) == 0


def test_cli_bench_on_cpu_has_jax_keys(capsys):
    rc = cli.main(["bench", "--n", "256", "--steps", "2", "--trials", "3",
                   "--device", "cpu"])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "n_bodies",
                "steps", "trials", "impl", "ms_per_step", "ginter_min",
                "ginter_max", "spread_pct", "compile_plus_warmup_s",
                "compile_s", "first_touch_s", "backend", "devices",
                "shards", "flat", "resident", "finite"):
        assert key in res, key
    assert res["vs_baseline"] is None and res["backend"] == "cpu"
    assert res["steps"] == 2 and res["trials"] == 3 and res["finite"]
    assert res["impl"] == "xla_nxn"


def test_cli_info_names_the_device(capsys):
    assert cli.main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out
    assert ("(gpu)" if torch.cuda.is_available() else "(cpu)") in out


def test_package_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import nbody_tpu_torch, nbody_tpu_torch.cli, "
        "nbody_tpu_torch.bench_lib, nbody_tpu_torch.analysis\n"
        "from nbody_tpu_torch.ops import _build, forces_sym, forces_tiled\n"
        "from nbody_tpu_torch.ops import resident, pe\n"
        "from nbody_tpu_torch.ops import forces_sym_tc, forces_tiled_tc\n"
        "from nbody_tpu_torch.ops import forces_fast\n"
        "from nbody_tpu_torch.models import ordering\n"
        "from nbody_tpu_torch.models import simulation, energy\n"
        "from nbody_tpu_torch.io import checkpoint, logger\n"
        "assert not any(m == 'nbody_tpu' or m.startswith('nbody_tpu.') "
        "for m in sys.modules)\n"
        "assert not _build._LIBS\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        nt.init_state(nt.SimConfig(n_bodies=64, device="cuda"))
