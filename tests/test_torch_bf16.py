"""A bfloat16 state on the host: the port's host copies, energy, oracle
gates, checkpoints and trajectories, and checkpoints shared with the JAX
package, on the CPU at N = 96.

NumPy has no bfloat16.  The port's host arithmetic upcasts to float32
(exactly), and its NPZ files store bf16 arrays as the JAX package's do:
``np.asarray`` of a JAX bf16 array is 2-byte records (ml_dtypes), which
``np.savez`` writes as ``|V2``.  The port writes the same bytes under the
same dtype and reads ``|V2`` back as bf16.  The JAX loader itself cannot
read such a file (``jnp.asarray`` refuses ``|V2``, a fault of the
reference that is not copied); its metadata reader can, and the bytes are
compared with the file JAX writes.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu import SimState as JaxSimState
from nbody_tpu.io.checkpoint import load_checkpoint_meta as jax_meta
from nbody_tpu.io.checkpoint import save_checkpoint as jax_save
from nbody_tpu.models.energy import energy_f64 as jax_energy
from nbody_tpu_torch import cli
from nbody_tpu_torch.io import checkpoint as port_ckpt
from nbody_tpu_torch.models.energy import energy_f64

N = 96


def bf16_arrays(seed=7):
    pos, vel, mass = make_small_system(N, seed=seed)
    vel = pos * 1e-6
    acc = pos * -1e-9
    return [a.astype(ml_dtypes.bfloat16) for a in (pos, vel, acc, mass)]


def port_state(arrs):
    return nt.SimState(*(torch.from_numpy(a.astype(np.float32)).to(
        torch.bfloat16) for a in arrs))


def test_host_copies_upcast_to_float32():
    arrs = bf16_arrays()
    state = port_state(arrs)
    host = nt.state_to_numpy(state)
    for k, a in zip(("pos", "vel", "acc", "mass"), arrs):
        assert host[k].dtype == np.float32
        np.testing.assert_array_equal(host[k], a.astype(np.float32))
    # The float64 energy of the bf16 values, as JAX computes it.
    jstate = JaxSimState(*(jnp.asarray(a) for a in arrs))
    assert energy_f64(state, 0.002) == pytest.approx(
        jax_energy(jstate, 0.002), rel=1e-12)


def test_checkpoint_bytes_equal_jax_and_round_trip(tmp_path):
    arrs = bf16_arrays()
    cfg = nt.SimConfig(n_bodies=N, dtype="bfloat16", device="cpu")
    port_file, jax_file = tmp_path / "p.npz", tmp_path / "j.npz"
    port_ckpt.save_checkpoint(str(port_file), port_state(arrs), 5, cfg)
    jax_save(str(jax_file), JaxSimState(*(jnp.asarray(a) for a in arrs)), 5,
             JaxSimConfig(n_bodies=N, dtype="bfloat16"))
    with np.load(port_file) as zp, np.load(jax_file) as zj:
        for k in ("pos", "vel", "acc", "mass"):
            assert zp[k].dtype == zj[k].dtype == np.dtype("V2")
            assert zp[k].shape == zj[k].shape
            assert zp[k].tobytes() == zj[k].tobytes(), k
    # The JAX package reads the port's file's metadata.
    step, jcfg, n = jax_meta(str(port_file))
    assert (step, n, jcfg.dtype) == (5, N, "bfloat16")
    state, step, rcfg = port_ckpt.load_checkpoint(str(port_file),
                                                  device="cpu")
    assert step == 5 and rcfg.dtype == "bfloat16"
    for got, want in zip(state, port_state(arrs)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_port_resumes_a_jax_bf16_checkpoint(tmp_path):
    arrs = bf16_arrays(seed=8)
    path = str(tmp_path / "j.npz")
    jax_save(path, JaxSimState(*(jnp.asarray(a) for a in arrs)), 3,
             JaxSimConfig(n_bodies=N, dtype="bfloat16", impl="xla"))
    sim = nt.Simulation.resume(path, device="cpu")
    assert sim.step_count == 3 and sim.cfg.dtype == "bfloat16"
    assert torch.equal(sim.state.pos, port_state(arrs).pos)
    res = sim.run(2, log_every=0, track_energy=True)
    assert sim.state.pos.dtype == torch.bfloat16 and sim.step_count == 5
    assert np.isfinite(res.energy_drift)


def test_cli_bf16_run_with_energy_checkpoint_and_trajectory(tmp_path,
                                                            capsys):
    base = ["--n", str(N), "--dtype", "bfloat16", "--device", "cpu"]
    ck = str(tmp_path / "c.npz")
    assert cli.main(["run", "--steps", "4", "--energy", "--checkpoint", ck,
                     "--checkpoint-every", "2", *base]) == 0
    assert "energy drift" in capsys.readouterr().out
    assert cli.main(["run", "--resume", ck, "--steps", "2", "--energy",
                     "--device", "cpu"]) == 0
    traj = str(tmp_path / "t.npz")
    assert cli.main(["run", "--steps", "4", "--save-trajectory", traj,
                     "--snap-every", "2", "--traj-vel", *base]) == 0
    with np.load(traj) as z:    # JAX's one-device layout: one array
        assert "snapshots" in z.files
    snaps, vel, mass, every, cfg = port_ckpt.load_trajectory_full(traj)
    assert snaps.shape == (2, N, 3) and snaps.dtype == np.dtype("V2")
    assert np.isfinite(snaps.view(ml_dtypes.bfloat16).astype(
        np.float32)).all()
    assert vel.shape == (2, N, 3) and every == 2
    assert cfg.dtype == "bfloat16"


# Port against JAX, bf16 run_steps on the same arrays: per component of
# pos, vel and acc within 2^-6 (four bf16 epsilons of 2^-8) of the
# quantity's largest |value|.  Both packages compute every op in bf16 and
# differ in where a sum rounds; at N = 96 over 10 steps they differ by up
# to 1.15e-2 of the largest |vel| (xla_nxn) and 7.7e-3 of the largest |acc|
# (xla), while either differs from its own float32 run by up to 5.8e-2
# (xla's matmul form cancels in bf16).  A wrong mass or a lost term moves a
# component by O(1) of the largest.
BF16_PARITY_TOL = 2.0 ** -6


@pytest.mark.parametrize("impl", ["xla", "xla_nxn"])
def test_bf16_run_steps_matches_jax(impl):
    import nbody_tpu as jt
    jcfg = JaxSimConfig(n_bodies=N, dtype="bfloat16", impl=impl)
    pcfg = nt.SimConfig(n_bodies=N, dtype="bfloat16", impl=impl,
                        device="cpu")
    jstate = jt.init_state(jcfg)
    arrs = [np.asarray(a) for a in jstate]
    want = jt.run_steps(jstate, jcfg, 10)
    got = nt.run_steps(port_state(arrs), pcfg, 10)
    for k, g, w in zip(("pos", "vel", "acc", "mass"), got, want):
        assert g.dtype == torch.bfloat16, k
        g = g.float().numpy().astype(np.float64)
        w = np.asarray(w).astype(np.float64)
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= BF16_PARITY_TOL * scale, (
            k, np.abs(g - w).max() / scale)
    np.testing.assert_array_equal(got.mass.float().numpy(),
                                  arrs[3].astype(np.float32))


def test_cli_bf16_validate(capsys):
    """``validate --dtype bfloat16`` runs its gates on float32 host copies
    and passes at the allowances the JAX package's own bf16 validate passes
    on the same command line.  bf16's 8-bit mantissa moves components past
    the 1% gate within ten steps: at N = 96, seed 0, JAX's validate reads
    pos 0, vel 0 and acc 37 of 288 components outside 1% (12.85%), the
    port's 0, 3 (1.04%) and 38 (13.19%).  The allowances sit just above
    both: 0.02 for pos and vel, 0.15 for acc."""
    from nbody_tpu import cli as jax_cli
    argv = ["validate", "--n", str(N), "--dtype", "bfloat16",
            "--long-steps", "5", "--max-bad-frac", "0.02",
            "--max-bad-frac-acc", "0.15"]
    assert jax_cli.main(argv) == 0, capsys.readouterr().out
    capsys.readouterr()
    rc = cli.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[OK ] energy" in out and "Verification PASSED" in out
    # At the exact tier's default allowances it reports, not raises.
    assert cli.main(["validate", "--n", str(N), "--dtype", "bfloat16",
                     "--device", "cpu", "--long-steps", "0"]) in (0, 1)
    assert "Verification" in capsys.readouterr().out


@pytest.mark.parametrize("comm", ["ring", "allgather"])
def test_cli_bf16_sharded_run(comm, tmp_path, capsys):
    """A bf16 state on a mesh: the plain path's rect form per shard (the
    kernels are float32-only), gathered for energy and checkpoint."""
    ck = str(tmp_path / "c.npz")
    assert cli.main(["run", "--n", str(N), "--dtype", "bfloat16", "--device",
                     "cpu", "--shards", "2", "--comm", comm, "--steps", "2",
                     "--energy", "--checkpoint", ck]) == 0
    assert "mesh: 2 shards" in capsys.readouterr().out
    state, step, _ = port_ckpt.load_checkpoint(ck, device="cpu")
    assert step == 2 and state.pos.dtype == torch.bfloat16
    assert bool(torch.isfinite(state.pos.float()).all())
