"""The ``run`` slice as a whole on the CPU: the port's ``Simulation.run``
against the JAX package's from the same numpy state, checkpoints both
ways between the packages, resume bit-equality, the trajectory NPZ round
trip, and the ``run`` verb on ``--device cpu`` with its refusals.

Tolerances.  Port against JAX after a few steps: the 1% gate of ``nbody
validate`` with absolute floors of 1.0 (positions) and 1e-2 (velocities),
as ``test_torch_slice.py`` gates ``run_steps``; energies within 1e-9 (the
same float64 host sum of nearly equal states).  Checkpoint and trajectory
round trips, and resume against one uninterrupted run: exact.
"""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu import SimConfig as JaxSimConfig
from nbody_tpu import SimState as JaxSimState
from nbody_tpu.io import checkpoint as jax_ckpt
from nbody_tpu.models.simulation import Simulation as JaxSimulation
from nbody_tpu.models.state import state_to_numpy as jax_state_to_numpy
from nbody_tpu.oracle.numpy_oracle import assert_matches_oracle
from nbody_tpu_torch import cli
from nbody_tpu_torch.io import checkpoint as port_ckpt
from nbody_tpu_torch.io.logger import RunLogger
from nbody_tpu_torch.models.simulation import auto_log_every

N = 256


def _arrays(seed):
    pos, vel, mass = make_small_system(N, seed=seed)
    return {"pos": pos, "vel": vel, "acc": np.zeros_like(pos), "mass": mass}


def _jax_state(arrays):
    return JaxSimState(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("integrator", ["reference", "yoshida4"])
@pytest.mark.parametrize("impl,resident", [("xla_nxn", None),
                                           ("pallas_sym2", True)])
def test_simulation_run_matches_jax(impl, resident, integrator, tmp_path):
    arrays = _arrays(seed=91)
    jax_cfg = JaxSimConfig(n_bodies=N, impl="xla_nxn", integrator=integrator,
                           resident=False)
    jax_res = JaxSimulation(jax_cfg, state=_jax_state(arrays)).run(
        n_steps=6, log_every=2, track_energy=True)
    cfg = nt.SimConfig(n_bodies=N, impl=impl, integrator=integrator,
                       resident=resident, device="cpu")
    log = tmp_path / "log.jsonl"
    with RunLogger(jsonl_path=str(log), quiet=True) as logger:
        sim = nt.Simulation(cfg, state=nt.state_from_numpy(arrays,
                                                           device="cpu"),
                            logger=logger)
        assert sim._resident is bool(resident)
        res = sim.run(n_steps=6, log_every=2, track_energy=True)
    assert isinstance(res, nt.SimResult) and res.steps_run == 6
    assert sim.step_count == 6 and res.ms_per_step > 0
    got, want = nt.state_to_numpy(res.state), jax_state_to_numpy(
        jax_res.state)
    assert_matches_oracle(got["pos"], want["pos"], "pos", abs_tol=1.0)
    assert_matches_oracle(got["vel"], want["vel"], "vel", abs_tol=1e-2)
    assert res.energy_initial == pytest.approx(jax_res.energy_initial,
                                               rel=1e-9)
    assert res.energy_drift == pytest.approx(jax_res.energy_drift,
                                             rel=1e-2, abs=1e-9)
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in records] == [4, 6, 6]
    assert set(records[0]) == {"step", "sim_time", "ms_per_step",
                               "steps_per_s", "ginter_per_s"}
    assert records[-1]["energy_drift"] == res.energy_drift


def test_jax_checkpoint_resumes_in_port_and_back(tmp_path):
    arrays = _arrays(seed=92)
    path = str(tmp_path / "jax.npz")
    # A JAX config that carries the huge-N execution modes: both are
    # carried, so the resume is flat and bounded (flat needs a pallas_sym*
    # impl in both packages).
    jax_cfg = JaxSimConfig(n_bodies=N, impl="pallas_sym2", dt=0.05,
                           eps2=0.003, flat_state=True, prog_cap=1e15)
    jax_ckpt.save_checkpoint(path, _jax_state(arrays), 7, jax_cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sim = nt.Simulation.resume(path, device="cpu")
    assert sim.step_count == 7 and sim.cfg.device == "cpu"
    assert (sim.cfg.dt, sim.cfg.eps2, sim.cfg.impl) == (0.05, 0.003,
                                                        "pallas_sym2")
    assert sim.cfg.flat_state is True and sim.cfg.prog_cap == 1e15
    assert sim._flat and sim._use_multiprog
    for k, v in nt.state_to_numpy(sim.state).items():
        np.testing.assert_array_equal(v.reshape(arrays[k].shape), arrays[k])
    sim.run(n_steps=2, checkpoint_path=str(tmp_path / "port.npz"))
    state, step, cfg = jax_ckpt.load_checkpoint(str(tmp_path / "port.npz"))
    assert step == 9 and cfg.dt == 0.05 and cfg.eps2 == 0.003
    assert cfg.flat_state is True and cfg.prog_cap == 1e15
    for k, v in nt.state_to_numpy(sim.state).items():
        np.testing.assert_array_equal(np.asarray(getattr(state, k)),
                                      v.reshape(np.asarray(
                                          getattr(state, k)).shape))
    step, cfg, n = port_ckpt.load_checkpoint_meta(str(tmp_path / "port.npz"))
    assert (step, n, cfg.device) == (9, N, "cpu")


@pytest.mark.parametrize("integrator", ["reference", "kdk"])
def test_resume_equals_one_uninterrupted_run(integrator, tmp_path):
    """Chunks cut by a checkpoint cadence and a resume give the steps of
    one run, bit for bit (resident route)."""
    arrays = _arrays(seed=93)
    cfg = nt.SimConfig(n_bodies=N, impl="pallas_sym2", resident=True,
                       integrator=integrator, device="cpu")
    one = nt.Simulation(cfg, state=nt.state_from_numpy(arrays, device="cpu"))
    one.run(n_steps=6, log_every=0)
    path = str(tmp_path / "c.npz")
    first = nt.Simulation(cfg, state=nt.state_from_numpy(arrays,
                                                         device="cpu"))
    first.run(n_steps=4, log_every=0, checkpoint_path=path,
              checkpoint_every=3)
    assert port_ckpt.load_checkpoint_meta(path)[0] == 4
    again = nt.Simulation.resume(path, cfg=cfg, overrides={})
    again.run(n_steps=2, log_every=0)
    assert again.step_count == 6
    for k in ("pos", "vel", "acc"):
        assert torch.equal(getattr(again.state, k), getattr(one.state, k)), k


def test_trajectory_npz_round_trip_between_packages(tmp_path):
    arrays = _arrays(seed=94)
    cfg = nt.SimConfig(n_bodies=N, device="cpu")
    state = nt.state_from_numpy(arrays, device="cpu")
    final, snaps, vsnaps = nt.ops.step.run_trajectory(
        state, cfg, 5, snap_every=2, with_vel=True)
    assert snaps.shape == (2, N, 3) and vsnaps.shape == (2, N, 3)
    assert torch.equal(final.pos, nt.run_steps(state, cfg, 5).pos)
    path = str(tmp_path / "t.npz")
    port_ckpt.save_trajectory(path, snaps, 2, cfg, mass=state.mass,
                              vel_snapshots=vsnaps)
    for load in (jax_ckpt.load_trajectory_full,
                 port_ckpt.load_trajectory_full):
        s, v, m, every, c = load(path)
        np.testing.assert_array_equal(s, snaps.numpy())
        np.testing.assert_array_equal(v, vsnaps.numpy())
        np.testing.assert_array_equal(m, arrays["mass"])
        assert every == 2 and c.n_bodies == N
    # Streamed layout, written by each package and read by the other.
    for writer, load in ((port_ckpt.TrajectoryWriter,
                          jax_ckpt.load_trajectory),
                         (jax_ckpt.TrajectoryWriter,
                          port_ckpt.load_trajectory)):
        spath = str(tmp_path / f"s_{writer.__module__}.npz")
        with writer(spath, 3, mass=arrays["mass"]) as tw:
            for k in range(2):
                tw.append(snaps[k].numpy())
        s, m, every = load(spath)
        assert len(s) == 2 and every == 3
        np.testing.assert_array_equal(s[1], snaps[1].numpy())
        np.testing.assert_array_equal(m, arrays["mass"])


def test_cli_run_on_cpu(tmp_path, capsys):
    ck, log = str(tmp_path / "c.npz"), str(tmp_path / "l.jsonl")
    base = ["--n", "256", "--device", "cpu"]
    assert cli.main(["run", "--steps", "8", "--checkpoint", ck,
                     "--log-jsonl", log, "--log-every", "2", *base]) == 0
    assert "Simulation complete: 8 steps" in capsys.readouterr().out
    assert json.loads(open(log).readline())["step"] == 4
    assert cli.main(["run", "--resume", ck, "--steps", "3", "--energy",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "steps=3" in out and "energy drift" in out
    assert cli.main(["run", "--steps", "3", "--resident", "on", "--impl",
                     "pallas_sym2", *base]) == 0
    assert "(resident)" in capsys.readouterr().out
    traj = str(tmp_path / "t.npz")
    assert cli.main(["run", "--steps", "4", "--save-trajectory", traj,
                     "--snap-every", "2", *base]) == 0
    assert port_ckpt.load_trajectory(traj)[0].shape == (2, 256, 3)
    prof = str(tmp_path / "prof")
    assert cli.main(["run", "--steps", "2", "--profile", prof, "--quiet",
                     *base]) == 0
    assert (tmp_path / "prof" / "trace.json").exists()
    with pytest.raises(ValueError, match="out of scope"):
        cli.main(["run", "--steps", "2", "--resident", "on", "--impl",
                  "xla", *base])


@pytest.mark.parametrize("flags,item", [
    (["--viz"], "item 12"), (["--viz-avi", "v.avi"], "item 12"),
    (["--viz-serve", "0"], "item 12")])
def test_cli_run_refuses_unported_flags(flags, item, capsys, tmp_path,
                                        monkeypatch):
    """The viz sinks of ROADMAP item 12 were refused until they were
    ported; each now runs and streams its frame."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["run", "--n", "64", "--steps", "1", "--device", "cpu",
                     *flags]) == 0
    captured = capsys.readouterr()
    assert item not in captured.err
    assert "1 frames" in captured.out


def test_cli_run_shards_rdma_on_cpu(capsys):
    """``run --shards 2 --comm rdma`` runs the fused ring K13's twin."""
    assert cli.main(["run", "--n", "64", "--steps", "2", "--device", "cpu",
                     "--shards", "2", "--comm", "rdma"]) == 0
    out = capsys.readouterr().out
    assert "comm=rdma" in out and "impl=pallas_sym2" in out


def test_auto_log_every_prefers_divisors():
    cfg = nt.SimConfig(n_bodies=1 << 20)
    per_step = auto_log_every(cfg, 1000)
    assert 1000 % per_step == 0 and per_step < 1000
    assert auto_log_every(nt.SimConfig(n_bodies=8192), 1000) >= 1000
    # A frame streamer, refused until ROADMAP item 12, now gets a frame.
    frames = []
    sink = type("Sink", (), {"submit": lambda self, i, f: frames.append(i)})
    nt.Simulation(nt.SimConfig(n_bodies=64, device="cpu")).run(
        1, frame_streamer=sink())
    assert frames == [0]
