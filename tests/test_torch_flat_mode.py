"""The port's flat state (``FlatState``, ``should_use_flat``, the
``*_flat`` entry points) against its regular ``(N, 3)`` path and against
the JAX package's flat mode, the cases of ``tests/test_flat_mode.py``.

The port's flat state is the ``(3N,)`` view of the ``(N, 3)`` tensors, so
every flat result must equal the regular path's bit for bit.  Against the
JAX package (``run_steps_flat`` with ``pallas_sym`` in interpret mode, the
geometry ``CFG_KW`` of ``test_flat_mode.py``), from the same numpy state:
per component rel 1e-4 + 1e-6·max|x| after two steps.  Routing
(``should_use_flat``) is compared with JAX's on a grid of sizes up to
33.5M, plans only.
"""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu_torch as nt
from conftest import make_small_system
from nbody_tpu.config import SimConfig as JaxSimConfig
from nbody_tpu.io import checkpoint as jax_ckpt
from nbody_tpu.models.state import FlatState as JaxFlatState
from nbody_tpu.ops.step import run_steps_flat as jax_run_steps_flat
from nbody_tpu.ops.step import should_use_flat as jax_should_use_flat
from nbody_tpu.viz.raster import render_weights_flat as jax_render_flat
from nbody_tpu_torch.cli import main as cli_main
from nbody_tpu_torch.io import checkpoint as port_ckpt
from nbody_tpu_torch.io.logger import RunLogger
from nbody_tpu_torch.models.energy import (energy_f64, total_energy_bounded,
                                           total_energy_bounded_flat)
from nbody_tpu_torch.models.init import init_state_flat
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.models.state import (FlatState, flat_from_state,
                                          is_flat, state_from_flat)
from nbody_tpu_torch.ops.step import (FLAT_AUTO_THRESHOLD, prime_kdk_flat,
                                      run_steps_flat, run_steps_multiprog,
                                      should_use_flat)
from nbody_tpu_torch.parallel.mesh import make_mesh
from nbody_tpu_torch.viz.raster import render_weights, render_weights_flat

N = 1000
CFG_KW = dict(n_bodies=N, impl="pallas_sym", prog_cap=5e5, steps=3)
JAX_GEOM = dict(block_i=8, block_u=128, panel_nb=3)
SIZES = (N, 1 << 22, FLAT_AUTO_THRESHOLD, FLAT_AUTO_THRESHOLD + 1,
         33_554_432)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Every case runs small sweeps on the CPU: torch's intra-op threads
    only contend with the other test workers' there."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _cfg(flat, **kw):
    return nt.SimConfig(flat_state=flat, device="cpu", **{**CFG_KW, **kw})


def _arrays(seed, n=N):
    pos, vel, mass = make_small_system(n, seed=seed)
    return {"pos": pos, "vel": vel, "acc": np.zeros_like(pos), "mass": mass}


def _close(got, want, what):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-4 * np.abs(w) + 1e-6 * np.abs(w).max()
    bad = np.abs(g - w) > tol
    assert not bad.any(), (f"{what}: {int(bad.sum())} components outside "
                           f"rel 1e-4 + 1e-6*max")


@pytest.mark.parametrize("impl", ["pallas_sym", "pallas_sym2",
                                  "pallas_sym_turbo", "pallas", "xla"])
def test_should_use_flat_equals_jax(impl):
    """The truth table of ``should_use_flat`` is JAX's (plans only)."""
    for n in SIZES:
        for flat in (None, True, False):
            kw = dict(n_bodies=n, impl=impl, flat_state=flat)
            try:
                want = jax_should_use_flat(JaxSimConfig(**kw), impl)
            except ValueError as e:
                with pytest.raises(ValueError, match="pallas_sym"):
                    should_use_flat(nt.SimConfig(**kw), impl)
                assert "pallas_sym" in str(e)
                continue
            assert should_use_flat(nt.SimConfig(**kw), impl) == want, kw


@pytest.mark.parametrize("integrator", ["reference", "kdk", "yoshida4"])
def test_simulation_flat_matches_regular(integrator):
    """Same seed, same steps: the flat Simulation (``(3N,)`` state) equals
    the regular bounded one bit for bit."""
    sim_f = Simulation(_cfg(True, integrator=integrator))
    sim_r = Simulation(_cfg(False, integrator=integrator))
    assert sim_f._flat and not sim_r._flat
    assert sim_f._use_multiprog and sim_r._use_multiprog
    assert sim_f.state.pos.shape == (3 * N,)
    res_f = sim_f.run(n_steps=2, log_every=0)
    res_r = sim_r.run(n_steps=2, log_every=0)
    for k in ("pos", "vel", "acc"):
        assert torch.equal(getattr(res_f.state, k).view(N, 3),
                           getattr(res_r.state, k)), k


@pytest.mark.parametrize("integrator", ["reference", "kdk"])
def test_run_steps_flat_matches_jax(integrator):
    """The port's flat loop against JAX's ``run_steps_flat`` from the same
    arrays (JAX's ``pallas_sym`` in interpret mode)."""
    arrs = _arrays(seed=51)
    jcfg = JaxSimConfig(**CFG_KW, **JAX_GEOM, integrator=integrator)
    pcfg = _cfg(True, integrator=integrator)
    jflat = JaxFlatState(*(jnp.asarray(arrs[k].reshape(-1)) if k != "mass"
                           else jnp.asarray(arrs[k])
                           for k in ("pos", "vel", "acc", "mass")))
    pflat = flat_from_state(nt.state_from_numpy(arrs, device="cpu"))
    if integrator != "reference":
        from nbody_tpu.ops.step import prime_kdk_flat as jax_prime_flat
        jflat = jax_prime_flat(jflat, jcfg)
        pflat = prime_kdk_flat(pflat, pcfg)
    jout = jax_run_steps_flat(jflat, jcfg, 2)
    pout = run_steps_flat(pflat, pcfg, 2)
    assert is_flat(pout) and pout.pos.shape == (3 * N,)
    for k in ("pos", "vel", "acc"):
        _close(getattr(pout, k).numpy(), np.asarray(getattr(jout, k)),
               f"flat {k}")


def test_flat_views_and_init():
    """``flat_from_state`` / ``state_from_flat`` are views of one memory;
    ``init_state_flat`` is ``init_state`` seen flat; float64 refused."""
    cfg = nt.SimConfig(n_bodies=300, device="cpu", seed=4)
    state = nt.init_state(cfg)
    flat = flat_from_state(state)
    assert flat.pos.data_ptr() == state.pos.data_ptr() and flat.n == 300
    back = state_from_flat(flat)
    assert back.vel.data_ptr() == state.vel.data_ptr()
    assert back.pos.shape == (300, 3) and not is_flat(back)
    born = init_state_flat(cfg)
    assert isinstance(born, FlatState) and is_flat(born)
    for k in ("pos", "vel", "acc", "mass"):
        assert torch.equal(getattr(born, k).reshape(getattr(state, k)
                                                    .shape),
                           getattr(state, k))
    with pytest.raises(ValueError, match="float32"):
        init_state_flat(cfg.replace(dtype="float64"))


def test_flat_checkpoint_resume_roundtrip(tmp_path):
    """A flat run's checkpoint is (N, 3) on disk; resume (flat, from the
    saved config) + continue == one flat run of all the steps; the flat
    load returns views."""
    ckpt = str(tmp_path / "flat.npz")
    Simulation(_cfg(True)).run(n_steps=2, log_every=0, checkpoint_path=ckpt)
    with np.load(ckpt) as z:
        assert z["pos"].shape == (N, 3) and int(z["step"]) == 2
    flat, step, cfg = port_ckpt.load_checkpoint(ckpt, device="cpu",
                                                flat=True)
    assert is_flat(flat) and step == 2 and cfg.flat_state is True
    resumed = Simulation.resume(ckpt, device="cpu")
    assert resumed._flat and resumed.step_count == 2
    res = resumed.run(n_steps=2, log_every=0)
    cont = Simulation(_cfg(True)).run(n_steps=4, log_every=0)
    assert torch.equal(res.state.pos, cont.state.pos)


def test_flat_energy_matches_regular():
    """The flat energy is the regular energy's launch on views: equal bit
    for bit; ``energy_f64`` takes a FlatState."""
    sim_f, sim_r = Simulation(_cfg(True)), Simulation(_cfg(False))
    e_flat = total_energy_bounded_flat(sim_f.state, 0.002)
    assert e_flat == total_energy_bounded(sim_r.state, 0.002)
    assert total_energy_bounded(sim_f.state, 0.002) == e_flat
    e_ref = energy_f64(sim_r.state, 0.002)
    assert energy_f64(sim_f.state, 0.002) == e_ref
    assert abs(e_flat - e_ref) / abs(e_ref) < 1e-3


def test_render_weights_flat_matches_regular_and_jax():
    pos, _, mass = make_small_system(N, seed=52)
    pt, mt = torch.from_numpy(pos), torch.from_numpy(mass)
    ref = render_weights(pt, mt, 1e5, 1e9, 2e5, 64, 48)
    flat = render_weights_flat(pt.reshape(-1), mt, 1e5, 1e9, 2e5, 64, 48)
    assert torch.equal(ref, flat)
    want = np.asarray(jax_render_flat(jnp.asarray(pos.reshape(-1)),
                                      jnp.asarray(mass), 1e5, 1e9, 2e5, 64,
                                      48, panel=256))
    np.testing.assert_array_equal(flat.numpy(), want)


def test_flat_simulation_boundary_frames():
    """A flat run renders a frame at each chunk end, equal to the regular
    bounded run's pixels."""
    frames = {}

    class Sink:
        frames_written = 0

        def __init__(self, key):
            self.key = key

        def submit(self, idx, frame):
            frames[self.key, idx] = np.asarray(frame)
            self.frames_written += 1

    for flat in (True, False):
        Simulation(_cfg(flat, viz_every=1)).run(
            n_steps=2, log_every=0, frame_streamer=Sink(flat))
    assert sorted(frames) == [(False, 0), (False, 1), (True, 0), (True, 1)]
    for i in range(2):
        assert frames[True, i].shape == (600, 800, 3)
        np.testing.assert_array_equal(frames[True, i], frames[False, i])


def test_cli_flat_run_with_services(tmp_path):
    """``run --flat-state on`` with checkpoints, energy, JSONL logging and
    frames through the CLI; the end state equals the regular run's."""
    out = {}
    for flat in ("on", "off"):
        ckpt = str(tmp_path / f"c_{flat}.npz")
        log = str(tmp_path / f"log_{flat}.jsonl")
        rc = cli_main(["run", "--n", str(N), "--steps", "2", "--impl",
                       "pallas_sym", "--flat-state", flat, "--prog-cap",
                       "5e5", "--checkpoint", ckpt, "--checkpoint-every",
                       "1", "--energy", "--log-jsonl", log, "--log-every",
                       "1", "--viz", "--viz-dir", str(tmp_path / flat),
                       "--device", "cpu", "--quiet"])
        assert rc == 0 and os.path.exists(log)
        assert len(os.listdir(tmp_path / flat)) == 2
        with np.load(ckpt) as z:
            assert z["pos"].shape == (N, 3) and int(z["step"]) == 2
            out[flat] = z["pos"]
    np.testing.assert_array_equal(out["on"], out["off"])


def test_flat_trajectory_capture_cli(tmp_path):
    """Flat ``--save-trajectory`` streams ``snap_*`` entries (the layout
    JAX writes on that route) equal to the regular bounded run's; the JAX
    loader reads them."""
    common = ["run", "--n", str(N), "--steps", "4", "--impl", "pallas_sym",
              "--prog-cap", "5e5", "--snap-every", "2", "--device", "cpu",
              "--quiet"]
    paths = {f: str(tmp_path / f"{f}.npz") for f in ("on", "off")}
    for f, p in paths.items():
        assert cli_main(common + ["--flat-state", f, "--save-trajectory",
                                  p]) == 0
    with np.load(paths["on"]) as z:
        assert "snap_000001" in z.files and "snapshots" not in z.files
    sf, _, _ = jax_ckpt.load_trajectory(paths["on"])
    sr, _, _ = port_ckpt.load_trajectory(paths["off"])
    assert len(sf) == len(sr) == 2
    for k in range(2):
        np.testing.assert_array_equal(sf[k], sr[k])


def test_cli_flat_resume(tmp_path):
    """CLI ``--resume`` restores a flat run through the metadata and
    continues bit-identically to an uninterrupted run."""
    ckpt = str(tmp_path / "r.npz")
    common = ["--n", str(N), "--impl", "pallas_sym", "--flat-state", "on",
              "--prog-cap", "5e5", "--device", "cpu", "--quiet"]
    assert cli_main(["run", "--steps", "2", "--checkpoint", ckpt]
                    + common) == 0
    assert cli_main(["run", "--resume", ckpt, "--steps", "2",
                     "--checkpoint", ckpt] + common) == 0
    res = Simulation(_cfg(True)).run(n_steps=4, log_every=0)
    with np.load(ckpt) as z:
        assert int(z["step"]) == 4
        np.testing.assert_array_equal(z["pos"], res.state.pos.view(N, 3))


def test_resume_flat_checkpoint_with_mesh(tmp_path):
    """A flat checkpoint resumed onto a mesh loads the (N, 3) layout, its
    saved flat_state cleared with a warning; flat + mesh asked for
    explicitly is refused."""
    ckpt = str(tmp_path / "f.npz")
    Simulation(_cfg(True)).run(n_steps=1, log_every=0, checkpoint_path=ckpt)
    with pytest.warns(UserWarning, match="single-device"):
        sim = Simulation.resume(ckpt, device="cpu",
                                mesh=make_mesh(2, "cpu"))
    assert not sim._flat and sim.state.pos.dim() == 2
    assert sim.run(n_steps=1, log_every=0).steps_run == 1
    with pytest.raises(ValueError, match="unnecessary by design"):
        Simulation(_cfg(True), mesh=make_mesh(2, "cpu"))


def test_flat_state_into_non_flat_simulation_converts():
    """A FlatState handed to a non-flat Simulation becomes its (N, 3)
    views, and the reverse."""
    flat = init_state_flat(_cfg(True))
    sim = Simulation(_cfg(False), state=flat)
    assert sim.state.pos.shape == (N, 3)
    assert sim.state.pos.data_ptr() == flat.pos.data_ptr()
    assert sim.run(n_steps=1, log_every=0).steps_run == 1
    regular = nt.init_state(_cfg(False))
    assert is_flat(Simulation(_cfg(True), state=regular).state)


def test_jax_flat_checkpoint_resumes_flat_in_port_and_back(tmp_path):
    """A JAX flat run's checkpoint (its config with flat_state=True and a
    prog_cap) resumes flat in the port with both fields carried, and the
    port's flat checkpoint resumes flat in the JAX package."""
    arrs = _arrays(seed=53)
    path = str(tmp_path / "jax.npz")
    jcfg = JaxSimConfig(**CFG_KW, flat_state=True, dt=0.05)
    jflat = JaxFlatState(*(jnp.asarray(arrs[k].reshape(-1)) if k != "mass"
                           else jnp.asarray(arrs[k])
                           for k in ("pos", "vel", "acc", "mass")))
    jax_ckpt.save_checkpoint(path, jflat, 5, jcfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sim = Simulation.resume(path, device="cpu")
    assert sim._flat and sim._use_multiprog and sim.step_count == 5
    assert (sim.cfg.flat_state, sim.cfg.prog_cap, sim.cfg.dt) == (
        True, 5e5, 0.05)
    np.testing.assert_array_equal(sim.state.pos.numpy(),
                                  arrs["pos"].reshape(-1))
    out = str(tmp_path / "port.npz")
    sim.run(n_steps=1, log_every=0, checkpoint_path=out)
    from nbody_tpu.models.simulation import Simulation as JaxSimulation
    back = JaxSimulation.resume(out)
    assert back._flat and back.step_count == 6
    assert back.cfg.prog_cap == 5e5
    np.testing.assert_array_equal(np.asarray(back.state.pos),
                                  sim.state.pos.numpy())


def test_run_steps_flat_equals_regular_multiprog():
    """``run_steps_flat`` is ``run_steps_multiprog`` on the views."""
    cfg = _cfg(True)
    state = nt.state_from_numpy(_arrays(seed=54), device="cpu")
    reg = run_steps_multiprog(state, cfg, 2)
    flat = run_steps_flat(flat_from_state(state), cfg, 2)
    for k in ("pos", "vel", "acc"):
        assert torch.equal(getattr(flat, k).view(N, 3), getattr(reg, k))
    assert isinstance(flat, FlatState)


def test_flat_simulation_logs_and_sorts():
    """A flat run logs its layout in the banner, and ``sort_every`` sorts
    the flat state as it sorts the regular one."""
    import io
    buf = io.StringIO()
    sim_f = Simulation(_cfg(True), logger=RunLogger(stream=buf))
    res_f = sim_f.run(n_steps=2, log_every=0, sort_every=1)
    assert "(flat)" in buf.getvalue()
    res_r = Simulation(_cfg(False)).run(n_steps=2, log_every=0,
                                        sort_every=1)
    assert torch.equal(res_f.state.pos.view(N, 3), res_r.state.pos)
