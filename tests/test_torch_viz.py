"""The port's viz and trajectory I/O (``nbody_tpu_torch/viz/``, the frame
paths of ``ops/step.py``, ``parallel/ring.py`` and ``models/simulation.py``,
``analysis.analyze_trajectory``) against the JAX package on the same numpy
inputs made from a seed: the raster bit for bit, the writers byte for
byte, the trajectory series at rel 1e-12; and the frame paths against a
render of the port's own states."""

import os
import urllib.request
from urllib.error import HTTPError

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu import analysis as ja
from nbody_tpu.io import checkpoint as jck
from nbody_tpu.viz import avi as javi
from nbody_tpu.viz import gif as jgif
from nbody_tpu.viz import mp4 as jmp4
from nbody_tpu.viz import png as jpng
from nbody_tpu.viz import raster as jr
from nbody_tpu.viz import stream as jstream
from nbody_tpu_torch import SimConfig, SimState
from nbody_tpu_torch import analysis as pa
from nbody_tpu_torch.io import checkpoint as pck
from nbody_tpu_torch.models.simulation import Simulation
from nbody_tpu_torch.ops.step import run_steps, run_trajectory_frames
from nbody_tpu_torch.parallel.mesh import make_mesh
from nbody_tpu_torch.parallel.ring import (render_weights_sharded,
                                           run_steps_sharded,
                                           run_trajectory_frames_sharded)
from nbody_tpu_torch.viz import avi as pavi
from nbody_tpu_torch.viz import gif as pgif
from nbody_tpu_torch.viz import mp4 as pmp4
from nbody_tpu_torch.viz import native_png as pnative
from nbody_tpu_torch.viz import png as ppng
from nbody_tpu_torch.viz import raster as pr
from nbody_tpu_torch.viz import stream as pstream
from nbody_tpu_torch.viz import video as pvideo
from nbody_tpu_torch.viz.server import LiveViewer

MIN_MASS, MAX_MASS = 1e5, 1e9


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


def _bodies(n, seed, spread=2.2e5, ghosts=0.1):
    """Positions a little past the default view box, masses in the
    reference's range, about ``ghosts`` of them zero-mass."""
    r = np.random.default_rng(seed)
    pos = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    mass = r.uniform(MIN_MASS, MAX_MASS, n).astype(np.float32)
    mass[r.random(n) < ghosts] = 0.0
    return pos, mass


def _both(pos, mass, *args, **kw):
    """The JAX package's and the port's packed maps of the same bodies."""
    want = np.asarray(jr.render_weights(jnp.asarray(pos), jnp.asarray(mass),
                                        *args, **kw))
    got = pr.render_weights(torch.from_numpy(pos), torch.from_numpy(mass),
                            *args, **kw).numpy()
    return got, want


CAMERAS = ((2e5, 0.0, 0.0), (1.3e5, 1234.5, -777.25), (7e4, 5e4, -4e4),
           (4e5, -1e5, 2.5e4))


@pytest.mark.parametrize("view_axis", [0, 1, 2])
@pytest.mark.parametrize("n,seed", [(64, 0), (700, 1), (4096, 2)])
def test_render_weights_matches_jax_bit_for_bit(n, seed, view_axis):
    pos, mass = _bodies(n, seed)
    for (mv, cu, cv), (w, h) in zip(CAMERAS, ((800, 600), (97, 61),
                                              (800, 600), (320, 240))):
        got, want = _both(pos, mass, MIN_MASS, MAX_MASS, mv, w, h,
                          view_axis, cu, cv)
        assert got.dtype == np.uint8 and got.shape == (h, w)
        np.testing.assert_array_equal(got, want)
        assert got.any()


@pytest.mark.parametrize("w,h", [(800, 600), (33, 25)])
def test_edges_and_pixel_boundaries_match_jax(w, h):
    """Bodies exactly on the +/-max_view edges, one float32 step inside and
    outside them, and exactly on pixel boundaries (u with (u+1)/2*(W-1)
    an integer); masses at, between and past min and max."""
    mv = 2e5
    kx = np.arange(w, dtype=np.float32)
    ky = np.arange(h, dtype=np.float32)
    ux = (kx / (w - 1) * 2.0 - 1.0).astype(np.float32)
    uy = (ky / (h - 1) * 2.0 - 1.0).astype(np.float32)
    edge = np.float32(mv)
    out = np.nextafter(edge, np.float32(np.inf))
    inn = np.nextafter(edge, np.float32(0))
    xs = np.concatenate([ux * mv, [edge, -edge, out, -out, inn, -inn, 0.0]])
    ys = np.concatenate([uy * mv, [edge, -edge, out, -out, inn, -inn, 0.0]])
    gx, gy = np.meshgrid(xs.astype(np.float32), ys.astype(np.float32))
    pos = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], -1)
    pos = pos.astype(np.float32)
    masses = np.array([0.0, MIN_MASS, 5e8, MAX_MASS, 2e9, 5e4, 1e5 + 1],
                      np.float32)
    mass = masses[np.arange(pos.shape[0]) % masses.size]
    for cam in ((mv, 0.0, 0.0), (mv, 0.5 * mv / (w - 1), 0.0)):
        got, want = _both(pos, mass, MIN_MASS, MAX_MASS, cam[0], w, h, 2,
                          cam[1], cam[2])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,seed", [(256, 3), (2000, 4)])
def test_render_frame_and_colorize_match_jax(n, seed):
    pos, mass = _bodies(n, seed)
    args = (MIN_MASS, MAX_MASS, 2e5, 120, 90)
    want = np.asarray(jr.render_frame(jnp.asarray(pos), jnp.asarray(mass),
                                      *args))
    got = pr.render_frame(torch.from_numpy(pos), torch.from_numpy(mass),
                          *args).numpy()
    np.testing.assert_array_equal(got, want)
    w8 = pr.render_weights(torch.from_numpy(pos), torch.from_numpy(mass),
                           *args)
    np.testing.assert_array_equal(pr.colorize(w8), want)
    np.testing.assert_array_equal(pr.colorize(w8.numpy()),
                                  jr.colorize(w8.numpy()))
    np.testing.assert_array_equal(pr._LUT, jr._LUT)


def test_render_frame_shape_colors_and_ghosts():
    pos = torch.tensor([[0.0, 0.0, 0.0], [1e5, 1e5, 0.0], [5e5, 0.0, 0.0]])
    mass = torch.tensor([1e5, 1e9, 1e9])
    frame = pr.render_frame(pos, mass, 1e5, 1e9, 2e5, 200, 100).numpy()
    assert frame.shape == (100, 200, 3) and frame.dtype == np.uint8
    assert tuple(frame[49, 99]) == (0, 255, 0)       # light: green
    assert tuple(frame[24, 149]) == (255, 0, 0)      # heavy: red
    assert (frame.sum(axis=-1) > 0).sum() == 2       # the third clips
    ghosts = pr.render_frame(torch.zeros(4, 3), torch.zeros(4), 1e5, 1e9,
                             2e5, 64, 64)
    assert int(ghosts.sum()) == 0


def test_pan_and_zoom_camera():
    pos, mass = torch.tensor([[60.0, -30.0, 0.0]]), torch.tensor([5e8])
    w, h = 33, 25
    base = pr.render_weights(pos, mass, 1e5, 1e9, 100.0, w, h).numpy()
    assert tuple(np.argwhere(base)[0]) != (h // 2, w // 2)
    panned = pr.render_weights(pos, mass, 1e5, 1e9, 100.0, w, h, 2, 60.0,
                               -30.0).numpy()
    assert tuple(np.argwhere(panned)[0]) == (h // 2, w // 2)
    assert not pr.render_weights(pos, mass, 1e5, 1e9, 25.0, w, h).any()


def _frames(n=4, h=48, w=64, seed=0):
    """Colorized renders of seeded bodies, the frames a run streams."""
    out = []
    for k in range(n):
        pos, mass = _bodies(600, seed + k, spread=2e5, ghosts=0.0)
        out.append(pr.render_frame(torch.from_numpy(pos),
                                   torch.from_numpy(mass), MIN_MASS,
                                   MAX_MASS, 2e5, w, h).numpy())
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("level", [1, 3, 6, 9])
def test_png_bytes_match_jax(level, tmp_path):
    frame = _frames(1, 90, 120, seed=level)[0]
    data = ppng.encode_png(frame, level)
    assert data == jpng.encode_png(frame, level)
    ppng.write_png(str(tmp_path / "a.png"), frame, level)
    jpng.write_png(str(tmp_path / "b.png"), frame, level)
    assert _read(tmp_path / "a.png") == _read(tmp_path / "b.png")
    assert ppng.read_png_size(str(tmp_path / "a.png")) == (120, 90)
    with pytest.raises(ValueError):
        ppng.encode_png(frame[..., :2])


def test_native_png_is_a_png_of_the_same_pixels():
    """The native encoder (the oracle's library) writes the same chunks as
    the Python encoder; zlib builds may differ in the IDAT bytes, so the
    pixels are compared after decompression."""
    import struct
    import zlib
    frame = _frames(1, 48, 64, seed=9)[0]
    data = pnative.encode_png(frame, 1)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks, off = {}, 8
    while off < len(data):
        (length,) = struct.unpack(">I", data[off:off + 4])
        chunks[data[off + 4:off + 8]] = data[off + 8:off + 8 + length]
        off += 12 + length
    py = ppng.encode_png(frame, 1)
    assert chunks[b"IHDR"] == py[16:29]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(48, 1 + 64 * 3)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(48, 64, 3), frame)


def test_gif_bytes_match_jax(tmp_path):
    frames = _frames(3, 40, 56, seed=20)
    a, b = str(tmp_path / "a.gif"), str(tmp_path / "b.gif")
    assert pgif.write_gif(a, frames, delay_cs=7) == 3
    jgif.write_gif(b, frames, delay_cs=7)
    assert _read(a) == _read(b)
    assert _read(a)[:6] == b"GIF89a"
    with pytest.raises(ValueError):
        pgif.write_gif(a, [])


@pytest.mark.parametrize("codec", ["DIB ", "MJPG"])
def test_avi_bytes_match_jax(codec, tmp_path):
    if codec == "MJPG":
        pytest.importorskip("PIL")
    frames = _frames(4, 48, 64, seed=30)
    a, b = str(tmp_path / "a.avi"), str(tmp_path / "b.avi")
    for mod, path in ((pavi, a), (javi, b)):
        with mod.AviWriter(path, 64, 48, fps=10, codec=codec) as av:
            for fr in frames:
                av.add(fr)
    assert _read(a) == _read(b)
    from test_avi import _parse_avi
    n, chunks, _ = _parse_avi(a, cid=b"00db" if codec == "DIB " else
                              b"00dc")
    assert n == len(chunks) == 4


def test_mp4_bytes_and_video_dispatch_match_jax(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    frames = _frames(3, 48, 64, seed=40)
    a, b = str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")
    assert pmp4.write_mp4(a, frames, fps=12) == 3
    jmp4.write_mp4(b, frames, fps=12)
    assert _read(a) == _read(b)
    # Dispatch by extension; the streamers write the same files.
    for ext in ("mp4", "avi"):
        p = str(tmp_path / f"s.{ext}")
        with pvideo.video_streamer(p, 64, 48, fps=5) as vs:
            for k, fr in enumerate(frames):
                vs.submit(k, fr)
        assert vs.frames_written == 3
        want = str(tmp_path / f"w.{ext}")
        from nbody_tpu.viz.video import video_streamer
        with video_streamer(want, 64, 48, fps=5) as vs:
            for k, fr in enumerate(frames):
                vs.submit(k, fr)
        assert _read(p) == _read(want)
    # Without Pillow, .mp4 raises as the JAX package's does; .avi takes
    # the raw DIB codec.
    monkeypatch.setattr(pvideo, "_pil_available", lambda: False)
    monkeypatch.setattr(pavi, "_pil_available", lambda: False)
    with pytest.raises(RuntimeError, match="MP4 export needs PIL"):
        pvideo.video_writer(str(tmp_path / "x.mp4"), 64, 48)
    with pvideo.video_writer(str(tmp_path / "x.avi"), 64, 48) as av:
        assert av.codec == "DIB "


def test_frame_streamer_and_tee_match_jax(tmp_path):
    frames = _frames(5, 32, 40, seed=50)
    ours, theirs = str(tmp_path / "p"), str(tmp_path / "j")
    with pstream.FrameStreamer(ours) as fs:
        tee = pstream.TeeStreamer(fs, None)
        for k, fr in enumerate(frames):
            tee.submit(k, fr)
    with jstream.FrameStreamer(theirs) as fs2:
        for k, fr in enumerate(frames):
            fs2.submit(k, fr)
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs)) and len(names) == 5
    assert names[0] == "frame_000000.png"
    for name in names:
        assert _read(os.path.join(ours, name)) == \
            _read(os.path.join(theirs, name))
    assert tee.frames_written == 5 and tee.control_state() == "run"


def _state(n, seed, device="cpu"):
    r = np.random.default_rng(seed)
    pos = r.uniform(-1e5, 1e5, (n, 3)).astype(np.float32)
    mass = r.uniform(MIN_MASS, MAX_MASS, n).astype(np.float32)
    t = torch.from_numpy
    return SimState(pos=t(pos).to(device), vel=torch.zeros(n, 3),
                    acc=torch.zeros(n, 3), mass=t(mass).to(device))


def _render(state, cfg, view=None):
    mv, cu, cv = view or (cfg.max_view, 0.0, 0.0)
    return pr.render_weights(state.pos, state.mass, cfg.min_mass,
                             cfg.max_mass, mv, cfg.viz_width,
                             cfg.viz_height, 2, cu, cv)


@pytest.mark.parametrize("impl,resident,packed", [
    ("xla_nxn", False, True), ("xla_nxn", False, False),
    ("pallas_sym2", True, True), ("pallas", False, True)])
def test_run_trajectory_frames_equal_per_step_renders(impl, resident,
                                                       packed):
    """Frames between the steps (K3 stretches with ``resident``) equal a
    render of the per-step states, the remainder steps run frameless,
    and the camera reaches every frame."""
    cfg = SimConfig(n_bodies=300, impl=impl, device="cpu", viz_width=96,
                    viz_height=64)
    state = _state(300, 40)
    view = (1.5e5, 2e4, -1e4)
    final, frames = run_trajectory_frames(state, cfg, 7, frame_every=2,
                                          packed=packed, view=view,
                                          resident=resident)
    assert frames.shape == (3, 64, 96) + (() if packed else (3,))
    assert frames.dtype == torch.uint8
    st = state
    for k in range(3):
        st = run_steps(st, cfg, 2, impl=impl)
        want = _render(st, cfg, view)
        if not packed:
            want = torch.from_numpy(pr.colorize(want))
        assert torch.equal(frames[k], want), k
    assert torch.equal(final.pos, run_steps(st, cfg, 1, impl=impl).pos)


class _Collect:
    """A frame sink that keeps the colorized frames by index, with an
    optional camera."""

    def __init__(self, view=None):
        self.frames, self._view = {}, view
        if view is not None:
            self.view_state = lambda: self._view

    def submit(self, idx, frame):
        self.frames[idx] = np.asarray(frame)

    @property
    def frames_written(self):
        return len(self.frames)

    def close(self):
        pass


@pytest.mark.parametrize("case", ["batched", "boundary", "resident"])
def test_simulation_frames_equal_renders_of_its_states(case):
    """The batched path (frames inside the chunk), the boundary path
    (a sort cadence that cuts frame stretches: frames at the ends of
    chunks) and auto's resident routing, each against renders of the
    same run's states stepped chunk by chunk."""
    kw = {"batched": dict(impl="xla_nxn"), "boundary": dict(impl="xla_nxn"),
          "resident": dict(resident=True)}[case]
    sort_every = 3 if case == "boundary" else 0
    cfg = SimConfig(n_bodies=256, viz_every=2, viz_width=64, viz_height=48,
                    device="cpu", **kw)
    sink = _Collect(view=(2.0, 0.1, -0.2))
    sim = Simulation(cfg)
    start = sim.state
    sim.run(n_steps=11, log_every=4, frame_streamer=sink,
            sort_every=sort_every)
    # Frames at every second step; the boundary path adds the end state.
    want_steps = [2, 4, 6, 8, 10] + ([11] if case == "boundary" else [])
    assert sorted(sink.frames) == list(range(len(want_steps)))
    view = (cfg.max_view / 2.0, 0.1 * cfg.max_view, -0.2 * cfg.max_view)
    for k, step in enumerate(want_steps):
        # The same steps and sorts in one headless chunk.
        ref = Simulation(cfg, state=start)
        ref.run(n_steps=step, log_every=0, sort_every=sort_every)
        want = pr.colorize(_render(ref.state, cfg, view))
        np.testing.assert_array_equal(sink.frames[k], want)


def test_simulation_checkpoint_cadence_keeps_frames_aligned(tmp_path):
    """A checkpoint cadence that is a multiple of viz_every keeps the
    batched path; one that is not takes boundary frames, which add the
    end state; both give one frame every viz_every steps."""
    for every, expect in ((4, 3), (3, 4)):
        cfg = SimConfig(n_bodies=64, impl="xla_nxn", viz_every=2,
                        viz_width=32, viz_height=24, device="cpu")
        sink = _Collect()
        Simulation(cfg).run(n_steps=7, log_every=0, frame_streamer=sink,
                            checkpoint_path=str(tmp_path / f"{every}.npz"),
                            checkpoint_every=every)
        assert sink.frames_written == expect


@pytest.mark.parametrize("impl,comm", [("pallas_sym2", "ring"),
                                       ("xla", "allgather"),
                                       ("pallas_sym2", "rdma")])
def test_mesh_frames_equal_render_of_gathered_state(impl, comm):
    """Four shards on the CPU: each shard's map max-combined equals the
    render of the gathered state, at every frame."""
    cfg = SimConfig(n_bodies=600, impl=impl, device="cpu", viz_width=64,
                    viz_height=48)
    mesh = make_mesh(4, "cpu")
    state = _state(600, 60)
    out, frames = run_trajectory_frames_sharded(state, cfg, mesh, 5,
                                                frame_every=2, impl=impl,
                                                comm=comm)
    assert frames.shape == (2, 48, 64)
    for k, steps in enumerate((2, 4)):
        ref = run_steps_sharded(state, cfg, mesh, steps, impl=impl,
                                comm=comm)
        assert torch.equal(frames[k], _render(ref, cfg))
        assert torch.equal(render_weights_sharded(ref, cfg, mesh),
                           _render(ref, cfg))
    assert torch.equal(out.pos, run_steps_sharded(state, cfg, mesh, 5,
                                                  impl=impl, comm=comm).pos)


def test_simulation_mesh_frames(tmp_path):
    """``Simulation(mesh=)`` with a streamer: one frame every viz_every
    steps on both paths (the boundary path adds the end state), the
    batched path's the gathered state's render."""
    cfg = SimConfig(n_bodies=300, impl="pallas_sym2", viz_every=3,
                    viz_width=48, viz_height=32, device="cpu")
    mesh = make_mesh(4, "cpu")
    for sort_every, n_frames in ((0, 4), (2, 5)):
        sink = _Collect()
        sim = Simulation(cfg, mesh=mesh)
        start = sim.state
        sim.run(n_steps=13, log_every=6, frame_streamer=sink,
                sort_every=sort_every)
        assert sink.frames_written == n_frames
        if not sort_every:
            ref = run_steps_sharded(start, cfg, mesh, 12, impl="pallas_sym2")
            np.testing.assert_array_equal(sink.frames[3],
                                          pr.colorize(_render(ref, cfg)))


def test_live_viewer_frames_view_and_control():
    frame = np.zeros((8, 8, 3), np.uint8)
    frame[2, 3] = (255, 0, 0)
    with LiveViewer(port=0) as lv:
        url = f"http://127.0.0.1:{lv.port}"
        lv.submit(0, frame)
        assert b"/stream" in urllib.request.urlopen(f"{url}/",
                                                    timeout=10).read()
        png = urllib.request.urlopen(f"{url}/frame.png", timeout=10).read()
        assert png == pnative.encode_png(frame, 1)
        with urllib.request.urlopen(f"{url}/stream", timeout=10) as r:
            assert "multipart/x-mixed-replace" in r.headers["Content-Type"]
            header = (b"--nbodyframe\r\nContent-Type: image/png\r\n"
                      b"Content-Length: " + str(len(png)).encode()
                      + b"\r\n\r\n")
            assert r.read(len(header) + len(png)) == header + png
        assert lv.view_state() == (1.0, 0.0, 0.0)
        urllib.request.urlopen(f"{url}/view?op=in", data=b"")
        urllib.request.urlopen(f"{url}/view?op=right", data=b"")
        assert lv.view_state() == (1.25, 0.25 / 1.25, 0.0)
        urllib.request.urlopen(f"{url}/view?zoom=4&cx=-0.5&cy=0.125")
        assert lv.view_state() == (4.0, -0.5, 0.125)
        with pytest.raises(HTTPError) as e:
            urllib.request.urlopen(f"{url}/view?zoom=0", data=b"")
        assert e.value.code == 400 and lv.view_state() == (4.0, -0.5, 0.125)
        urllib.request.urlopen(f"{url}/pause", data=b"")
        assert lv.control_state() == "pause"
        urllib.request.urlopen(f"{url}/resume", data=b"")
        assert lv.control_state() == "run"
        urllib.request.urlopen(f"{url}/stop", data=b"")
        urllib.request.urlopen(f"{url}/resume", data=b"")
        assert lv.control_state() == "stop"
    assert lv.frames_written == 1


def test_viewer_stop_ends_a_run_with_a_checkpoint(tmp_path):
    viewer = LiveViewer(port=0)
    try:
        with pstream.FrameStreamer(str(tmp_path / "f")) as fs:
            tee = pstream.TeeStreamer(fs, viewer)
            viewer.request_stop()
            assert tee.control_state() == "stop"
        cfg = SimConfig(n_bodies=64, impl="xla_nxn", viz_every=1,
                        viz_width=32, viz_height=24, device="cpu")
        ckpt = str(tmp_path / "stopped.npz")
        res = Simulation(cfg).run(n_steps=50, log_every=1,
                                  frame_streamer=viewer,
                                  checkpoint_path=ckpt)
        assert res.steps_run < 50
        with np.load(ckpt) as z:
            assert int(z["step"]) == res.steps_run
        assert viewer.frames_written == res.steps_run
    finally:
        viewer.close()


def _traj_inputs(n, t, seed):
    r = np.random.default_rng(seed)
    snaps = r.normal(0.0, 3e4, (t, n, 3)).astype(np.float32)
    vels = r.normal(0.0, 2e2, (t, n, 3)).astype(np.float32)
    mass = r.uniform(MIN_MASS, MAX_MASS, n).astype(np.float32)
    return snaps, vels, mass


def _write(writer, path, snaps, vels, mass, with_vel):
    """A trajectory NPZ written by one package's writer: monolithic
    (``save_trajectory``) or streamed (``TrajectoryWriter``)."""
    mod, kind = writer
    v = vels if with_vel else None
    if kind == "monolithic":
        mod.save_trajectory(path, snaps, 3, mass=mass, vel_snapshots=v)
        return
    with mod.TrajectoryWriter(path, 3, mass=mass) as tw:
        for k in range(snaps.shape[0]):
            tw.append(snaps[k], vel=None if v is None else v[k])


def _same_series(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(w, np.float64),
                                       rtol=1e-12, atol=1e-300, err_msg=k)


@pytest.mark.parametrize("with_vel", [True, False])
@pytest.mark.parametrize("writer", [(pck, "monolithic"), (pck, "streamed"),
                                    (jck, "monolithic"), (jck, "streamed")],
                         ids=["port", "port-streamed", "jax",
                              "jax-streamed"])
def test_analyze_trajectory_matches_jax(writer, with_vel, tmp_path):
    snaps, vels, mass = _traj_inputs(300, 4, 70)
    path = str(tmp_path / "t.npz")
    _write(writer, path, snaps, vels, mass, with_vel)
    got = pa.analyze_trajectory(path, n_bins=24)
    _same_series(got, ja.analyze_trajectory(path, n_bins=24))
    assert ("energy" in got) == with_vel
    assert got["steps"] == [3, 6, 9, 12]
    # The energy skip and its note, as in the JAX package.
    got = pa.analyze_trajectory(path, energy_max_n=100)
    _same_series(got, ja.analyze_trajectory(path, energy_max_n=100))
    assert ("energy_note" in got) == with_vel


def test_analyze_samples_the_pair_correlation_above_its_cap(tmp_path,
                                                            monkeypatch):
    """Above ``PAIR_SAMPLE_N`` bodies g(r) comes from a seeded sample (the
    same bodies in both snapshots), with a note; every other series is
    the JAX package's."""
    snaps, vels, mass = _traj_inputs(400, 3, 80)
    path = str(tmp_path / "t.npz")
    pck.save_trajectory(path, snaps, 1, mass=mass, vel_snapshots=vels)
    monkeypatch.setattr(pa, "PAIR_SAMPLE_N", 150)
    got = pa.analyze_trajectory(path, n_bins=16)
    want = ja.analyze_trajectory(path, n_bins=16)
    assert "150 bodies" in got.pop("g_r_note")
    pick = np.sort(np.random.default_rng(0).choice(400, 150, replace=False))
    first = snaps[0].astype(np.float64)
    r_max = float(np.linalg.norm(first - first.mean(0), axis=1).max())
    for key, snap in (("g_r_first", snaps[0]), ("g_r_last", snaps[-1])):
        _, g = ja.pair_correlation(snap[pick].astype(np.float64), 16,
                                   r_max=r_max)
        np.testing.assert_allclose(got.pop(key), g, rtol=1e-12)
        want.pop(key)
    _same_series(got, want)


def test_invariant_drifts_measure_change_from_the_initial_state():
    """From a cold start (P0 = L0 = 0) the numbers are the JAX validate
    gate's |P| and |L| over their scales, bit for bit; a state with net P
    and L and its own start gives rounding-scale change."""
    r = np.random.default_rng(90)
    pos = r.normal(0, 1e4, (500, 3)).astype(np.float32)
    vel = r.normal(0, 3e2, (500, 3)).astype(np.float32)
    mass = r.uniform(1e5, 1e9, 500).astype(np.float32)
    p, v, m = (a.astype(np.float64) for a in (pos, vel, mass))
    p_want = (np.abs((m[:, None] * v).sum(0)).max()
              / float((m * np.linalg.norm(v, axis=1)).sum()))
    com = ja.center_of_mass(p, m)
    l_want = (np.abs(ja.angular_momentum(p, v, m)).max()
              / float((m * np.linalg.norm(p - com, axis=1)
                       * np.linalg.norm(v, axis=1)).sum()))
    got = pa.invariant_drifts(pos, vel, mass, pos, np.zeros_like(vel))
    assert got == (p_want, l_want)
    assert p_want > 1e-3 and l_want > 1e-3
    moved = pos + 0.01 * vel
    dp, dl = pa.invariant_drifts(moved, vel, mass, pos, vel)
    assert dp == 0.0 and dl < 1e-7   # the float32 rounding of `moved`
