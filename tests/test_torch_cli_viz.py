"""The port's viz verbs and flags on the CPU (``--device cpu``) against the
JAX package's CLI: ``run --viz/--viz-avi/--viz-serve``, ``render``,
``analyze``, ``interactive``, the two parsers' flags, and ``validate``'s
invariant gates measuring change from the initial state."""

import argparse
import json
import os
import re

import numpy as np
import pytest
import torch

from nbody_tpu import cli as jcli
from nbody_tpu.io import checkpoint as jck
from nbody_tpu_torch import SimConfig, cli, init_state
from nbody_tpu_torch.analysis import angular_momentum, center_of_mass
from nbody_tpu_torch.models.state import state_to_numpy
from nbody_tpu_torch.ops.step import run_steps
from nbody_tpu_torch.viz.png import read_png_size
from test_avi import _parse_avi

CPU = ["--device", "cpu"]


def _files(d):
    return sorted(os.listdir(d))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("sinks", [
    ["--viz"], ["--viz-avi", "run.avi"], ["--viz-serve", "0"],
    ["--viz", "--viz-avi", "run.avi", "--viz-serve", "0"]],
    ids=["png", "avi", "serve", "tee"])
def test_run_viz_sinks(sinks, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["run", "--n", "128", "--steps", "6", "--viz-every",
                     "2", *sinks, *CPU]) == 0
    out = capsys.readouterr().out
    if "--viz" in sinks:
        names = _files("frames")
        assert names == [f"frame_{k:06d}.png" for k in range(3)]
        assert read_png_size(os.path.join("frames", names[0])) == (800, 600)
        assert "3 frames -> frames" in out
    if "--viz-avi" in sinks:
        n, chunks, _ = _parse_avi("run.avi")
        assert n == len(chunks) == 3
    if "--viz-serve" in sinks:
        assert "live view: http://127.0.0.1:" in out


def test_run_viz_mp4_and_mesh(tmp_path, capsys):
    pytest.importorskip("PIL")
    mp4 = str(tmp_path / "run.mp4")
    assert cli.main(["run", "--n", "128", "--steps", "4", "--viz-every", "2",
                     "--viz-avi", mp4, *CPU]) == 0
    assert _read(mp4)[4:8] == b"ftyp"
    d = str(tmp_path / "m")
    assert cli.main(["run", "--n", "300", "--steps", "4", "--viz-every",
                     "2", "--viz", "--viz-dir", d, "--shards", "4",
                     "--impl", "pallas_sym2", *CPU]) == 0
    assert len(_files(d)) == 2


def _jax_trajectory(path, n, t, seed, vel=True, streamed=False):
    r = np.random.default_rng(seed)
    snaps = r.uniform(-2e5, 2e5, (t, n, 3)).astype(np.float32)
    vels = r.normal(0.0, 3e2, (t, n, 3)).astype(np.float32)
    mass = r.uniform(1e5, 1e9, n).astype(np.float32)
    if streamed:
        with jck.TrajectoryWriter(path, 2, mass=mass) as tw:
            for k in range(t):
                tw.append(snaps[k], vel=vels[k] if vel else None)
    else:
        jck.save_trajectory(path, snaps, 2, mass=mass,
                            vel_snapshots=vels if vel else None)


@pytest.mark.parametrize("source", ["port-run", "jax", "jax-streamed",
                                    "checkpoint"])
def test_render_writes_the_jax_clis_files(source, tmp_path, capsys):
    """``render`` of one file through both CLIs: the same PNG bytes, GIF
    bytes and AVI bytes."""
    src = str(tmp_path / "src.npz")
    if source == "port-run":
        assert cli.main(["run", "--n", "200", "--steps", "6",
                         "--save-trajectory", src, "--snap-every", "2",
                         "--quiet", *CPU]) == 0
    elif source == "checkpoint":
        assert cli.main(["run", "--n", "200", "--steps", "2",
                         "--checkpoint", src, "--quiet", *CPU]) == 0
    else:
        _jax_trajectory(src, 200, 3, 5, streamed=source == "jax-streamed")
    outs = {}
    for name, main, extra in (("port", cli.main, CPU),
                              ("jax", jcli.main, [])):
        d = tmp_path / name
        d.mkdir()
        assert main(["render", src, "--out-dir", str(d / "f"), "--width",
                     "160", "--height", "120", "--max-view", "1.5e5",
                     "--gif", str(d / "a.gif"), "--gif-delay-cs", "6",
                     "--avi", str(d / "a.avi"), "--fps", "12",
                     *extra]) == 0
        outs[name] = d
    frames = _files(outs["port"] / "f")
    assert frames == _files(outs["jax"] / "f")
    assert len(frames) == (1 if source == "checkpoint" else 3)
    for rel in [os.path.join("f", f) for f in frames] + ["a.gif", "a.avi"]:
        assert _read(outs["port"] / rel) == _read(outs["jax"] / rel), rel


@pytest.mark.parametrize("vel", [True, False])
def test_analyze_prints_the_jax_clis_table_and_json(vel, tmp_path, capsys):
    path = str(tmp_path / "t.npz")
    _jax_trajectory(path, 300, 4, 7, vel=vel)
    printed = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        for extra in ([], ["--json"], ["--bins", "12", "--energy-max-n",
                                      "100"]):
            capsys.readouterr()
            assert main(["analyze", path, *extra]) == 0
            printed[name, tuple(extra)] = capsys.readouterr().out
    for extra in ([], ["--bins", "12", "--energy-max-n", "100"]):
        assert printed["port", tuple(extra)] == printed["jax", tuple(extra)]
    got = json.loads(printed["port", ("--json",)])
    want = json.loads(printed["jax", ("--json",)])
    assert sorted(got) == sorted(want)
    assert ("energy" in got) == vel
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-12, atol=1e-300)


def test_analyze_of_a_port_run_with_velocities(tmp_path, capsys):
    traj = str(tmp_path / "t.npz")
    assert cli.main(["run", "--n", "256", "--steps", "6",
                     "--save-trajectory", traj, "--snap-every", "2",
                     "--traj-vel", "--quiet", *CPU]) == 0
    capsys.readouterr()
    assert cli.main(["analyze", traj, "--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["steps"] == [2, 4, 6]
    assert max(res["momentum_drift"]) < 1e-6
    assert max(res["ang_mom_drift"]) < 1e-6
    assert max(res["energy_drift"]) < 1e-3


@pytest.mark.parametrize("answers,impl,viz", [
    (["7", "0", "maybe", "n", "not-a-number", "4"], "xla", False),
    (["1", "y", "4"], "xla_nxn", True)], ids=["kernel0", "kernel1-viz"])
def test_interactive_flow(answers, impl, viz, tmp_path, monkeypatch, capsys):
    """The reference's console: bad answers ask again; on the CPU kernel 0
    runs xla and kernel 1 xla_nxn; visualization writes the frames."""
    it = iter(answers)
    monkeypatch.setattr("builtins.input", lambda prompt: next(it))
    d = str(tmp_path / "fr")
    assert cli.main(["interactive", "--n", "128", "--viz-dir", d,
                     *CPU]) == 0
    out = capsys.readouterr().out
    assert out.count("Please insert a valid") == (3 if not viz else 0)
    assert f"impl={impl}" in out and "Simulation complete" in out
    assert (len(_files(d)) == 4) if viz else not os.path.exists(d)


def _flags(parser):
    """{verb: sorted option strings} of a CLI's parser."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {verb: sorted(o for a in p._actions for o in a.option_strings)
            for verb, p in sub.choices.items()}


def test_parsers_differ_by_device_alone():
    ours, theirs = _flags(cli.build_parser()), _flags(jcli.build_parser())
    assert sorted(ours) == sorted(theirs)
    for verb in theirs:
        extra = set(ours[verb]) - set(theirs[verb])
        assert set(theirs[verb]) <= set(ours[verb]), verb
        assert extra <= {"--device"}, (verb, extra)
    assert "--device" not in ours["analyze"] + ours["info"]


def _old_gate(pos, vel, mass):
    """validate's momentum and angular-momentum numbers before they took
    the initial state (and the JAX package's): |P| and |L| over their
    scales."""
    p, v, m = (np.asarray(a, np.float64) for a in (pos, vel, mass))
    speed = np.linalg.norm(v, axis=1)
    p_rel = (np.abs((m[:, None] * v).sum(0)).max()
             / (float((m * speed).sum()) or 1.0))
    com = center_of_mass(p, m)
    l_rel = (np.abs(angular_momentum(p, v, m)).max()
             / (float((m * np.linalg.norm(p - com, axis=1)
                       * speed).sum()) or 1.0))
    return p_rel, l_rel


def test_validate_uniform_box_prints_the_same_numbers(capsys):
    """From the cold uniform box P0 = L0 = 0, so every printed invariant
    number is the one the gate printed before it measured change."""
    assert cli.main(["validate", "--n", "256", "--steps", "4",
                     "--long-steps", "6", *CPU]) == 0
    out = capsys.readouterr().out
    cfg = SimConfig(n_bodies=256, device="cpu")
    start = init_state(cfg)
    for steps, pattern in ((4, r"momentum drift: \|P-P0\|_max/scale = (\S+)"
                            r"\n.*angular momentum drift: \|L-L0\|_max/"
                            r"scale = (\S+)"),
                           (6, r"\] momentum: \|P-P0\|_max/scale = (\S+) "
                            r"after.*\n.*\] angular momentum: "
                            r"\|L-L0\|_max/scale = (\S+) after")):
        host = state_to_numpy(run_steps(start, cfg, steps))
        printed = re.search(pattern, out).groups()
        want = _old_gate(host["pos"], host["vel"], host["mass"])
        assert printed == tuple(f"{x:.3e}" for x in want), (steps, out)


def test_validate_disk_passes_the_invariant_gates(capsys):
    """The rotating disk carries net L (and P): its change stays at
    rounding scale in the port.  The JAX package gates |L| itself and
    fails (|L|/scale 0.996), a difference by design, not a parity
    target."""
    argv = ["validate", "--init", "disk", "--n", "256", "--steps", "2",
            "--long-steps", "5", "--dt", "0.001"]
    assert cli.main(argv + CPU) == 0
    out = capsys.readouterr().out
    assert "[OK ] momentum: |P-P0|" in out
    assert "[OK ] angular momentum: |L-L0|" in out
    assert jcli.main(argv) == 1
    out = capsys.readouterr().out
    assert re.search(r"\[FAIL\] angular momentum: \|L\|_max/scale = "
                     r"9\.9\d\de-01", out), out


def test_render_on_a_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src = str(tmp_path / "t.npz")
    _jax_trajectory(src, 16, 1, 0)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["render", src, "--out-dir", str(tmp_path / "f")])


def test_viz_modules_import_without_jax():
    import subprocess
    import sys
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import nbody_tpu_torch.cli\n"
        "from nbody_tpu_torch.viz import (avi, gif, mp4, native_png, png,\n"
        "                                 raster, server, stream, video)\n"
        "from nbody_tpu_torch.analysis import analyze_trajectory\n"
        "from nbody_tpu_torch.ops.step import run_trajectory_frames\n"
        "assert not any(m == 'nbody_tpu' or m.startswith('nbody_tpu.') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
