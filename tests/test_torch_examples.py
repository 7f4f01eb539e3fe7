"""The port's examples (``examples/demo_torch.py``,
``examples/orbit_torch.py``) run through ``main`` on the CPU at a tiny N,
beside the JAX package's (``examples/demo.py``, ``examples/orbit.py``),
which stay as they are."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["demo_torch", "orbit_torch"])
def test_examples_import_no_jax(name):
    text = (REPO / "examples" / f"{name}.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|nbody_tpu)\b", text,
                         re.M)
    assert "nbody_tpu_torch" in text


def test_demo_torch(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert _example("demo_torch").main(["64", "4", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu, N=64, steps=4, impl=xla_nxn"
    assert re.match(r"oracle check @10 steps: 0\.0000% components outside "
                    r"1% \(OK; [\d.]+ s\)$", out[1]), out[1]
    assert re.match(r"wrote demo\.gif \(4 frames; [\d.]+ s\)$", out[2])
    gif = (tmp_path / "demo.gif").read_bytes()
    assert gif[:6] == b"GIF89a" and gif[-1:] == b";"


def test_orbit_torch(capsys):
    assert _example("orbit_torch").main(["64", "6", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu, N=64, steps=6"
    assert len(out) == 5
    errs, drifts = {}, {}
    for line in out[1:]:
        m = re.match(r"\s*(\w+): Kepler orbit, one period in 1024 steps: "
                     r"max \|r - r_exact\| / d = (\S+)$", line)
        if m:
            errs[m[1]] = float(m[2])
            continue
        m = re.match(r"\s*(\w+): \|dE/E\| = (\S+) over 6 steps \(.*"
                     r"resident=False\)$", line)
        assert m, line
        drifts[m[1]] = float(m[2])
    assert set(errs) == set(drifts) == {"reference", "yoshida4"}
    # The closed form: first order against fourth.
    assert errs["yoshida4"] < 1e-4 < errs["reference"] < 1e-3
    assert all(np.isfinite(d) and d < 1e-2 for d in drifts.values())
    assert drifts["yoshida4"] < drifts["reference"]
