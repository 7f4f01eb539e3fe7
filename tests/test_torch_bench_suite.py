"""The JAX rounds' benchmark ladder on the port
(``nbody_tpu_torch/bench_suite.py``) against ``scripts/bench_suite.py``.

The JAX script is loaded from its path with ``importlib`` and not edited.
Held: the same rows under the same keys and names, the same default list
and closing table (both ``main``s run over the same stand-in rows), JAX's
own ``config_oracle_gate()`` at its N = 4096 beside the port's row 1 on
the CPU (``xla`` in JAX, the port's plain all-pairs path; the two draw
their boxes from different generators, so the bad fractions are compared
within 1e-3), rows 2 and 7 at a small size against a record built from the
JAX package's ``run_steps``, ``energy_f64`` and ``native_run`` on the
port's initial state, row 6 and the throughput rows small, the ``--out``
file, and a row that raises.
"""

import concurrent.futures
import functools
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu as jt
from nbody_tpu.models.energy import energy_f64 as jax_energy_f64
from nbody_tpu.models.state import SimState as JaxState
from nbody_tpu.oracle import native as jax_native
from nbody_tpu_torch import bench_suite
from nbody_tpu_torch.config import SimConfig
from nbody_tpu_torch.models.init import init_state
from nbody_tpu_torch.oracle import native

ROOT = pathlib.Path(__file__).resolve().parents[1]
# JAX's row keys (scripts/bench_suite.py:43-51, 74-89, 138-141); the port
# adds the card's nvidia-smi line.
ORACLE_KEYS = {"config", "n", "steps", "bad_fracs", "passed", "backend"}
DRIFT_KEYS = {"config", "n", "steps", "eps2", "backend", "e_device",
              "oracle_seconds", "e_oracle", "energy_drift_vs_oracle",
              "passed_1e-3"}
VIZ_KEYS = {"config", "n", "steps", "frames", "fps", "steps_per_s",
            "backend"}


@pytest.fixture(scope="module")
def jax_suite():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_suite", ROOT / "scripts" / "bench_suite.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture
def built_native(monkeypatch):
    """The native oracle built in the test that needs it, and the JAX
    binding pointed at that build (its own ``make`` in ``native/`` races
    under xdist; tests/test_torch_native.py does the same)."""
    if not native.available():
        pytest.skip("native library not built (needs g++)")
    monkeypatch.setattr(jax_native, "_LIB_PATH",
                        str(native.built_library()))
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)


def test_configs_are_jaxs(jax_suite):
    assert {k: v[0] for k, v in bench_suite.CONFIGS.items()} == {
        k: v[0] for k, v in jax_suite.CONFIGS.items()}


def _stub(name):
    def row(**kw):
        return {"config": name, "value": len(name)}
    return row


def test_default_list_and_table_are_jaxs(jax_suite, monkeypatch, capsys):
    """Both mains over the same stand-in rows: the same rows by default
    (1-6), the same lines and table."""
    monkeypatch.setattr(jax_suite, "CONFIGS", {
        k: (name, _stub(name)) for k, (name, _) in jax_suite.CONFIGS.items()})
    monkeypatch.setattr(bench_suite, "CONFIGS", {
        k: (name, _stub(name))
        for k, (name, _) in bench_suite.CONFIGS.items()})
    monkeypatch.setattr("sys.argv", ["bench_suite.py"])
    assert jax_suite.main() == 0
    want = capsys.readouterr().out
    assert bench_suite.main([]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert [json.loads(line)["config"] for line in got.splitlines()
            if line.startswith("{")] == [
        "oracle-gate", "drift-gate", "throughput-64k", "throughput-1m",
        "ring", "viz"]


def test_oracle_gate_beside_jaxs(jax_suite):
    """JAX's ``config_oracle_gate()`` as it stands (4096 bodies, ``xla``
    on the CPU) and the port's row 1 at the same size on the CPU.  JAX's
    row runs on a second thread beside the port's (XLA, torch and numpy's
    pair loops release the interpreter lock), which halves the test's time:
    each row's float64 oracle is most of it."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_row = pool.submit(jax_suite.config_oracle_gate)
        got = bench_suite.config_oracle_gate(device="cpu")
        want = jax_row.result(timeout=200)
    assert set(want) == ORACLE_KEYS
    assert set(got) == ORACLE_KEYS | {"nvidia_smi"}
    assert (got["config"], got["n"], got["steps"], got["passed"]) == (
        want["config"], want["n"], want["steps"], want["passed"])
    assert got["passed"] and got["backend"] == want["backend"] == "cpu"
    for k in ("pos", "vel", "acc"):
        assert abs(got["bad_fracs"][k] - want["bad_fracs"][k]) <= 1e-3, k


def _jax_drift_record(n, steps, eps2):
    """JAX's config_drift_gate (scripts/bench_suite.py:54-80) on the port's
    initial state at ``n`` bodies and ``steps`` steps."""
    kw = {} if eps2 is None else {"eps2": eps2}
    start = init_state(SimConfig(n_bodies=n, impl="auto", device="cpu",
                                 **kw))
    pos0, vel0, mass = (t.numpy() for t in (start.pos, start.vel,
                                            start.mass))
    cfg = jt.SimConfig(n_bodies=n, impl="auto", **kw)
    state = JaxState(pos=jnp.asarray(pos0), vel=jnp.asarray(vel0),
                     acc=jnp.zeros_like(jnp.asarray(pos0)),
                     mass=jnp.asarray(mass))
    out = jt.run_steps(state, cfg, steps)
    e_dev = jax_energy_f64(out, cfg.eps2)
    opos, ovel, oacc = jax_native.native_run(pos0, vel0, mass, cfg.eps2,
                                             cfg.dt, steps, dtype=np.float64)
    e_ora = jax_energy_f64(JaxState(pos=opos, vel=ovel, acc=oacc,
                                    mass=mass), cfg.eps2)
    return {"eps2": cfg.eps2, "e_device": e_dev, "e_oracle": e_ora,
            "energy_drift_vs_oracle": abs(e_dev - e_ora) / abs(e_ora)}


# The port's drift against JAX's: rel 5e-2.  Readings on the CPU (port /
# JAX): row 2 at 320 bodies over 200 steps, where a close encounter moves
# both past the gate, 6.9309e-3 / 6.9032e-3; row 7 at 256 over 100 steps
# 4.7034e-8 / 4.7279e-8; their energies 2.8e-5 and 2.5e-10 apart relative.
# A port that integrated or summed in lower precision would drift orders
# of magnitude past these.
DRIFT_REL = 5e-2


@pytest.mark.parametrize("key,eps2,tag,n,steps", [
    ("2", None, "drift-gate", 320, 200),
    ("7", 1e6, "drift-gate-soft", 256, 100)])
def test_drift_rows_against_jax(built_native, key, eps2, tag, n, steps):
    fn = bench_suite.CONFIGS[key][1]
    got = fn(n=n, steps=steps, device="cpu")
    want = _jax_drift_record(n, steps, eps2)
    assert set(got) == DRIFT_KEYS | {"nvidia_smi"}
    assert (got["config"], got["n"], got["steps"]) == (tag, n, steps)
    assert got["eps2"] == want["eps2"] == (0.002 if eps2 is None else eps2)
    # The same float64 oracle run from the same bodies.
    assert got["e_oracle"] == want["e_oracle"]
    assert got["e_device"] == pytest.approx(want["e_device"], rel=1e-4)
    assert got["energy_drift_vs_oracle"] == pytest.approx(
        want["energy_drift_vs_oracle"], rel=DRIFT_REL)
    assert got["passed_1e-3"] == (want["energy_drift_vs_oracle"] <= 1e-3)
    # Row 2's close encounter fails the gate in both, as at full size.
    assert got["passed_1e-3"] == (key == "7")


def test_viz_row_small():
    rec = bench_suite.config_viz(n=256, steps=4, device="cpu")
    assert set(rec) == VIZ_KEYS | {"nvidia_smi"}
    assert (rec["config"], rec["n"], rec["steps"]) == ("viz", 256, 4)
    assert 0 <= rec["frames"] <= 4 and rec["steps_per_s"] > 0


@pytest.mark.parametrize("key,kw", [
    ("3", {"n": 384}), ("4", {"n": 384, "steps": 2}),
    ("5", {"n": 512, "steps": 2, "shards": 2}),
    ("5", {"n": 384, "steps": 2}), ("8", {"n": 512, "steps": 2})])
def test_throughput_rows_small(key, kw):
    """Rows 3, 4, 5 and 8 are ``run_benchmark`` with the JAX row's
    arguments, tagged with the row's name; on the CPU the ring row takes
    one shard unless told."""
    name, fn = bench_suite.CONFIGS[key]
    rec = fn(device="cpu", **kw)
    assert rec["config"] == name and rec["n_bodies"] == kw["n"]
    assert rec["backend"] == "cpu" and rec["finite"]
    assert rec["shards"] == kw.get("shards", 1)
    assert "nvidia_smi" in rec and rec["value"] > 0


def test_main_writes_one_line_and_the_table(monkeypatch, tmp_path, capsys):
    """``--configs 1 --out F`` appends one JSONL line (row 1 at 256 bodies
    here) and prints the table."""
    monkeypatch.setitem(bench_suite.CONFIGS, "1", (
        "oracle-gate", functools.partial(bench_suite.config_oracle_gate,
                                         n=256)))
    out = tmp_path / "results.jsonl"
    out.write_text('{"config": "earlier"}\n')
    assert bench_suite.main(["--configs", "1", "--out", str(out),
                             "--device", "cpu"]) == 0
    lines = out.read_text().splitlines()
    assert len(lines) == 2 and json.loads(lines[0]) == {"config": "earlier"}
    rec = json.loads(lines[1])
    assert rec["config"] == "oracle-gate" and rec["n"] == 256
    assert rec["passed"]
    text = capsys.readouterr().out
    assert "== running config 1: oracle-gate ==" in text
    assert "| config | key numbers |\n|---|---|\n| oracle-gate | " in text


def test_a_row_that_raises_is_recorded(monkeypatch, tmp_path, capsys):
    """The ladder records ``{"config", "error"}`` and goes on, as JAX's
    does; then ``main`` returns 1, where JAX's returns 0."""
    def broken(device):
        raise RuntimeError("no card")
    monkeypatch.setitem(bench_suite.CONFIGS, "4", ("throughput-1m", broken))
    monkeypatch.setitem(bench_suite.CONFIGS, "6", (
        "viz", functools.partial(bench_suite.config_viz, n=128, steps=2)))
    out = tmp_path / "r.jsonl"
    assert bench_suite.main(["--configs", "4,6", "--out", str(out),
                             "--device", "cpu"]) == 1
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert recs[0] == {"config": "throughput-1m",
                       "error": "RuntimeError: no card"}
    assert recs[1]["config"] == "viz" and "error" not in recs[1]
    assert "| throughput-1m | " in capsys.readouterr().out


def test_cuda_without_a_card_is_an_error_row():
    """``--device cuda`` (the default) on a host without a card: every row
    is an error, nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rec = bench_suite.run_config("1")
    assert set(rec) == {"config", "error"} and "is_available" in rec["error"]
