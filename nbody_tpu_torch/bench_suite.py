"""The JAX rounds' benchmark ladder on the port.

    python -m nbody_tpu_torch.bench_suite [--configs 1,3,4] [--out F.jsonl]
        [--device cuda|cpu]

The counterpart of ``scripts/bench_suite.py`` (which imports JAX and stays
as it is): the same rows under the same keys and names, the same default
``--configs 1,2,3,4,5,6`` with rows 7 and 8 opt-in, one JSON record a row
with the JAX row's keys, ``--out`` appending each record as a line, and
the closing markdown table.  Each row runs the port's own entries:

  1. oracle-gate      N = 4096, 10 steps of ``run_steps`` (auto: K2 a
                      step) against the numpy float64 oracle, the bad
                      fractions of pos / vel / acc at 1%, passed at <= 1e-3
  2. drift-gate       N = 8192, 1000 steps at the default eps2, the energy
                      against the native float64 oracle's (``passed_1e-3``)
  3. throughput-64k   ``run_benchmark(n=65536, steps=None)``
  4. throughput-1m    ``run_benchmark(n=1048576, steps=3)``
  5. ring             N = 262,144 on as many shards as the host has cards
                      (one card: one shard, the plain path; four: the N3L
                      ring, one shard a card)
  6. viz              N = 65,536, ``Simulation`` with a frame a step into
                      a ``FrameStreamer``: a warm run of 20 steps, then 20
                      timed
  7. drift-gate-soft  row 2 at eps2 = 1e6
  8. scale-4m         ``run_benchmark(n=4194304, steps=2)`` (bounded)

Where it differs: ``backend`` is the torch device's type; every record
names the card and its power limit (``nvidia_smi``); each row takes the
JAX row's sizes as keyword defaults, so that the CPU tests run it small,
and the CLI exposes none of them, as JAX's does not; ``--device`` is
``cuda`` unless ``cpu`` is given; a row that raises is recorded as JAX
records it, ``{"config", "error"}``, and the ladder goes on, but ``main``
returns 1 when any row erred, where JAX's returns 0.

This is the JAX side's entry point, not the port's benchmark: it writes
no ``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from .bench_lib import run_benchmark
from .config import SimConfig
from .models.energy import energy_f64
from .models.init import init_state
from .models.simulation import Simulation
from .models.state import SimState
from .ops.step import run_steps
from .oracle import native
from .oracle.numpy_oracle import oracle_run, relative_mismatch
from .utils.device import nvidia_smi_line, require_device
from .utils.timing import sync
from .viz.stream import FrameStreamer


def _host(state: SimState):
    return tuple(t.cpu().numpy() for t in (state.pos, state.vel, state.mass))


def _card(dev: torch.device) -> str:
    return nvidia_smi_line() if dev.type == "cuda" else "not available"


def config_oracle_gate(n: int = 4096, steps: int = 10,
                       device: str = "cuda") -> dict:
    # steps: the chaotic-divergence horizon at N = 4096 (cli.py validate).
    dev = require_device(device)
    cfg = SimConfig(n_bodies=n, impl="auto", device=device)
    state = init_state(cfg)
    pos0, vel0, mass = _host(state)
    out = run_steps(state, cfg, steps)
    opos, ovel, oacc = oracle_run(pos0, vel0, mass, cfg.eps2, cfg.dt, steps)
    fracs = {
        "pos": float(relative_mismatch(out.pos.cpu().numpy(), opos,
                                       0.01, 1.0).mean()),
        "vel": float(relative_mismatch(out.vel.cpu().numpy(), ovel,
                                       0.01, 1e-2).mean()),
        "acc": float(relative_mismatch(out.acc.cpu().numpy(), oacc,
                                       0.01, 1e-6).mean()),
    }
    return {"config": "oracle-gate", "n": n, "steps": steps,
            "bad_fracs": fracs,
            "passed": all(v <= 1e-3 for v in fracs.values()),
            "backend": dev.type, "nvidia_smi": _card(dev)}


def config_drift_gate(steps: int = 1000, eps2: Optional[float] = None,
                      tag: str = "drift-gate", n: int = 8192,
                      device: str = "cuda") -> dict:
    dev = require_device(device)
    kw = {} if eps2 is None else {"eps2": eps2}
    cfg = SimConfig(n_bodies=n, impl="auto", device=device, **kw)
    state = init_state(cfg)
    pos0, vel0, mass = _host(state)
    out = run_steps(state, cfg, steps)
    e_dev = energy_f64(out, cfg.eps2)
    rec = {"config": tag, "n": n, "steps": steps, "eps2": cfg.eps2,
           "backend": dev.type, "e_device": e_dev}
    if native.available():
        t0 = time.time()
        opos, ovel, oacc = native.native_run(pos0, vel0, mass, cfg.eps2,
                                             cfg.dt, steps, dtype=np.float64)
        rec["oracle_seconds"] = round(time.time() - t0, 1)
        e_ora = energy_f64(SimState(pos=opos, vel=ovel, acc=oacc,
                                    mass=mass), cfg.eps2)
        rec["e_oracle"] = e_ora
        rec["energy_drift_vs_oracle"] = float(abs(e_dev - e_ora) / abs(e_ora))
        rec["passed_1e-3"] = bool(rec["energy_drift_vs_oracle"] <= 1e-3)
    rec["nvidia_smi"] = _card(dev)
    return rec


def config_drift_gate_soft(steps: int = 1000, n: int = 8192,
                           device: str = "cuda") -> dict:
    """BASELINE's 1e-3 energy-drift criterion with softening ~ the
    interparticle spacing / 10 (eps2 = 1e6), which regularizes close
    encounters; the reference's eps2 = 0.002 at 1e5-scale positions is
    effectively unsoftened (cli.py validate)."""
    return config_drift_gate(steps=steps, eps2=1e6, tag="drift-gate-soft",
                             n=n, device=device)


def config_throughput_64k(n: int = 65536, device: str = "cuda") -> dict:
    # steps=None: trials sized by duration, as the JAX row's.
    rec = run_benchmark(n=n, steps=None, device=device)
    rec["config"] = "throughput-64k"
    return rec


def config_throughput_1m(n: int = 1048576, steps: int = 3,
                         device: str = "cuda") -> dict:
    rec = run_benchmark(n=n, steps=steps, device=device)
    rec["config"] = "throughput-1m"
    return rec


def config_ring(n: int = 262144, steps: int = 3,
                shards: Optional[int] = None, device: str = "cuda") -> dict:
    """Over every card of the host (JAX: ``jax.local_device_count()``),
    one shard a card; on the CPU one shard unless ``shards`` says."""
    if shards is None:
        shards = (torch.cuda.device_count()
                  if require_device(device).type == "cuda" else 1)
    rec = run_benchmark(n=n, steps=steps, shards=shards, device=device)
    rec["config"] = "ring"
    return rec


def config_viz(n: int = 65536, steps: int = 20,
               device: str = "cuda") -> dict:
    dev = require_device(device)
    cfg = SimConfig(n_bodies=n, impl="auto", viz_every=1, device=device)
    sim = Simulation(cfg)
    with tempfile.TemporaryDirectory() as td:
        with FrameStreamer(td) as fs:
            # The warm run takes as many steps as the timed one, as the
            # JAX row's, whose batched frame program embeds the chunk.
            sim.run(n_steps=steps, log_every=0, frame_streamer=fs)
            warm_frames = fs.frames_written
            t0 = time.perf_counter()
            sim.run(n_steps=steps, log_every=0, frame_streamer=fs)
            sync(dev)
            dt = time.perf_counter() - t0
            frames = fs.frames_written - warm_frames
    return {"config": "viz", "n": n, "steps": steps,
            "frames": frames, "fps": round(frames / dt, 2),
            "steps_per_s": round(steps / dt, 2),
            "backend": dev.type, "nvidia_smi": _card(dev)}


def config_scale_4m(n: int = 1 << 22, steps: int = 2,
                    device: str = "cuda") -> dict:
    """The bounded-program scale row (auto routes it through the bounded
    dispatch)."""
    rec = run_benchmark(n=n, steps=steps, device=device)
    rec["config"] = "scale-4m"
    return rec


CONFIGS = {
    "1": ("oracle-gate", config_oracle_gate),
    "2": ("drift-gate", config_drift_gate),
    "3": ("throughput-64k", config_throughput_64k),
    "4": ("throughput-1m", config_throughput_1m),
    "5": ("ring", config_ring),
    "6": ("viz", config_viz),
    "7": ("drift-gate-soft", config_drift_gate_soft),
    "8": ("scale-4m", config_scale_4m),   # opt-in: not in the default list
}


def run_config(key: str, device: str = "cuda") -> dict:
    """Row ``key`` at its full size; a row that raises gives
    ``{"config", "error"}``."""
    name, fn = CONFIGS[key]
    try:
        return fn(device=device)
    except Exception as e:  # the ladder records the row and goes on
        return {"config": name, "error": f"{type(e).__name__}: {e}"}


def print_table(results) -> None:
    """The closing markdown table of JAX's ladder."""
    print("\n| config | key numbers |")
    print("|---|---|")
    for r in results:
        key_bits = {k: v for k, v in r.items() if k not in ("config",)}
        print(f"| {r['config']} | {json.dumps(key_bits)[:160]} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m nbody_tpu_torch.bench_suite",
        description="The JAX rounds' benchmark ladder on the port.")
    ap.add_argument("--configs", default="1,2,3,4,5,6")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = []
    for key in args.configs.split(","):
        key = key.strip()
        print(f"== running config {key}: {CONFIGS[key][0]} ==", flush=True)
        rec = run_config(key, args.device)
        print(json.dumps(rec), flush=True)
        results.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print_table(results)
    return 1 if any("error" in r for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
