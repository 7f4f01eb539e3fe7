#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nbody_tpu_torch/csrc`` into a clean
build directory, holds each kernel against its plain PyTorch version on
the card, checks the pair-symmetric kernel at N = 1,048,576 against the
direct-form ``rect_forces`` on sampled rows, drives the port's main path
(``python -m nbody_tpu_torch validate`` at N = 8192 with ``--impl auto``
and ``--impl pallas``) with the kernels' launch counters reset just before
and read just after, runs 200 steps under the momentum and angular-momentum
gates, and benchmarks.  Any failed check raises and the script exits
nonzero; without a CUDA card it exits 1 before doing anything.

The last three lines of standard output are the kernels' JSON record, the
``nvidia-smi`` name / power-limit line, and
``{"ok": true, "device": {...}}``.
"""

import importlib.metadata
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import time

# Same tolerance as the CPU tests: per component, relative 1e-4 with an
# absolute floor of 1e-6 of the largest |a|, and no component outside it.
REL_TOL = 1e-4
ABS_FLOOR = 1e-6


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def compare(name, got, want):
    """Gate ``got`` against ``want``; returns (max abs err, max rel err)."""
    import numpy as np
    from nbody_tpu_torch.oracle.numpy_oracle import relative_mismatch
    g = got.detach().cpu().double().numpy()
    w = want.detach().cpu().double().numpy()
    scale = float(np.abs(w).max())
    bad = int(relative_mismatch(g, w, REL_TOL, ABS_FLOOR * scale).sum())
    max_abs = float(np.abs(g - w).max())
    max_rel = max_abs / scale
    check(np.isfinite(g).all(), f"{name}: non-finite output")
    print(f"[check] {name}: max rel err {max_rel:.3e} (max abs "
          f"{max_abs:.3e}), {bad} of {g.size} components outside "
          f"rel {REL_TOL:g} + {ABS_FLOOR:g}*max")
    check(bad == 0, f"{name}: {bad} components outside tolerance")
    return max_abs, max_rel


def bodies(n, seed, device):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    pos = torch.empty(n, 3, device=device).uniform_(-1e5, 1e5, generator=g)
    mass = torch.empty(n, device=device).uniform_(1e5, 1e9, generator=g)
    return pos, mass


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    from nbody_tpu_torch.ops import _build

    # 1. Toolchain.
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    print("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    triton = (importlib.metadata.version("triton")
              if importlib.util.find_spec("triton") else "not installed")
    print(f"triton {triton}")
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; nvidia-smi name, power.limit: {smi}")

    # 2. Build both kernels from a clean build directory.
    shutil.rmtree(_build.BUILD_ROOT, ignore_errors=True)
    for lib in ("forces_tiled", "forces_sym"):
        _build.load(lib)
        print(f"[build] {lib}.cu: {_build.BUILD_SECONDS[lib]:.2f} s")
        for line in _build.BUILD_LOG[lib].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_tiled as k1
    from nbody_tpu_torch.ops.forces import SYM_CROSSOVER_N
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.utils.timing import time_ms
    eps2 = 0.002

    # 3. Kernel vs plain twin on the card.
    record = {}
    for n in (1000, 8192):
        pos, mass = bodies(n, n, dev)
        got = k1.forces_tiled(pos, mass, eps2)
        want = k1.rect_forces_tiled_plain(pos, pos, mass, eps2)
        torch.cuda.synchronize()
        err = compare(f"K1 forces_tiled vs plain, N={n}", got, want)
        if n == 8192:
            record["forces_tiled"] = {
                "max_abs_err": err[0],
                "ms": time_ms(lambda: k1.forces_tiled(pos, mass, eps2), dev),
                "plain_ms": time_ms(lambda: k1.rect_forces_tiled_plain(
                    pos, pos, mass, eps2), dev, iters=3)}
    for n in (1000, 3001, 8192):
        pos, mass = bodies(n, n + 1, dev)
        got = k2.forces_sym(pos, mass, eps2)
        want = k2.forces_sym_plain(pos, mass, eps2)
        torch.cuda.synchronize()
        err = compare(f"K2 forces_sym vs plain, N={n}", got, want)
        again = k2.forces_sym(pos, mass, eps2)
        check(torch.equal(got, again), f"K2 N={n}: not bit-reproducible")
        chunked = k2.forces_sym(pos, mass, eps2,
                                slot_budget=24 * (-(-n // 256) * 256))
        check(torch.equal(got, chunked),
              f"K2 N={n}: one offset per chunk differs from one chunk")
        if n == 8192:
            record["forces_sym"] = {
                "max_abs_err": err[0],
                "ms": time_ms(lambda: k2.forces_sym(pos, mass, eps2), dev),
                "plain_ms": time_ms(lambda: k2.forces_sym_plain(
                    pos, mass, eps2), dev, iters=3)}
    pos, mass = bodies(1000, 7, dev)
    mass[[3, 400, 999]] = 0.0
    compare("K2 with three real zero-mass bodies vs direct form",
            k2.forces_sym(pos, mass, eps2), rect_forces(pos, pos, mass, eps2))
    print("[check] K2 bit-reproducible run to run and across offset chunks")
    for kname, r in record.items():
        print(f"[time] {kname} N=8192: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms ({smi})")

    # K1 / K2 crossover: force-evaluation times over N, the median of five
    # alternating rounds of 100 launches each.
    print(f"[crossover] N, K1 ms, K2 ms, median of 5 ({smi}); auto takes "
          f"K2 from N={SYM_CROSSOVER_N}")
    for n in (512, 1024, 1536, 2048, 3072, 4096, 8192, 16384):
        pos, mass = bodies(n, 3, dev)
        t1, t2 = [], []
        for _ in range(5):
            t1.append(time_ms(lambda: k1.forces_tiled(pos, mass, eps2), dev,
                              iters=100))
            t2.append(time_ms(lambda: k2.forces_sym(pos, mass, eps2), dev,
                              iters=100))
        t1, t2 = statistics.median(t1), statistics.median(t2)
        print(f"[crossover] {n} {t1:.4f} {t2:.4f} "
              f"{'K2' if t2 < t1 else 'K1'} faster")

    # 4. K2 at the 1M headline, sampled rows vs the direct form.
    import nbody_tpu_torch as nt
    n = 1 << 20
    cfg = nt.SimConfig(n_bodies=n, device="cuda")
    check(nt.resolve_impl(cfg) == "pallas_sym2", "auto at 1M is not K2")
    state = nt.init_state(cfg)
    t0 = time.perf_counter()
    acc = nt.compute_forces(state.pos, state.mass, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    eval_ms = time_ms(lambda: nt.compute_forces(state.pos, state.mass, cfg),
                      dev, iters=2, warmup=0)
    print(f"[1M] compute_forces (K2) first call {first_s:.3f} s; "
          f"{eval_ms:.2f} ms per evaluation")
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(0))[:4096]
    rows = rows.to(dev)
    ref = rect_forces(state.pos[rows], state.pos, state.mass, cfg.eps2,
                      chunk=64)
    compare("K2 at N=1,048,576, 4096 sampled rows vs rect_forces",
            acc[rows], ref)
    del state, acc, ref

    # 5. The main path, through the CLI, with the launch counters.  The
    # float64 gates run at seed 5: at seeds 0, 1, 2 and 4 the uniform box
    # holds close encounters whose 10-step outcome differs between float32
    # and float64 arithmetic, and there the numpy oracle run in float32
    # misses the float64 gate on the same components as the kernels
    # (PERF.md, "Validate horizon at N=8192").  Seed 0, the default, is
    # gated against the float32 oracle, the reference's CPU precision.
    from nbody_tpu_torch.cli import main as cli_main

    def counts():
        return {"forces_tiled": k1.forces_tiled.launches,
                "forces_sym": k2.forces_sym.launches}

    k1.forces_tiled.launches = 0
    k2.forces_sym.launches = 0
    # impl -> the one kernel its 10 steps must launch 10 times.
    for impl, kernel, extra in (
            ("auto", "forces_sym", ["--seed", "5"]),
            ("pallas", "forces_tiled", ["--seed", "5"]),
            ("auto", "forces_sym", ["--seed", "0", "--oracle-f32"])):
        before = counts()
        rc = cli_main(["validate", "--n", "8192", "--steps", "10",
                       "--long-steps", "0", "--impl", impl, *extra])
        check(rc == 0, f"validate --impl {impl} {' '.join(extra)} failed")
        delta = {k: v - before[k] for k, v in counts().items()}
        expect = {k: 10 if k == kernel else 0 for k in delta}
        check(delta == expect, f"validate --impl {impl} launched {delta}, "
              f"expected {expect}")
    launches = counts()
    print(f"[main path] launch counts: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path did not launch: {launches}")

    # 6. Invariants over 200 device-only steps.
    from nbody_tpu_torch.analysis import invariant_drifts
    cfg = nt.SimConfig(n_bodies=8192, device="cuda")
    out = nt.run_steps(nt.init_state(cfg), cfg, 200)
    host = nt.state_to_numpy(out)
    import numpy as np
    check(np.isfinite(host["pos"]).all(), "non-finite state after 200 steps")
    p_drift, l_drift = invariant_drifts(host["pos"], host["vel"],
                                        host["mass"])
    print(f"[invariants] 200 steps N=8192 ({nt.resolve_impl(cfg)}): "
          f"|P|/scale {p_drift:.3e}, |L|/scale {l_drift:.3e} (gate 1e-3)")
    check(p_drift <= 1e-3 and l_drift <= 1e-3, "invariant gate")

    # 7. Bench lines.
    from nbody_tpu_torch.bench_lib import run_benchmark
    for n, impl in ((8192, "auto"), (8192, "pallas"), (8192, "xla"),
                    (1 << 20, "auto")):
        res = run_benchmark(n=n, impl=impl)
        check(res["finite"], f"bench N={n} {impl}: non-finite")
        print("[bench] " + json.dumps(res))

    kernels = []
    for kname, src, repl in (
            ("forces_tiled", "nbody_tpu_torch/csrc/forces_tiled.cu",
             "nbody_tpu/ops/forces_pallas.py:147"),
            ("forces_sym", "nbody_tpu_torch/csrc/forces_sym.cu",
             "nbody_tpu/ops/forces_pallas_sym.py:353")):
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[kname],
                        **record[kname]})
    kernels[1]["also_replaces"] = "nbody_tpu/ops/forces_pallas_sym.py:328"
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
