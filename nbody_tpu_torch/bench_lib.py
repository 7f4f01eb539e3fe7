"""Benchmark harness (``python -m nbody_tpu_torch bench``).

The trial protocol and JSON keys of ``nbody_tpu/bench_lib.py``: one warmup,
then at least three timed trials of ``steps`` steps each; the headline is
the throughput of the median-time trial, with the spread beside it.
GInteractions/s counts N^2 interactions per step for every impl, the
pair-symmetric one included.

Differences: trials are timed with CUDA events on a card; ``compile_s`` is
the time spent building the CUDA kernels in this call (0.0 when they were
already built); ``vs_baseline`` is null, because the JAX package's
300 GInter/s target is a TPU v5e figure; and each line names the card and
its power limit.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .config import SimConfig
from .models.energy import energy_f64
from .models.init import init_state
from .ops import _build
from .ops.forces import resolve_impl
from .ops.step import run_steps
from .utils.device import nvidia_smi_line, require_device
from .utils.timing import sync

_KERNEL_LIBS = {"pallas": ("forces_tiled",), "pallas_sym2": ("forces_sym",)}


def run_benchmark(n: int = 65536, steps: Optional[int] = None,
                  impl: str = "auto", block_i: int = 512,
                  block_j: int = 2048, chunk: int = 1024,
                  energy: bool = False, warmup_steps: Optional[int] = None,
                  seed: int = 0, trials: int = 3,
                  block_u: Optional[int] = None,
                  device: str = "cuda") -> dict:
    dev = require_device(device)
    cfg = SimConfig(n_bodies=n, impl=impl, block_i=block_i, block_j=block_j,
                    chunk=chunk, seed=seed, block_u=block_u, device=device)
    impl_resolved = resolve_impl(cfg)
    on_cuda = dev.type == "cuda"
    if steps is None:
        # Size a trial to ~0.5 s of device work at a rough rate for the
        # path (a guess that only sets the trial length); ~0.3 s on CPU.
        rate = (1e12 if impl_resolved.startswith("pallas") else 1e11) \
            if on_cuda else 2e9
        target = 0.5 if on_cuda else 0.3
        steps = int(min(1000 if on_cuda else 100,
                        max(3 if on_cuda else 5, target * rate // (n * n))))

    compile_s = 0.0
    if on_cuda:
        for name in _KERNEL_LIBS.get(impl_resolved, ()):
            _build.load(name)
            compile_s += _build.BUILD_SECONDS[name]

    state = init_state(cfg)
    e0 = energy_f64(state, cfg.eps2) if energy else None

    if warmup_steps is None:
        warmup_steps = 1
    t0 = time.perf_counter()
    state = run_steps(state, cfg, max(1, warmup_steps), impl=impl_resolved)
    sync(dev)
    warm_s = time.perf_counter() - t0

    per_trial = []
    for _ in range(max(1, trials)):
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state = run_steps(state, cfg, steps, impl=impl_resolved)
            end.record()
            end.synchronize()
            per_trial.append(start.elapsed_time(end) / 1000.0)
        else:
            t0 = time.perf_counter()
            state = run_steps(state, cfg, steps, impl=impl_resolved)
            per_trial.append(time.perf_counter() - t0)
    elapsed = float(np.sort(per_trial)[(len(per_trial) - 1) // 2])
    per_trial_g = sorted(n * n * steps / s / 1e9 for s in per_trial)
    ginter = n * n * steps / elapsed / 1e9

    e1 = energy_f64(state, cfg.eps2) if energy else None
    result = {
        "metric": "GInteractions/s",
        "value": round(ginter, 4),
        "unit": "GInter/s",
        "vs_baseline": None,
        "n_bodies": n,
        "steps": steps,
        "trials": len(per_trial),
        "impl": impl_resolved,
        "ms_per_step": round(elapsed / steps * 1000, 4),
        "ginter_min": round(per_trial_g[0], 4),
        "ginter_max": round(per_trial_g[-1], 4),
        "spread_pct": round(100.0 * (per_trial_g[-1] - per_trial_g[0])
                            / ginter, 2) if ginter else 0.0,
        "compile_plus_warmup_s": round(compile_s + warm_s, 2),
        "compile_s": round(compile_s, 2),
        "first_touch_s": round(warm_s, 2),
        "backend": dev.type,
        "device_name": (torch.cuda.get_device_name(dev) if on_cuda
                        else "cpu"),
        "nvidia_smi": nvidia_smi_line() if on_cuda else "not available",
        "devices": 1,
        "shards": 1,
        "flat": False,
        "resident": False,
    }
    if energy and e0 is not None:
        result["energy_drift"] = abs(e1 - e0) / (abs(e0) or 1.0)
    result["finite"] = bool(torch.isfinite(state.pos[:64]).all())
    return result
