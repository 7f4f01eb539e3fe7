"""Benchmark harness (``python -m nbody_tpu_torch bench``).

The trial protocol and JSON keys of ``nbody_tpu/bench_lib.py``: one warmup,
then at least three timed trials of ``steps`` steps each; the headline is
the throughput of the median-time trial, with the spread beside it.
GInteractions/s counts N^2 interactions per step for every impl, the
pair-symmetric one included.

Routing is ``Simulation``'s: with ``resident`` (None = auto, True forces
and raises out of scope) a trial of ``steps`` steps is one launch of the
resident kernel K3, and the ``"resident"`` key reports what ran.  With
``shards`` > 1 a trial runs through ``run_steps_sharded`` on a mesh of
that many shards (one card's shards share it) with the ``comm`` tier (the
rdma comms: one K13 launch a force evaluation), and never the resident
kernels; forcing them with shards raises, as in the JAX package.
``energy`` works at any N: ``energy_f64`` takes kernel K8 above 262,144
bodies.  Huge N routes as ``Simulation`` does: ``should_use_flat`` runs
the flat state (``run_steps_flat``; ``"flat": true``),
``should_use_multiprog`` the bounded dispatch (``run_steps_multiprog``, or
on a ring mesh ``run_steps_sharded_multiprog``), both bit-equal to the
unbounded loop; ``prog_cap`` and ``flat_state`` are the config's fields.
Forcing the resident kernels against them raises, as in the JAX package.

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
from .models.energy import MAX_HOST_ENERGY_N, energy_f64
from .models.init import init_state
from .ops import _build
from .ops.forces import resolve_impl
from .models.init import init_state_flat
from .ops.resident import run_steps_resident, should_use_resident
from .ops.step import (run_steps, run_steps_flat, run_steps_multiprog,
                       should_use_flat, should_use_multiprog)
from .parallel.mesh import make_mesh
from .parallel.multiprog import run_steps_sharded_multiprog
from .parallel.ring import _resolve_local_impl, run_steps_sharded
from .utils.device import nvidia_smi_line, require_device
from .utils.timing import sync

_KERNEL_LIBS = {"pallas": ("forces_tiled",), "pallas_sym2": ("forces_sym",),
                "pallas_sym": ("forces_sym",),
                "pallas_kahan": ("forces_tiled",),
                "pallas_fast": ("forces_fast",),
                "pallas_turbo": ("forces_tiled_tc",),
                "pallas_mxu": ("forces_tiled_tc",),
                "pallas_sym_turbo": ("forces_sym_tc",),
                "pallas_sym_mxu": ("forces_sym_tc",),
                "pallas_sym_turbo2": ("forces_sym_tc",)}


def run_benchmark(n: int = 65536, steps: Optional[int] = None,
                  impl: str = "auto", block_i: int = 512,
                  block_j: int = 2048, chunk: int = 1024,
                  energy: bool = False, warmup_steps: Optional[int] = None,
                  seed: int = 0, trials: int = 3,
                  block_u: Optional[int] = None,
                  resident: Optional[bool] = None,
                  device: str = "cuda", shards: Optional[int] = None,
                  comm: str = "ring", prog_cap: Optional[float] = None,
                  flat_state: Optional[bool] = None) -> dict:
    from .utils.compcache import enable_compilation_cache
    enable_compilation_cache()
    dev = require_device(device)
    sharded = bool(shards and shards > 1)
    cfg = SimConfig(n_bodies=n, impl=impl, block_i=block_i, block_j=block_j,
                    chunk=chunk, seed=seed, block_u=block_u,
                    resident=resident, device=device,
                    shards=shards if sharded else None, prog_cap=prog_cap,
                    flat_state=flat_state)
    impl_resolved = resolve_impl(cfg, sharded=sharded)
    if sharded:
        mesh = make_mesh(shards, device)
        impl_resolved = _resolve_local_impl(impl, mesh, comm,
                                            default=impl_resolved)
        if flat_state:
            raise ValueError(
                "flat-state + mesh is unnecessary by design (a mesh shard is "
                "(N/P, 3)); drop flat_state — mesh runs at any N route "
                "through the sharded bounded programs")
    # Simulation's routing: flat, then the bounded dispatch (a forced
    # resident run keeps a cap that does not split one step), then the
    # resident kernels.
    used_flat = not sharded and should_use_flat(cfg, impl_resolved)
    forced_resident = (resident is True and not sharded
                       and (prog_cap is None
                            or cfg.interactions_per_step <= prog_cap))
    bounded = used_flat or (
        (not sharded or comm == "ring") and not forced_resident
        and should_use_multiprog(cfg, impl_resolved,
                                 shards if sharded else 1))
    used_resident = not bounded and should_use_resident(
        cfg, impl_resolved, sharded=sharded)
    if resident is True and not used_resident:
        should_use_resident(cfg, impl_resolved, sharded=sharded)
        raise ValueError(
            "resident=True but flat/multiprog routing preempts the resident "
            "kernels (whole steps in one launch); drop resident=True or the "
            "scale options")
    on_cuda = dev.type == "cuda"
    if steps is None:
        # Size a trial to ~0.5 s of device work at a rough rate for the
        # path (a guess that only sets the trial length); ~0.3 s on CPU.
        rate = (1e12 if impl_resolved.startswith("pallas") else 1e11) \
            if on_cuda else 2e9
        target = 0.5 if on_cuda else 0.3
        steps = int(min(1000 if on_cuda else 100,
                        max(3 if on_cuda else 5, target * rate // (n * n))))

    if sharded:
        # The one-sided rect forms (the antipodal rotation, allgather) too;
        # the rdma comms run K13 alone.
        libs = (("rdma_ring",) if comm.startswith("rdma")
                else _KERNEL_LIBS.get(impl_resolved, ()) + (
                    ("forces_tiled", "forces_tiled_tc")
                    if impl_resolved.startswith("pallas") else ()))

        def advance(s, k):
            if bounded:
                return run_steps_sharded_multiprog(s, cfg, mesh, k,
                                                   impl=impl_resolved)
            return run_steps_sharded(s, cfg, mesh, k, impl=impl_resolved,
                                     comm=comm)
    elif used_flat:
        libs = _KERNEL_LIBS.get(impl_resolved, ())

        def advance(s, k):
            return run_steps_flat(s, cfg, k, impl=impl_resolved)
    elif bounded:
        libs = _KERNEL_LIBS.get(impl_resolved, ())

        def advance(s, k):
            return run_steps_multiprog(s, cfg, k, impl=impl_resolved)
    elif used_resident:
        libs = ("resident",)

        def advance(s, k):
            return run_steps_resident(s, cfg, k)
    else:
        libs = _KERNEL_LIBS.get(impl_resolved, ())

        def advance(s, k):
            return run_steps(s, cfg, k, impl=impl_resolved)
    if energy and n > MAX_HOST_ENERGY_N:
        libs += ("pe",)
    compile_s = 0.0
    if on_cuda:
        t0 = time.perf_counter()
        _build.build_all(libs)
        compile_s = time.perf_counter() - t0

    state = init_state_flat(cfg) if used_flat else init_state(cfg)
    e0 = energy_f64(state, cfg.eps2) if energy else None

    if warmup_steps is None:
        warmup_steps = 1
    t0 = time.perf_counter()
    state = advance(state, max(1, warmup_steps))
    sync(dev)
    warm_s = time.perf_counter() - t0

    per_trial = []
    for _ in range(max(1, trials)):
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state = advance(state, steps)
            end.record()
            end.synchronize()
            per_trial.append(start.elapsed_time(end) / 1000.0)
        else:
            t0 = time.perf_counter()
            state = advance(state, steps)
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
        "devices": len(set(mesh.devices)) if sharded else 1,
        "shards": shards if sharded else 1,
        "flat": used_flat,
        "resident": used_resident,
    }
    if sharded:
        result["comm"] = comm
    if energy and e0 is not None:
        result["energy_drift"] = abs(e1 - e0) / (abs(e0) or 1.0)
    result["finite"] = bool(torch.isfinite(state.pos[:64]).all())
    return result
