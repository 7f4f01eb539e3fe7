"""Timing: completion barriers, CUDA-event timing, ``measure_steps`` and
the run loop's ``StepTimer`` (``nbody_tpu/utils/timing.py``).

PyTorch returns before the card finishes, so a host clock measures only
the enqueue unless the work ends in ``torch.cuda.synchronize()``: callers
of ``StepTimer.stop`` call ``sync`` first.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import torch


def sync(device) -> None:
    """Wait for all work queued on ``device`` (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sync_stream(device) -> None:
    """Wait for the work queued on ``device``'s current stream only (no-op
    on the CPU): a copy queued on a side stream runs on."""
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def time_ms(fn, device, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` calls after
    ``warmup`` calls: CUDA events on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1000.0 / iters


def measure_steps(fn, state, n_steps: int, warmup: bool = True):
    """Time ``fn(state, n_steps) -> state`` on the host clock, the card
    synchronised before each reading; with ``warmup`` one untimed call
    first (the kernels' build and load).  Returns (final state,
    seconds)."""
    device = state.pos.device
    if warmup:
        fn(state, n_steps)
    sync(device)
    t0 = time.perf_counter()
    out = fn(state, n_steps)
    sync(device)
    return out, time.perf_counter() - t0


@dataclass
class StepTimer:
    """Accumulates per-chunk wall times for steps/s and GInter/s (N^2
    interactions a step).  The caller syncs the device before ``stop``."""
    n_bodies: int
    times_s: List[float] = field(default_factory=list)
    steps_per_chunk: List[int] = field(default_factory=list)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int):
        self.times_s.append(time.perf_counter() - self._t0)
        self.steps_per_chunk.append(n_steps)

    @property
    def total_steps(self) -> int:
        return sum(self.steps_per_chunk)

    @property
    def total_time_s(self) -> float:
        return sum(self.times_s)

    @property
    def ms_per_step(self) -> float:
        return 1000.0 * self.total_time_s / max(1, self.total_steps)

    @property
    def steps_per_s(self) -> float:
        return self.total_steps / self.total_time_s if self.total_time_s \
            else 0.0

    @property
    def ginter_per_s(self) -> float:
        inter = float(self.n_bodies) ** 2 * self.total_steps
        return inter / self.total_time_s / 1e9 if self.total_time_s else 0.0
