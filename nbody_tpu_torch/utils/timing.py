"""Timing: completion barriers and CUDA-event timing.

PyTorch returns before the card finishes, so a host clock measures only
the enqueue unless the work ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import time

import torch


def sync(device) -> None:
    """Wait for all work queued on ``device`` (no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


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
