"""Asynchronous frame streaming: device frames -> host writer thread.

The reference renders every simulation step synchronously in the host loop
(``main.cpp:129-133``); the rebuild decouples render cadence from step
cadence (``viz_every``) and writes frames on a background thread so disk IO
never stalls the simulation (SURVEY.md section 7 'Frame streaming without
stalling the sim').

A copy of ``nbody_tpu/viz/stream.py`` (numpy only): the port runs where JAX
is not installed, and importing anything under ``nbody_tpu`` imports
JAX.  ``tests/test_torch_viz.py`` holds its output to the
original's byte for byte.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np

from .png import write_png


class FrameStreamer:
    """Background PNG writer. ``submit`` enqueues an (H,W,3) uint8 frame
    (already on host or a device array — converted here); ``close`` drains."""

    def __init__(self, out_dir: str, prefix: str = "frame",
                 max_queue: int = 64, compress_level: int = 3):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.prefix = prefix
        self.compress_level = compress_level
        self._q: "queue.Queue[Optional[tuple[int, np.ndarray]]]" = (
            queue.Queue(maxsize=max_queue))
        self._frames_written = 0
        self._errors: "list[Exception]" = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            idx, frame = item
            try:
                write_png(
                    os.path.join(self.out_dir,
                                 f"{self.prefix}_{idx:06d}.png"),
                    frame, self.compress_level)
                self._frames_written += 1
            except Exception as e:  # surfaced on close
                self._errors.append(e)

    def submit(self, idx: int, frame) -> None:
        self._q.put((idx, np.asarray(frame)))

    @property
    def frames_written(self) -> int:
        return self._frames_written

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._errors:
            raise self._errors[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TeeStreamer:
    """Fan one frame stream out to several sinks (e.g. PNG files on disk
    AND the live HTTP viewer)."""

    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def submit(self, idx: int, frame) -> None:
        frame = np.asarray(frame)
        for s in self.sinks:
            s.submit(idx, frame)

    @property
    def frames_written(self) -> int:
        return max((s.frames_written for s in self.sinks), default=0)

    def control_state(self) -> str:
        """Most-severe run-control request across sinks (stop > pause >
        run); sinks without run control count as "run"."""
        states = {s.control_state() for s in self.sinks
                  if hasattr(s, "control_state")}
        for sev in ("stop", "pause"):
            if sev in states:
                return sev
        return "run"

    def close(self) -> None:
        errs = []
        for s in self.sinks:
            try:
                s.close()
            except Exception as e:
                errs.append(e)
        if errs:
            raise errs[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
