"""Structured run logging, a copy of ``nbody_tpu/io/logger.py`` (which
imports no JAX, but the port imports nothing of the JAX package).

One structured record per reporting interval — step, sim-time, wall
ms/step, GInter/s, and (optionally) energy drift — to stdout and, when a
path is given, JSONL and/or CSV, with the same fields and formats.
"""

from __future__ import annotations

import csv
import io
import json
import sys
from typing import Optional, TextIO

_FIELDS = ["step", "sim_time", "ms_per_step", "steps_per_s", "ginter_per_s",
           "energy", "energy_drift", "max_speed"]


class RunLogger:
    def __init__(self, jsonl_path: Optional[str] = None,
                 csv_path: Optional[str] = None,
                 stream: Optional[TextIO] = None, quiet: bool = False):
        self.quiet = quiet
        self.stream = stream if stream is not None else sys.stdout
        self._jsonl: Optional[TextIO] = (
            open(jsonl_path, "w") if jsonl_path else None)
        self._csv_file: Optional[TextIO] = (
            open(csv_path, "w", newline="") if csv_path else None)
        self._csv = None
        if self._csv_file:
            self._csv = csv.DictWriter(self._csv_file, fieldnames=_FIELDS,
                                       extrasaction="ignore")
            self._csv.writeheader()

    def log(self, **record):
        if not self.quiet:
            parts = [f"step {record.get('step', '?'):>8}"]
            if "ms_per_step" in record:
                parts.append(f"{record['ms_per_step']:8.2f} ms/step")
            if "ginter_per_s" in record:
                g = record["ginter_per_s"]
                # Small-N rates round to "0.0" at fixed precision; keep
                # 3 significant digits below 10 G/s.
                parts.append(f"{g:8.1f} GInter/s" if g >= 10
                             else f"{g:8.3g} GInter/s")
            if record.get("energy_drift") is not None:
                parts.append(f"drift {record['energy_drift']:.3e}")
            print("  ".join(parts), file=self.stream)
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._csv:
            self._csv.writerow(record)
            self._csv_file.flush()

    def banner(self, text: str):
        if not self.quiet:
            print(text, file=self.stream)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._csv_file:
            self._csv_file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
