#!/usr/bin/env python3
"""Huge-N runs of the port on one card, with their peak device memory.

    python3 tools/huge_n_run.py --phase
    python3 tools/huge_n_run.py run --n 33554432 --steps 1 [RUN OPTIONS]

``--phase`` builds the kernels and runs ``chip_smoke.py``'s huge-N phase
alone (``check_huge_n``: 4M bounded with energy, checkpoints and a resume;
16.7M flat with a frame, the heartbeat and sampled rows against float64;
the 4-shard bounded mesh at 4M), then its 4M bench line.  Otherwise the
arguments are a ``python -m nbody_tpu_torch`` command line, run in this
process between ``torch.cuda.reset_peak_memory_stats`` and
``torch.cuda.max_memory_allocated``; the memory, the wall time and the
``nvidia-smi`` name and power limit are printed after the command's own
output.  Needs a CUDA card and nvcc.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("huge_n_run: no CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    smi = nvidia_smi_line()
    if argv == ["--phase"]:
        import chip_smoke
        from nbody_tpu_torch.bench_lib import run_benchmark
        from nbody_tpu_torch.ops import _build, pe
        from nbody_tpu_torch.ops import forces_sym as k2
        from nbody_tpu_torch.ops import forces_tiled as k1
        _build.build_all(("forces_sym", "forces_tiled", "pe"))
        wrappers = (k2.forces_sym, k2.forces_sym_vpu, k2.rect_forces_sym_vpu2,
                    k1.forces_tiled, pe.pe_total, pe.pe_rows)
        chip_smoke.check_huge_n(
            lambda: {w.__name__: w.launches for w in wrappers})
        t0 = time.perf_counter()
        res = run_benchmark(n=1 << 22, steps=2)
        chip_smoke.check(res["finite"], "bench 4M: non-finite")
        print("[bench] " + json.dumps(res))
        print(f"[time] bench 4M: {time.perf_counter() - t0:.1f} s")
        print(smi)
        return 0
    from nbody_tpu_torch.cli import main as cli_main
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    print(f"[huge_n_run] {' '.join(argv)}: exit {rc}, "
          f"{time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB allocated "
          f"(torch.cuda.max_memory_allocated); {smi}")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
