#!/usr/bin/env python
"""End-to-end demo on the PyTorch / CUDA port: simulate, validate against
the float64 oracle, export a GIF (``examples/demo.py`` through
``nbody_tpu_torch``).

Run:  python examples/demo_torch.py [N] [STEPS] [DEVICE]

DEVICE is ``cuda`` (the default: the port's kernels on the card) or
``cpu`` (their plain PyTorch versions).  The GIF goes to ``demo.gif`` in
the working directory.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 4096
    steps = int(argv[1]) if len(argv) > 1 else 200
    device = argv[2] if len(argv) > 2 else "cuda"

    import nbody_tpu_torch as nt
    from nbody_tpu_torch.oracle.numpy_oracle import (oracle_run,
                                                     relative_mismatch)
    from nbody_tpu_torch.ops.step import run_trajectory
    from nbody_tpu_torch.viz.gif import write_gif
    from nbody_tpu_torch.viz.raster import render_frame

    cfg = nt.SimConfig(n_bodies=n, device=device)
    print(f"device: {device}, N={n}, steps={steps}, "
          f"impl={nt.resolve_impl(cfg)}")
    state = nt.init_state(cfg)
    host = nt.state_to_numpy(state)

    # 1. Short lock-step validation vs the float64 oracle.
    t0 = time.perf_counter()
    out = nt.state_to_numpy(nt.run_steps(state, cfg, 10))
    opos, _, _ = oracle_run(host["pos"], host["vel"], host["mass"],
                            cfg.eps2, cfg.dt, 10)
    frac = relative_mismatch(out["pos"], opos, 0.01, 1.0).mean()
    print(f"oracle check @10 steps: {frac:.4%} components outside 1% "
          f"({'OK' if frac < 1e-3 else 'FAIL'}; "
          f"{time.perf_counter() - t0:.1f} s)")

    # 2. Trajectory snapshots on the device -> frames -> animated GIF.
    t0 = time.perf_counter()
    final, snaps = run_trajectory(state, cfg, steps,
                                  snap_every=max(1, steps // 50))
    frames = [render_frame(s, final.mass, cfg.min_mass, cfg.max_mass,
                           cfg.max_view, width=400, height=300).cpu().numpy()
              for s in snaps]
    write_gif("demo.gif", frames, delay_cs=5)
    print(f"wrote demo.gif ({len(frames)} frames; "
          f"{time.perf_counter() - t0:.1f} s)")
    return 0 if frac < 1e-3 else 1


if __name__ == "__main__":
    sys.exit(main())
