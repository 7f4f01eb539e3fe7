#!/usr/bin/env python
"""Long-horizon orbital mechanics on the PyTorch / CUDA port: the
symplectic + resident showcase (``examples/orbit.py`` through
``nbody_tpu_torch``).

The reference's integrator (half-kick + drift, ``kernel.cu:116-124``) is
fine for its interactive demo but drifts secularly on orbits.  For each
integrator this runs a two-body circular Kepler orbit for one period
against its closed form (``models/kepler.py``), then a Plummer cluster in
virial equilibrium for STEPS steps, and prints the measured energy drift:
the 4th-order Yoshida composition holds orbits far longer.  At N up to
``RESIDENT_AUTO_MAX_N`` the cluster runs in resident multi-step launches
on the card (K3 for ``reference``, K4 for ``yoshida4``: one launch a
chunk, the state in shared memory between steps).

Run:  python examples/orbit_torch.py [N] [STEPS] [DEVICE]

DEVICE is ``cuda`` (the default) or ``cpu``.
"""

import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

KEPLER_STEPS = 1024          # steps in the Kepler orbit's one period


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 4096
    steps = int(argv[1]) if len(argv) > 1 else 100_000
    device = argv[2] if len(argv) > 2 else "cuda"

    import nbody_tpu_torch as nt
    from nbody_tpu_torch.models.energy import energy_f64
    from nbody_tpu_torch.models.init import plummer_virial_state
    from nbody_tpu_torch.models.kepler import (circular_positions,
                                               max_rel_error,
                                               two_body_circular)

    print(f"device: {device}, N={n}, steps={steps}")
    for integrator in ("reference", "yoshida4"):
        # The closed-form two-body orbit, one period (softened, eps2 =
        # 0.01; the reference's half-force dynamics for "reference").
        two, w = two_body_circular(1.0, 1.0, 0.5, 0.01, integrator,
                                   device=device)
        period = 2.0 * math.pi / w
        cfg = nt.SimConfig(n_bodies=2, integrator=integrator, eps2=0.01,
                           dt=period / KEPLER_STEPS, device=device)
        sim = nt.Simulation(cfg, state=two)
        sim.run(n_steps=KEPLER_STEPS, log_every=0)
        err = max_rel_error(sim.state.pos, circular_positions(
            period, 1.0, 1.0, 0.5, 0.01, integrator), 1.0)
        print(f"{integrator:>10}: Kepler orbit, one period in "
              f"{KEPLER_STEPS} steps: max |r - r_exact| / d = {err:.3e}")

        # A gravitationally bound cluster in virial equilibrium (a cold
        # sphere collapses violently and would confound the comparison);
        # dt well under the cluster's central dynamical time.
        cfg = nt.SimConfig(n_bodies=n, integrator=integrator, dt=0.02,
                           eps2=1e6, seed=7, device=device)
        sim = nt.Simulation(cfg, state=plummer_virial_state(cfg))
        e0 = energy_f64(sim.state, cfg.eps2)
        t0 = time.perf_counter()
        sim.run(n_steps=steps, log_every=0)
        wall = time.perf_counter() - t0
        e1 = energy_f64(sim.state, cfg.eps2)
        drift = abs(e1 - e0) / abs(e0)
        rate = n * n * steps / wall / 1e9
        print(f"{integrator:>10}: |dE/E| = {drift:.3e} over {steps} steps "
              f"({wall:.1f} s, {rate:.1f} GInter/s, "
              f"resident={sim._resident})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
