"""The JAX package's closed-form gate errors, the figures that
``chip_smoke.py`` holds the port's kernels to on the card.

    PYTHONPATH=. python tests/kepler_jax_figures.py [--workers 6] > figures.txt

runs ``nbody_tpu.models.kepler``'s five gates on the CPU (the Pallas impls
in interpret mode) in float32 and prints ``JAX_KEPLER``, the literal that
``chip_smoke.py`` keeps: for each placement (``"pair"``: the two bodies
alone, N = 2; ``"split"``: body 1 at index 256 behind 255 massless bodies
at (0, 0, 50), ``block_i = block_u = 256``), impl and steps a period S, and
for each gate, the errors at S + k for k in ``NOISE_OFFSETS`` (the
tolerances are the gates' own, ``gate_cases`` at S + k).  Many of the
gates' float32 errors are mostly rounding noise (their float64 errors are
far smaller), and the spread over those nearby step counts measures it.
The float64 figures of ``xla_nxn`` are the one sample at S.  Takes about
40 minutes on 8 cores.

``tests/test_torch_kepler.py`` imports ``jax_gates`` for its comparisons
with the port's CPU twins.
"""

from __future__ import annotations

import argparse
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Steps a period around S whose errors bound the float32 noise at S.
NOISE_OFFSETS = (-16, -8, 0, 8, 16)
SPLIT_AT = 256
PAIR_IMPLS = ("pallas", "pallas_kahan", "pallas_fast", "pallas_turbo",
              "pallas_mxu", "pallas_sym2", "pallas_sym", "pallas_sym_turbo",
              "pallas_sym_mxu", "pallas_sym_turbo2")
SPLIT_IMPLS = ("pallas_sym2", "pallas_sym", "pallas_sym_turbo",
               "pallas_sym_mxu", "pallas_sym_turbo2")
STEPS = (1024, 2048)


def _split(state, at=SPLIT_AT):
    """The JAX two-body state with body 1 at index ``at`` and ``at - 1``
    massless bodies at rest at (0, 0, 50) between the two."""
    from nbody_tpu.models.state import SimState
    pos, vel, acc, mass = (np.asarray(x) for x in state)
    fill = np.broadcast_to(np.asarray([0.0, 0.0, 50.0], pos.dtype),
                           (at - 1, 3))
    zeros = np.zeros((at - 1, 3), pos.dtype)
    return SimState(
        pos=jax.numpy.asarray(np.concatenate([pos[:1], fill, pos[1:]])),
        vel=jax.numpy.asarray(np.concatenate([vel[:1], zeros, vel[1:]])),
        acc=jax.numpy.asarray(np.concatenate([acc[:1], zeros, acc[1:]])),
        mass=jax.numpy.asarray(np.concatenate(
            [mass[:1], np.zeros(at - 1, mass.dtype), mass[1:]])))


def jax_gates(impl: str, dtype: str, steps_per_period: int,
              split: bool = False, block: "int | None" = None
              ) -> "list[tuple[float, float]]":
    """(max_rel_err, tol) of the JAX package's five gates, in order, with
    64-bit mode on for float64.  With ``split`` the two bodies run split
    by ``_split`` at block_i = block_u = 256 and the error is taken on
    bodies 0 and 256; ``block`` sets block_i = block_u of the N = 2 run."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        return _jax_gates(impl, dtype, steps_per_period, split, block)
    finally:
        jax.config.update("jax_enable_x64", old)


def _jax_gates(impl, dtype, steps_per_period, split, block):
    from nbody_tpu.models import kepler
    if not split:
        return [(r["max_rel_err"], r["tol"]) for r in
                kepler.run_analytic_gates(impl, dtype, steps_per_period,
                                          block_i=block, block_u=block)]
    from nbody_tpu.config import SimConfig
    from nbody_tpu.ops.step import prime_kdk, run_steps
    spp, out = steps_per_period, []
    noise = 5e-5 if dtype == "float32" else 1e-12
    cases = []
    for integ, order, c in (("reference", 1, 0.25), ("kdk", 2, 8.0),
                            ("yoshida4", 4, 32.0)):
        st, w = kepler.two_body_circular(1.0, 1.0, 0.5, 0.01, integ, dtype)
        period = 2.0 * math.pi / w
        cases.append((integ, st, period, 0.01,
                      kepler.circular_positions(period, 1.0, 1.0, 0.5, 0.01,
                                                integ),
                      c * (w * period / spp) ** order + noise))
    for integ, order, c in (("kdk", 2, 600.0), ("yoshida4", 4, 1e4)):
        st, period = kepler.two_body_elliptic(1.0, 0.6, 1.0, 0.5, dtype)
        cases.append((integ, st, period, 1e-10,
                      kepler.elliptic_positions(period, 1.0, 0.6, 1.0, 0.5),
                      c * (2.0 * math.pi / spp) ** order + noise))
    for integ, st, period, eps2, ref, tol in cases:
        cfg = SimConfig(n_bodies=SPLIT_AT + 1, dt=period / spp, eps2=eps2,
                        impl=impl, dtype=dtype, integrator=integ,
                        block_i=SPLIT_AT, block_u=SPLIT_AT)
        st = _split(st)
        if integ != "reference":
            st = prime_kdk(st, cfg)
        pos = np.asarray(run_steps(st, cfg, spp).pos)[[0, SPLIT_AT]]
        out.append((kepler.max_rel_error(pos, ref, 1.0), tol))
    return out


def _cell(args):
    place, impl, dtype, spp, k = args
    return args, jax_gates(impl, dtype, spp + k, split=place == "split")


def format_table(table: dict) -> str:
    """``JAX_KEPLER`` and ``JAX_KEPLER_SAME`` as Python source: for each
    (placement, impl, S), five gates of errors at S + k (``NOISE_OFFSETS``;
    only S for float64), 6 significant digits.  A cell equal to one
    printed before it is printed as an alias in ``JAX_KEPLER_SAME``."""
    cells, same = {}, {}
    for key in sorted(table, key=lambda k: (k[0] == "split", k)):
        errs = tuple(tuple(float(f"{table[key][k][g][0]:.6g}")
                           for k in sorted(table[key])) for g in range(5))
        match = next((k for k, v in cells.items() if v == errs), None)
        if match is None:
            cells[key] = errs
        else:
            same[key] = match
    lines = ["JAX_KEPLER = {"]
    for key, errs in cells.items():
        lines.append(f"    {key!r}: (")
        lines += ["        (" + ", ".join(f"{e:.6g}" for e in g)
                  + ("," if len(g) == 1 else "") + "),"
                  for g in errs]
        lines.append("    ),")
    lines += ["}", "JAX_KEPLER_SAME = {"]
    lines += [f"    {k!r}: {v!r}," for k, v in same.items()]
    lines.append("}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args(argv)
    jobs = [("pair", "xla_nxn", "float64", s, 0) for s in STEPS]
    jobs += [(place, impl, "float32", s, k)
             for place, impls in (("pair", PAIR_IMPLS),
                                  ("split", SPLIT_IMPLS))
             for impl in impls for s in STEPS for k in NOISE_OFFSETS]
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    table = {}
    with ctx.Pool(args.workers) as pool:
        for (place, impl, dtype, spp, k), res in pool.imap_unordered(
                _cell, jobs):
            key = (place, impl if dtype == "float32" else "xla_nxn/float64",
                   spp)
            table.setdefault(key, {})[k] = res
    print(format_table(table))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
