#!/usr/bin/env python3
"""Count K14b's and K2-rect turbof's components outside their twin's
tolerance, over many seeds.

    python3 tools/turbof_twin_outliers.py [--seeds S]

For each body set (``chip_smoke.bodies``: N = 8192 on seeds 1 .. S and on
``chip_smoke.py``'s own seeds, 8205 and 41, and N = 2500 on 2513; K2-rect
at 2048 x 2048 on seeds (s, S + s) and on ``chip_smoke.py``'s (2069,
2070), (41, 42), and at 2144 x 1536 on (2165, 1558)), runs K14b
(``forces_sym_turbof``) and K2-rect turbof against their twin (the
trimmed geometry, ``pair_inv_fma``).  Every component outside
``chip_smoke``'s twin tolerance (TC_REL_TOL + TC_ABS_FLOOR of the largest |a|) is printed with
the kernel's value, the twin's, turbof's own sums in float64
(``chip_smoke.turbof_rows_float64``: the same bf16 weights, the products
and the per-tile correction in float64) and a float64 direct sum, and
whether the kernel is the closer of the two to turbof's own sums and
whether it passes ``chip_smoke.twin_outliers``' test at
TURBOF_CORR_UNITS.  The last lines sum it up for each form:
components checked, components outside, the most in one output and in
one body set, how many of them the kernel is the closer on and how many
pass.  These counts set ``chip_smoke.py``'s TURBOF_TWIN_MAX_BAD and
TURBOF_CORR_UNITS.

Needs a CUDA card and nvcc.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=32)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("turbof_twin_outliers: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_sym_tc as ktc
    from nbody_tpu_torch.ops.forces_tiled_tc import pair_inv_fma
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    lib = ktc._lib()
    dev = torch.device("cuda")
    eps2 = 0.002
    budget = k2.SLOT_BUDGET_BYTES

    def tiles(xi, mi, xj, mj):
        return ktc._pair_tiles(xi, mi, xj, mj, eps2, "turbof", trimmed=True)

    def square(pos, mass):
        got = k2.sweep("forces_sym_turbof", pos, mass, eps2, budget,
                       lib.nbt_sym_turbof_pairs,
                       lib.nbt_sym_tc_descale_reduce)
        pt, mt, raw = k2.sweep_plain(pos, mass, budget, tiles)
        return [(got, k2.descale_plain(pt, mt, raw, pos, mass, eps2),
                 (pos, mass, pos, mass))]

    def rect(pa, ma, pb, mb):
        got = k2.rect_sweep("rect_forces_sym_turbof", pa, ma, pb, mb, eps2,
                            budget, lib.nbt_rect_turbof_pairs,
                            lib.nbt_rect_tc_reduce, True)
        raw_a, raw_b = k2.rect_sweep_plain(pa, ma, pb, mb, budget, tiles)
        return [(got[0], k2.rect_descale_plain(raw_a, pa, ma, pb, mb, eps2),
                 (pa, ma, pb, mb)),
                (got[1], k2.rect_descale_plain(raw_b, pb, mb, pa, ma, eps2),
                 (pb, mb, pa, ma))]

    s = args.seeds
    cases = ([("K14b", (8192, seed)) for seed in range(1, s + 1)]
             + [("K14b", (8192, 8205)), ("K14b", (8192, 41)),
                ("K14b", (2500, 2513))]
             + [("K2-rect", (2048, seed, 2048, s + seed))
                for seed in range(1, s + 1)]
             + [("K2-rect", (2048, 2069, 2048, 2070)),
                ("K2-rect", (2048, 41, 2048, 42)),
                ("K2-rect", (2144, 2165, 1536, 1558))])
    tally = {}
    for form, shape in cases:
        if form == "K14b":
            n, seed = shape
            sets = cs.bodies(n, seed, dev)
            what = f"K14b N={n} seed {seed}"
        else:
            na, sa, nb, sb = shape
            sets = (*cs.bodies(na, sa, dev), *cs.bodies(nb, sb, dev))
            what = f"K2-rect {na}x{nb} seeds ({sa}, {sb})"
        outs = square(*sets) if form == "K14b" else rect(*sets)
        t = tally.setdefault(form, [0] * 6)
        in_set = 0
        for side, (got, want, (pi, mi, pj, mj)) in zip("ab", outs):
            floor = cs.TC_ABS_FLOOR * float(want.abs().max())
            bad = ((got - want).abs()
                   > cs.TC_REL_TOL * want.abs() + floor).nonzero()
            t[0] += got.numel()
            t[1] += len(bad)
            in_set += len(bad)
            t[2] = max(t[2], in_set)
            t[4] = max(t[4], len(bad))
            if not len(bad):
                continue
            rows = sorted({int(r) for r in bad[:, 0]})
            own, corr = cs.turbof_rows_float64(
                pi[rows], mi[rows], pj, mj, eps2,
                rows if form == "K14b" else None, pair_inv_fma)
            f = rect_forces(pi[rows].double(), pj.double(), mj.double(),
                            eps2)
            for r, k in bad.tolist():
                i = rows.index(r)
                g, w, v = float(got[r, k]), float(want[r, k]), float(
                    own[i, k])
                closer = abs(g - v) <= abs(w - v)
                gate = closer or abs(g - v) <= (
                    cs.TC_REL_TOL * abs(v) + floor + cs.TURBOF_CORR_UNITS
                    * 2.0 ** -23 * float(corr[i, k]))
                t[3] += closer
                t[5] += gate
                print(f"[outlier] {what}"
                      f"{'' if form == 'K14b' else ' acc_' + side}: "
                      f"component ({r},{k}) kernel {g:.6f}, twin "
                      f"{w:.6f}, turbof's own sums in float64 {v:.6f} "
                      f"(kernel off by {abs(g - v):.3e}, twin by "
                      f"{abs(w - v):.3e}; correction term "
                      f"{float(corr[i, k]):.4e}), float64 direct sum "
                      f"{float(f[i, k]):.6f} (kernel off by "
                      f"{abs(g - float(f[i, k])):.3e}, twin by "
                      f"{abs(w - float(f[i, k])):.3e}; row |a| "
                      f"{float(f[i].norm()):.3f}); the kernel the "
                      f"closer to its own sums: {closer}; passes "
                      f"twin_outliers: {gate}")
        del outs
    for form, (comps, out, most, closer, most_out, gate) in tally.items():
        print(f"[summary] {form}: {out} of {comps} components "
              f"outside the twin tolerance ({out / comps:.3e}), at most "
              f"{most_out} in one output and {most} in one body set; the "
              f"kernel the closer to turbof's own float64 sums on {closer} "
              f"of them, {gate} pass twin_outliers at TURBOF_CORR_UNITS "
              f"{cs.TURBOF_CORR_UNITS}")
    print(f"[summary] {nvidia_smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
