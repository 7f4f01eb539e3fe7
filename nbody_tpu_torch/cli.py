"""Command-line interface: ``python -m nbody_tpu_torch validate|bench|info``.

The flags and defaults are those of ``nbody_tpu/cli.py``, so one command
line drives both packages, plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch versions).  Choices that name parts not ported yet
(other impls, ``--shards``, ``--init`` presets, ``--analytic``, the native
oracle) are refused with the ROADMAP item that will bring them.  ``run``
arrives with ``Simulation``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np


class _TrackedStore(argparse.Action):
    """``store`` that also records which options were passed explicitly
    (``namespace._explicit``)."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)
        if not hasattr(namespace, "_explicit"):
            namespace._explicit = set()
        namespace._explicit.add(self.dest)


def _parse_flat_state(s: str):
    try:
        return {"auto": None, "on": True, "off": False}[s]
    except KeyError:
        raise argparse.ArgumentTypeError(
            f"expected auto, on, or off; got {s!r}") from None


def _add_sim_args(p: argparse.ArgumentParser):
    p.add_argument("--n", type=int, default=8192, action=_TrackedStore,
                   help="number of bodies (reference N_BODIES=8192)")
    p.add_argument("--steps", type=int, default=100, action=_TrackedStore)
    p.add_argument("--dt", type=float, default=0.1, action=_TrackedStore)
    p.add_argument("--eps2", type=float, default=0.002, action=_TrackedStore)
    p.add_argument("--impl", default="auto", action=_TrackedStore,
                   choices=["auto", "xla", "xla_nxn", "pallas",
                            "pallas_kahan", "pallas_mxu", "pallas_fast",
                            "pallas_turbo", "pallas_sym", "pallas_sym2",
                            "pallas_sym_turbo", "pallas_sym_turbo2",
                            "pallas_sym_mxu"],
                   help="force backend; ported: auto, xla, xla_nxn, "
                        "pallas (K1), pallas_sym2 (K2)")
    p.add_argument("--integrator", default="reference", action=_TrackedStore,
                   choices=["reference", "kdk", "yoshida4"])
    p.add_argument("--seed", type=int, default=0, action=_TrackedStore)
    p.add_argument("--init", default="uniform",
                   choices=["uniform", "plummer", "plummer-virial", "disk",
                            "collision"],
                   help="initial conditions (only the uniform box is "
                        "ported)")
    p.add_argument("--max-pos", type=float, default=100_000.0,
                   action=_TrackedStore)
    p.add_argument("--min-mass", type=float, default=100_000.0,
                   action=_TrackedStore)
    p.add_argument("--max-mass", type=float, default=1_000_000_000.0,
                   action=_TrackedStore)
    p.add_argument("--dtype", default="float32", action=_TrackedStore,
                   choices=["float32", "float64", "bfloat16"])
    p.add_argument("--block-i", type=int, default=512, action=_TrackedStore)
    p.add_argument("--block-j", type=int, default=2048, action=_TrackedStore)
    p.add_argument("--block-u", type=int, default=None, action=_TrackedStore)
    p.add_argument("--panel-nb", type=int, default=None,
                   action=_TrackedStore)
    p.add_argument("--chunk", type=int, default=1024, action=_TrackedStore)
    p.add_argument("--prog-cap", type=float, default=None,
                   action=_TrackedStore)
    p.add_argument("--flat-state", default=None, action=_TrackedStore,
                   type=_parse_flat_state,
                   choices=[None, True, False], metavar="{auto,on,off}")
    p.add_argument("--resident", default=None, action=_TrackedStore,
                   type=_parse_flat_state,
                   choices=[None, True, False], metavar="{auto,on,off}",
                   help="resident multi-step kernel (not ported: on is "
                        "refused, auto and off run per step)")
    p.add_argument("--shards", type=int, default=0,
                   help="shard bodies over this many devices (0 = single; "
                        "multi-GPU is not ported)")
    p.add_argument("--comm", default="ring",
                   choices=["ring", "allgather", "rdma", "rdma_overlap"])
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the kernels) or cpu (the "
                        "plain PyTorch versions)")


def _make_cfg(args):
    from .config import SimConfig
    return SimConfig(
        n_bodies=args.n, steps=args.steps, dt=args.dt, eps2=args.eps2,
        impl=args.impl, integrator=args.integrator, seed=args.seed,
        max_pos=args.max_pos, min_mass=args.min_mass, max_mass=args.max_mass,
        block_i=args.block_i, block_j=args.block_j, block_u=args.block_u,
        chunk=args.chunk, panel_nb=args.panel_nb, prog_cap=args.prog_cap,
        flat_state=args.flat_state, resident=args.resident,
        shards=args.shards or None, dtype=args.dtype, device=args.device)


def _refuse_unported(args) -> Optional[str]:
    if args.init != "uniform":
        return (f"--init {args.init}: only the uniform box is ported "
                f"(presets come later, ROADMAP Queue 1 item 2)")
    if getattr(args, "analytic", False):
        return ("--analytic: the Kepler gates are not ported yet "
                "(ROADMAP Queue 1 item 9)")
    if getattr(args, "oracle", "numpy") == "native":
        return ("--oracle native: the C++/OpenMP oracle is not ported; "
                "use the numpy oracle")
    return None


def cmd_validate(args) -> int:
    """Lock-step differential test against the float64 numpy oracle, the
    gates of ``nbody validate``: a strict short horizon (0 bad pos/vel
    components, a 5e-4 allowance for acc), then, with ``--long-steps``,
    energy vs the oracle where the oracle conserves it and the
    exactly-conserved momentum and angular momentum of the device run."""
    from .analysis import invariant_drifts
    from .models.energy import energy_f64
    from .models.init import init_state
    from .models.state import SimState, state_to_numpy
    from .ops.forces import resolve_impl
    from .ops.step import prime_kdk, run_steps
    from .oracle.numpy_oracle import oracle_run, relative_mismatch
    msg = _refuse_unported(args)
    if msg:
        print(msg, file=sys.stderr)
        return 2
    cfg = _make_cfg(args)
    impl = resolve_impl(cfg)
    print(f"[INFO] impl={impl} device={cfg.device} n={cfg.n_bodies}")
    state = init_state(cfg)
    if cfg.integrator != "reference":
        state = prime_kdk(state, cfg, impl=impl)
    host0 = state_to_numpy(state)
    pos0, vel0, mass = host0["pos"], host0["vel"], host0["mass"]

    dev = state_to_numpy(run_steps(state, cfg, args.steps, impl=impl))
    dtype = np.float32 if args.oracle_f32 else np.float64
    opos, ovel, oacc = oracle_run(pos0, vel0, mass, cfg.eps2, cfg.dt,
                                  args.steps, dtype=dtype,
                                  integrator=cfg.integrator)
    ok = True
    for name, d, o, abs_tol, bad_frac in (
            ("pos", dev["pos"], opos, args.abs_tol_pos, args.max_bad_frac),
            ("vel", dev["vel"], ovel, args.abs_tol_vel, args.max_bad_frac),
            ("acc", dev["acc"], oacc, args.abs_tol_acc,
             args.max_bad_frac_acc)):
        bad = relative_mismatch(d, o, args.rel_tol, abs_tol)
        frac = float(bad.mean())
        status = "OK " if frac <= bad_frac else "FAIL"
        if frac > bad_frac:
            ok = False
        print(f"[{status}] {name}: {frac:.4%} of components outside "
              f"{args.rel_tol:.1%} relative tolerance "
              f"({int(bad.sum())}/{bad.size})")
    p_drift, l_drift = invariant_drifts(dev["pos"], dev["vel"], mass)
    print(f"[INFO] momentum drift: |P|_max/scale = {p_drift:.3e}")
    print(f"[INFO] angular momentum drift: |L|_max/scale = {l_drift:.3e}")
    if args.long_steps > 0:
        ls = args.long_steps
        dev_l = run_steps(state, cfg, ls, impl=impl)
        lpos, lvel, lacc = oracle_run(pos0, vel0, mass, cfg.eps2, cfg.dt, ls,
                                      dtype=np.float64,
                                      integrator=cfg.integrator)
        e0 = energy_f64(state, cfg.eps2)
        e_dev = energy_f64(dev_l, cfg.eps2)
        e_ora = energy_f64(
            SimState(pos=lpos, vel=lvel, acc=lacc, mass=mass), cfg.eps2)
        chaos = abs(e_ora - e0) / (abs(e0) or 1.0)
        drift = abs(e_dev - e_ora) / (abs(e_ora) or 1.0)
        well_posed = chaos <= args.energy_gate
        print(f"[long] {ls}-step horizon vs numpy f64 oracle: oracle "
              f"self-conservation |dE|/|E0| = {chaos:.3e} -> "
              + ("well-posed" if well_posed else "chaos-dominated"))
        if well_posed:
            status = "OK " if drift <= args.energy_gate else "FAIL"
            if drift > args.energy_gate:
                ok = False
            print(f"[{status}] energy: device vs oracle drift {drift:.3e} "
                  f"(gate {args.energy_gate:.1e})")
        else:
            print(f"[INFO] energy: device vs oracle drift {drift:.3e} "
                  f"(not gateable: close encounters are unresolvable at "
                  f"dt={cfg.dt:g}, eps2={cfg.eps2:g})")
        host_l = state_to_numpy(dev_l)
        p_drift, l_drift = invariant_drifts(host_l["pos"], host_l["vel"],
                                            mass)
        for name, sym, value in (("momentum", "P", p_drift),
                                 ("angular momentum", "L", l_drift)):
            status = "OK " if value <= args.invariant_gate else "FAIL"
            if value > args.invariant_gate:
                ok = False
            print(f"[{status}] {name}: |{sym}|_max/scale = "
                  f"{value:.3e} after {ls} steps (exactly conserved; gate "
                  f"{args.invariant_gate:.1e})")
    print("Verification " + ("PASSED" if ok else "FAILED")
          + f" after {args.steps} lock-step steps vs {args.oracle} "
          f"{'float32' if args.oracle_f32 else 'float64'} oracle"
          + (f" + {args.long_steps}-step long-horizon gates"
             if args.long_steps > 0 else ""))
    return 0 if ok else 1


def cmd_bench(args) -> int:
    from .bench_lib import run_benchmark
    msg = _refuse_unported(args)
    if msg:
        print(msg, file=sys.stderr)
        return 2
    _make_cfg(args)   # refuses unported impls and execution modes
    explicit = getattr(args, "_explicit", set())
    result = run_benchmark(
        n=args.n, steps=args.steps if "steps" in explicit else None,
        impl=args.impl, block_i=args.block_i, block_j=args.block_j,
        chunk=args.chunk, block_u=args.block_u, energy=args.energy,
        warmup_steps=args.warmup, trials=args.trials, seed=args.seed,
        device=args.device)
    print(json.dumps(result))
    return 0


def cmd_info(args) -> int:
    from .utils.device import print_device_info
    print_device_info()
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m nbody_tpu_torch",
        description="All-pairs N-body simulation on PyTorch + CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    vp = sub.add_parser("validate",
                        help="lock-step differential test vs CPU oracle")
    _add_sim_args(vp)
    vp.set_defaults(steps=10)
    vp.add_argument("--rel-tol", type=float, default=0.01)
    vp.add_argument("--abs-tol-pos", type=float, default=1.0)
    vp.add_argument("--abs-tol-vel", type=float, default=1e-2)
    vp.add_argument("--abs-tol-acc", type=float, default=1e-6)
    vp.add_argument("--max-bad-frac", type=float, default=0.0)
    vp.add_argument("--max-bad-frac-acc", type=float, default=5e-4)
    vp.add_argument("--oracle", default="numpy", action=_TrackedStore,
                    choices=["numpy", "native"],
                    help="numpy float64 oracle (native is not ported)")
    vp.add_argument("--oracle-f32", action="store_true")
    vp.add_argument("--analytic", action="store_true",
                    help="closed-form Kepler gates (not ported yet)")
    vp.add_argument("--long-steps", type=int, default=1000)
    vp.add_argument("--energy-gate", type=float, default=1e-3)
    vp.add_argument("--invariant-gate", type=float, default=1e-3)
    vp.set_defaults(fn=cmd_validate)

    bp = sub.add_parser("bench", help="throughput benchmark")
    _add_sim_args(bp)
    bp.add_argument("--warmup", type=int, default=None)
    bp.add_argument("--trials", type=int, default=3)
    bp.add_argument("--energy", action="store_true")
    bp.set_defaults(fn=cmd_bench)

    ip = sub.add_parser("info", help="device properties")
    ip.set_defaults(fn=cmd_info)
    return ap


def main(argv: Optional["list[str]"] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
