"""Command-line interface: ``python -m nbody_tpu_torch VERB`` with the
verbs ``run``, ``validate``, ``bench``, ``info``, ``interactive``,
``render`` and ``analyze``.

The flags and defaults are those of ``nbody_tpu/cli.py``, so one command
line drives both packages, plus ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch versions).  Every ``--impl`` runs on the port's
kernels.  ``--shards P`` (``run``, ``validate``, ``bench``) shards the
bodies over a mesh of P shards, shard i on card ``i % device_count``
(one card's shards share it; ``--device cpu`` puts them on the CPU), and
sweeps them with ``--comm ring`` (the Newton's-third-law ring for the
``pallas_sym*`` impls), ``allgather``, or ``rdma`` / ``rdma_overlap`` (the
fused ring K13, one launch a force evaluation over every shard of one
card).  ``validate --oracle native`` runs the C++/OpenMP oracle
(``oracle/native.py``), and the long-horizon phase prefers it unless
``--oracle numpy`` is given.  ``validate --analytic`` runs the closed-form
two-body gates (``models/kepler.py``) through the chosen impl instead.
``--init`` takes the presets of ``models/init.py`` for ``run`` and
``validate``; ``bench`` times the uniform box, as the JAX package's does.
``run --viz`` (PNG frames), ``--viz-avi`` (a video) and ``--viz-serve``
(the live HTTP viewer) render frames on the card inside the run
(``models/simulation.py``); ``render`` rasterizes a saved trajectory or
checkpoint on ``--device``, ``analyze`` prints a trajectory's series
(``analysis.analyze_trajectory``), and ``interactive`` is the reference's
stdin dialog.  ``run --profile DIR`` writes a ``torch.profiler`` trace
(``DIR/trace.json``).  ``--prog-cap`` and ``--flat-state`` route huge N as
the JAX package does (``Simulation``): bounded force evaluations with a
heartbeat line, the flat ``(3N,)`` state, and ``run --save-trajectory``
streamed snapshot by snapshot through ``Simulation._run_chunk``.
``NBODY_COMPCACHE`` sets where the kernels are built
(``utils/compcache.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np


class _TrackedStore(argparse.Action):
    """``store`` that also records which options were passed explicitly
    (``namespace._explicit``), so ``--resume`` merges only those onto the
    checkpoint's config."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, values)
        if not hasattr(namespace, "_explicit"):
            namespace._explicit = set()
        namespace._explicit.add(self.dest)


# CLI sim flags -> SimConfig fields (used for resume merging).
_ARG_TO_CFG = {
    "n": "n_bodies", "steps": "steps", "dt": "dt", "eps2": "eps2",
    "impl": "impl", "integrator": "integrator", "seed": "seed",
    "max_pos": "max_pos", "min_mass": "min_mass", "max_mass": "max_mass",
    "block_i": "block_i", "block_j": "block_j", "block_u": "block_u",
    "chunk": "chunk", "dtype": "dtype", "prog_cap": "prog_cap",
    "flat_state": "flat_state", "panel_nb": "panel_nb",
    "resident": "resident",
}


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
                   help="force backend: auto, xla, xla_nxn, "
                        "pallas (K1), pallas_sym2 (K2), pallas_sym (K7), "
                        "pallas_kahan (K11), pallas_fast (K12; with "
                        "--sort-every), pallas_turbo (K9), pallas_mxu "
                        "(K10), pallas_sym_turbo (K5), pallas_sym_mxu (K6), "
                        "pallas_sym_turbo2 (K14a)")
    p.add_argument("--integrator", default="reference", action=_TrackedStore,
                   choices=["reference", "kdk", "yoshida4"])
    p.add_argument("--seed", type=int, default=0, action=_TrackedStore)
    p.add_argument("--init", default="uniform",
                   choices=["uniform", "plummer", "plummer-virial", "disk",
                            "collision"],
                   help="initial conditions: the reference's uniform box "
                        "or a preset (run, validate; bench times the "
                        "uniform box)")
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
                   action=_TrackedStore,
                   help="interactions a program of the bounded dispatch "
                        "(pallas_sym* impls; a heartbeat line every tenth "
                        "of an evaluation of 6+ programs); auto-engages "
                        "past 1.2e13 interactions an evaluation")
    p.add_argument("--flat-state", default=None, action=_TrackedStore,
                   type=_parse_flat_state,
                   choices=[None, True, False], metavar="{auto,on,off}",
                   help="flat (3N,) state, a view of the (N, 3) one; auto "
                        "engages above 16,777,216 bodies for pallas_sym* "
                        "impls, as in the JAX package")
    p.add_argument("--resident", default=None, action=_TrackedStore,
                   type=_parse_flat_state,
                   choices=[None, True, False], metavar="{auto,on,off}",
                   help="resident multi-step kernels K3/K4 (whole chunks "
                        "in one cooperative launch); auto engages for "
                        "pallas_sym2 and pallas_sym inside the window "
                        "measured on the card (ops/resident.py)")
    p.add_argument("--shards", type=int, default=0,
                   help="shard bodies over this many shards, shard i on "
                        "card i %% device_count (0 = single device)")
    p.add_argument("--comm", default="ring",
                   choices=["ring", "allgather", "rdma", "rdma_overlap"],
                   help="sharded sweep: the ring (N3L for pallas_sym* "
                        "impls), the all-gather, or the fused ring K13 "
                        "(rdma, rdma_overlap: the pallas_sym* ladder and "
                        "pallas / pallas_turbo; auto is pallas_sym2)")
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
        shards=args.shards or None, dtype=args.dtype, device=args.device,
        viz=getattr(args, "viz", False),
        viz_every=getattr(args, "viz_every", 1) or 1)


def _refuse_unported(args) -> Optional[str]:
    if args.shards and getattr(args, "analytic", False):
        return ("--analytic gates are two-body closed-form checks and run "
                "single-device; drop --shards")
    return None


def _make_mesh(args):
    """The mesh of ``--shards`` on ``--device``, or None."""
    if not args.shards:
        return None
    from .parallel.mesh import make_mesh
    return make_mesh(args.shards, args.device)


def _make_sim(args, cfg, logger):
    from .models.init import INIT_MAKERS
    from .models.simulation import Simulation
    mesh = _make_mesh(args)
    if args.resume:
        explicit = getattr(args, "_explicit", set())
        overrides = {field: getattr(args, arg)
                     for arg, field in _ARG_TO_CFG.items() if arg in explicit}
        return Simulation.resume(args.resume, logger=logger,
                                 overrides=overrides, device=args.device,
                                 mesh=mesh, comm=args.comm)
    # The uniform box is left to Simulation (state=None), as in JAX.
    maker = INIT_MAKERS.get(args.init)
    return Simulation(cfg, state=maker(cfg) if maker is not None else None,
                      logger=logger, mesh=mesh, comm=args.comm)


def _save_trajectory(args, sim, logger) -> int:
    """``--save-trajectory``: snapshots every ``--snap-every`` steps, in
    the file layout the JAX package's ``run`` writes on the same route.
    One device below the program cap: stepped per step with the run's
    impl (``run_trajectory``, never the resident kernels, as in JAX), then
    one ``snapshots`` array.  A mesh, a flat or bounded run, or a whole
    run past the cap: stepped through ``Simulation._run_chunk`` (with the
    heartbeat of a bounded run), the snapshots streamed to ``snap_*``
    entries one at a time (``TrajectoryWriter``).  Both packages' loaders
    read both layouts; the fork keeps each file in the layout JAX writes
    for the same command line."""
    from .io.checkpoint import TrajectoryWriter, save_trajectory
    from .ops.forces_sym_variants import DEFAULT_PROG_CAP
    from .ops.step import run_trajectory
    snap_every = max(1, args.snap_every)
    cfg = sim.cfg
    if (sim.mesh is not None or sim._use_multiprog
            or float(args.steps) * cfg.interactions_per_step
            > (cfg.prog_cap or DEFAULT_PROG_CAP)):
        if sim._use_multiprog and not args.quiet:
            from .models.simulation import _ProgressHeartbeat
            sim.progress = _ProgressHeartbeat(logger)
        with TrajectoryWriter(args.save_trajectory, snap_every, cfg,
                              mass=sim.state.mass) as tw:
            for _ in range(args.steps // snap_every):
                sim._run_chunk(snap_every)
                tw.append(sim.state.pos,
                          vel=sim.state.vel if args.traj_vel else None)
            rem = args.steps % snap_every
            if rem:
                sim._run_chunk(rem)
            return tw.n_snaps
    out = run_trajectory(sim.state, sim.cfg, args.steps,
                         snap_every=snap_every, impl=sim.impl,
                         with_vel=args.traj_vel)
    save_trajectory(args.save_trajectory, out[1], snap_every, sim.cfg,
                    mass=out[0].mass,
                    vel_snapshots=out[2] if args.traj_vel else None)
    return out[1].shape[0]


def _frame_streamer(args, cfg):
    """The frame sinks of ``run`` (PNG files, a video, the live viewer),
    one streamer or a tee of several; None without one."""
    sinks = []
    if args.viz:
        from .viz.stream import FrameStreamer
        sinks.append(FrameStreamer(args.viz_dir))
    if args.viz_avi:
        from .viz.video import video_streamer
        sinks.append(video_streamer(args.viz_avi, cfg.viz_width,
                                    cfg.viz_height, fps=args.viz_fps))
    if args.viz_serve is not None:
        from .viz.server import LiveViewer
        viewer = LiveViewer(port=args.viz_serve)
        print(f"live view: http://127.0.0.1:{viewer.port}/ "
              f"(PNG multipart stream at /stream)")
        sinks.append(viewer)
    if len(sinks) > 1:
        from .viz.stream import TeeStreamer
        return TeeStreamer(*sinks)
    return sinks[0] if sinks else None


def cmd_run(args) -> int:
    """Simulate: the reference's main flow, headless or with frames."""
    from .io.logger import RunLogger
    msg = _refuse_unported(args)
    if msg:
        print(msg, file=sys.stderr)
        return 2
    logger = RunLogger(jsonl_path=args.log_jsonl, csv_path=args.log_csv,
                       quiet=args.quiet)
    streamer = None
    try:
        sim = _make_sim(args, None if args.resume else _make_cfg(args),
                        logger)
        if args.save_trajectory:
            n_snaps = _save_trajectory(args, sim, logger)
            if not args.quiet:
                print(f"saved {n_snaps} snapshots -> {args.save_trajectory}")
            return 0
        prof = None
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if sim.state.pos.is_cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        streamer = _frame_streamer(args, sim.cfg)
        try:
            result = sim.run(
                n_steps=args.steps, log_every=args.log_every,
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                frame_streamer=streamer,
                track_energy=args.energy, sort_every=args.sort_every)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(args.profile, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(args.profile, "trace.json"))
    finally:
        if streamer is not None:
            streamer.close()
        logger.close()
    if not args.quiet:
        g = result.ginter_per_s
        print(f"Simulation complete: {result.steps_run} steps, "
              f"{result.ms_per_step:.3f} ms/step, "
              f"{g:{'.1f' if g >= 10 else '.3g'}} GInter/s"
              + (f", energy drift {result.energy_drift:.3e}"
                 if result.energy_drift is not None else ""))
        if streamer is not None and args.viz:
            print(f"{streamer.frames_written} frames -> {args.viz_dir}")
        elif streamer is not None:
            print(f"{streamer.frames_written} frames served")
    return 0


def _oracle_run(which: str):
    """The oracle run function of ``which`` (numpy or native)."""
    if which == "native":
        from .oracle.native import native_run
        return native_run
    from .oracle.numpy_oracle import oracle_run
    return oracle_run


def _validate_analytic(args) -> int:
    """``validate --analytic``: the five closed-form two-body gates of
    ``models/kepler.py`` through ``--impl``, one period each at
    ``--steps`` steps a period (2048 when ``--steps`` is 20 or fewer, as
    validate's default of 10 is)."""
    from .models.kepler import run_analytic_gates
    results = run_analytic_gates(
        impl=args.impl, dtype=args.dtype,
        steps_per_period=args.steps if args.steps > 20 else 2048,
        block_i=args.block_i, block_u=args.block_u, device=args.device)
    ok = True
    for r in results:
        ok = ok and r["ok"]
        print(f"[{'OK ' if r['ok'] else 'FAIL'}] {r['gate']}: max rel pos "
              f"err {r['max_rel_err']:.3e} after {r['steps']} steps "
              f"(1 period; tol {r['tol']:.3e})")
    print("Analytic verification " + ("PASSED" if ok else "FAILED"))
    return 0 if ok else 1


def cmd_validate(args) -> int:
    """Lock-step differential test against a float64 oracle (numpy, or the
    C++/OpenMP one with ``--oracle native``), the gates of ``nbody
    validate``: a strict short horizon (0 bad pos/vel components, a 5e-4
    allowance for acc), then, with ``--long-steps``, energy vs the oracle
    where the oracle conserves it and the exactly-conserved momentum and
    angular momentum of the device run.  The native oracle twins the
    reference and kdk schemes only: yoshida4, or a library that cannot be
    built, takes numpy with a message; the long phase prefers native
    unless ``--oracle numpy`` was given explicitly.  ``--analytic`` runs
    the closed-form gates instead (one device: ``--shards`` is refused)."""
    from .analysis import invariant_drifts
    from .models.energy import energy_f64
    from .models.init import INIT_MAKERS, init_state
    from .models.state import SimState, state_to_numpy
    from .ops.forces import resolve_impl
    from .ops.step import prime_kdk, run_steps
    from .oracle import native
    from .oracle.numpy_oracle import relative_mismatch
    msg = _refuse_unported(args)
    if msg:
        print(msg, file=sys.stderr)
        return 2
    if args.analytic:
        return _validate_analytic(args)
    cfg = _make_cfg(args)
    mesh = _make_mesh(args)
    impl = resolve_impl(cfg, sharded=mesh is not None)
    if mesh is not None:
        # Every device-side phase through the sharded path a --shards run
        # takes.
        from .parallel.ring import (_resolve_local_impl, prime_kdk_sharded,
                                    run_steps_sharded)
        impl = _resolve_local_impl(None if args.impl == "auto" else impl,
                                   mesh, args.comm)
        print(f"[INFO] {mesh.describe()}, comm={args.comm}")

        def dev_run(st, ns):
            return run_steps_sharded(st, cfg, mesh, ns, impl=impl,
                                     comm=args.comm)

        def prime(st):
            return prime_kdk_sharded(st, cfg, mesh, impl=impl,
                                     comm=args.comm)
    else:
        def dev_run(st, ns):
            return run_steps(st, cfg, ns, impl=impl)

        def prime(st):
            return prime_kdk(st, cfg, impl=impl)
    print(f"[INFO] impl={impl} device={cfg.device} n={cfg.n_bodies}")
    state = INIT_MAKERS.get(args.init, init_state)(cfg)
    if cfg.integrator != "reference":
        state = prime(state)
    host0 = state_to_numpy(state)
    pos0, vel0, mass = host0["pos"], host0["vel"], host0["mass"]

    dev = state_to_numpy(dev_run(state, args.steps))
    dtype = np.float32 if args.oracle_f32 else np.float64
    oracle = args.oracle
    if oracle == "native" and cfg.integrator == "yoshida4":
        print("native oracle has no yoshida4 twin; falling back to numpy")
        oracle = "numpy"
    if oracle == "native" and not native.available():
        print("native oracle unavailable (needs g++); "
              "falling back to numpy")
        oracle = "numpy"
    opos, ovel, oacc = _oracle_run(oracle)(
        pos0, vel0, mass, cfg.eps2, cfg.dt, args.steps, dtype=dtype,
        integrator=cfg.integrator)
    print(f"[INFO] {args.steps}-step lock-step phase vs {oracle} "
          f"{np.dtype(dtype).name} oracle")
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
    p_drift, l_drift = invariant_drifts(dev["pos"], dev["vel"], mass, pos0,
                                        vel0)
    print(f"[INFO] momentum drift: |P-P0|_max/scale = {p_drift:.3e}")
    print(f"[INFO] angular momentum drift: |L-L0|_max/scale = "
          f"{l_drift:.3e}")
    if args.long_steps > 0:
        ls = args.long_steps
        dev_l = dev_run(state, ls)
        explicit_numpy = (args.oracle == "numpy"
                          and "oracle" in getattr(args, "_explicit", set()))
        lsrc = ("native" if cfg.integrator != "yoshida4"
                and not explicit_numpy and native.available() else "numpy")
        lpos, lvel, lacc = _oracle_run(lsrc)(
            pos0, vel0, mass, cfg.eps2, cfg.dt, ls, dtype=np.float64,
            integrator=cfg.integrator)
        e0 = energy_f64(state, cfg.eps2)
        e_dev = energy_f64(dev_l, cfg.eps2)
        e_ora = energy_f64(
            SimState(pos=lpos, vel=lvel, acc=lacc, mass=mass), cfg.eps2)
        chaos = abs(e_ora - e0) / (abs(e0) or 1.0)
        drift = abs(e_dev - e_ora) / (abs(e_ora) or 1.0)
        well_posed = chaos <= args.energy_gate
        print(f"[long] {ls}-step horizon vs {lsrc} f64 oracle: oracle "
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
                                            mass, pos0, vel0)
        for name, sym, value in (("momentum", "P", p_drift),
                                 ("angular momentum", "L", l_drift)):
            status = "OK " if value <= args.invariant_gate else "FAIL"
            if value > args.invariant_gate:
                ok = False
            print(f"[{status}] {name}: |{sym}-{sym}0|_max/scale = "
                  f"{value:.3e} after {ls} steps (exactly conserved; gate "
                  f"{args.invariant_gate:.1e})")
    print("Verification " + ("PASSED" if ok else "FAILED")
          + f" after {args.steps} lock-step steps vs {oracle} "
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
    _make_cfg(args)   # checks the options as SimConfig does
    if args.init != "uniform":
        print(f"bench times the uniform box; --init {args.init} is not "
              f"used", file=sys.stderr)
    explicit = getattr(args, "_explicit", set())
    result = run_benchmark(
        n=args.n, steps=args.steps if "steps" in explicit else None,
        impl=args.impl, block_i=args.block_i, block_j=args.block_j,
        chunk=args.chunk, block_u=args.block_u, energy=args.energy,
        warmup_steps=args.warmup, trials=args.trials, seed=args.seed,
        resident=args.resident, device=args.device,
        shards=args.shards or None, comm=args.comm, prog_cap=args.prog_cap,
        flat_state=args.flat_state)
    print(json.dumps(result))
    return 0


def cmd_info(args) -> int:
    from .utils.device import print_device_info
    print_device_info()
    return 0


def cmd_interactive(args) -> int:
    """The reference's interactive console (``main.cpp:163-228``): kernel
    type (0 = tiled all-pairs, 1 = interaction-parallel), visualization
    y/n and the step count, each asked again until valid.  On the card
    kernel 0 runs ``pallas`` (K1) and kernel 1 ``pallas_mxu`` (K10); with
    ``--device cpu`` they are ``xla`` and ``xla_nxn``.  As in the JAX
    package, visualization is asked independently of the kernel (the
    reference forces it on for the reduction kernel, ``main.cpp:319-322``,
    which exists only in its render loop)."""
    import torch

    def ask(prompt, parse, what):
        while True:
            try:
                return parse(input(prompt))
            except (ValueError, KeyError):
                print(f"Please insert a valid {what}")

    kernel = ask(
        "Select the kernel to launch "
        "(0: tiled all-pairs, 1: interaction-parallel): ",
        lambda s: {"0": 0, "1": 1}[s.strip()], "kernel type (0 or 1)")
    viz = ask("Enable visualization? (y/n): ",
              lambda s: {"y": True, "n": False}[s.strip().lower()],
              "choice (y or n)")
    steps = ask("Insert the number of steps to simulate: ",
                lambda s: int(s), "integer")

    on_card = torch.device(args.device).type == "cuda"
    if kernel == 0:
        impl = "pallas" if on_card else "xla"
    else:
        # The reduction family's counterpart: the interaction-parallel path.
        impl = "pallas_mxu" if on_card else "xla_nxn"

    run_args = ["run", "--n", str(args.n), "--steps", str(steps),
                "--impl", impl, "--device", args.device,
                "--log-every", str(max(1, min(100, steps // 5)))]
    if viz:
        run_args += ["--viz", "--viz-dir", args.viz_dir,
                     "--viz-every", str(max(1, steps // 100))]
    print(f"Starting simulation: N={args.n}, steps={steps}, impl={impl}, "
          f"visualization={'on' if viz else 'off'}")
    return main(run_args)


def _load_trajectory(path: str):
    """(snapshots (T, N, 3), mass (N,)) from a trajectory NPZ (monolithic,
    or streamed and read one snapshot at a time) or a checkpoint (one
    frame).  Masses give the mass-to-colour lerp
    (``simulation_visualization.cpp:46-56``); a trajectory without them
    renders at the minimum mass, with a warning."""
    with np.load(path) as z:
        checkpoint = ("pos" in z.files and "snapshots" not in z.files
                      and not any(f.startswith("snap_") for f in z.files))
    if checkpoint:
        import torch
        from .io.checkpoint import load_checkpoint
        state, _, _ = load_checkpoint(path, dtype=torch.float32,
                                      device="cpu")
        return state.pos.numpy()[None], state.mass.numpy()
    from .io.checkpoint import load_trajectory
    snaps, mass, _ = load_trajectory(path)
    if mass is None:
        print("warning: trajectory has no 'mass' array; rendering with "
              "uniform minimum mass (flat green)", file=sys.stderr)
        mass = np.full((snaps.shape[1],), 1e5, np.float32)
    return snaps, mass


def cmd_render(args) -> int:
    """Rasterize a saved trajectory or checkpoint: each snapshot rendered
    on ``--device``, colorized on the host, written as PNG frames and
    optionally a GIF and a video."""
    import torch
    from .config import SimConfig
    from .utils.device import require_device
    from .viz.raster import colorize, render_weights
    from .viz.stream import FrameStreamer
    dev = require_device(args.device)
    snaps, mass = _load_trajectory(args.trajectory)
    cfg = SimConfig(n_bodies=snaps.shape[1])
    mass_t = torch.as_tensor(np.asarray(mass, np.float32), device=dev)
    rendered = []
    video = None
    if args.avi:
        from .viz.video import video_writer
        video = video_writer(args.avi, args.width, args.height, fps=args.fps)
    with FrameStreamer(args.out_dir) as fs:
        for i, pos in enumerate(snaps):
            frame = colorize(render_weights(
                torch.as_tensor(np.asarray(pos, np.float32), device=dev),
                mass_t, cfg.min_mass, cfg.max_mass, args.max_view,
                args.width, args.height))
            fs.submit(i, frame)
            if video is not None:
                video.add(frame)
            if args.gif:
                rendered.append(frame)
    print(f"rendered {snaps.shape[0]} frames -> {args.out_dir}")
    if video is not None:
        video.close()
        print(f"wrote {snaps.shape[0]}-frame video -> {args.avi}")
    if args.gif:
        from .viz.gif import write_gif
        n = write_gif(args.gif, rendered, delay_cs=args.gif_delay_cs)
        print(f"wrote {n}-frame GIF -> {args.gif}")
    return 0


def cmd_analyze(args) -> int:
    """A trajectory's per-snapshot series (``analyze_trajectory``) as a
    table, or with ``--json`` as one JSON object."""
    from .analysis import analyze_trajectory
    res = analyze_trajectory(args.trajectory, n_bins=args.bins,
                             energy_max_n=args.energy_max_n)
    if args.json:
        print(json.dumps(res))
        return 0
    steps = res["steps"]
    drift = res["com_drift"]
    lr = res["lagrangian_radii"]
    fracs = res["fractions"]
    has_e = "energy" in res
    has_inv = "momentum_drift" in res
    hdr = "  ".join(f"r{int(f * 100):02d}%" for f in fracs)
    ehdr = f"  {'dE/E0':>10}  {'virial_Q':>9}" if has_e else ""
    ihdr = f"  {'dP_rel':>9}  {'dL_rel':>9}" if has_inv else ""
    print(f"== trajectory analysis: {args.trajectory} "
          f"({len(steps)} snapshots) ==")
    print(f"{'step':>8}  {'com_drift':>12}  {hdr}{ehdr}{ihdr}")
    for k in range(len(steps)):
        radii = "  ".join(f"{r:11.4g}" for r in lr[k])
        erow = (f"  {res['energy_drift'][k]:>10.3e}"
                f"  {res['virial'][k]:>9.4g}" if has_e else "")
        irow = (f"  {res['momentum_drift'][k]:>9.2e}"
                f"  {res['ang_mom_drift'][k]:>9.2e}" if has_inv else "")
        print(f"{steps[k]:>8}  {drift[k]:>12.4g}  {radii}{erow}{irow}")
    if "energy_note" in res:
        print(f"[note] {res['energy_note']}")
    g0 = np.asarray(res["g_r_first"])
    g1 = np.asarray(res["g_r_last"])
    mid = slice(len(g0) // 8, len(g0) // 2)
    print(f"pair correlation g(r), mid-range mean: "
          f"first={g0[mid].mean():.3f} last={g1[mid].mean():.3f} "
          f"(1 = uniform; >1 = clustered)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m nbody_tpu_torch",
        description="All-pairs N-body simulation on PyTorch + CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a simulation")
    _add_sim_args(runp)
    runp.add_argument("--viz", action="store_true",
                      help="stream PNG frames rendered on the card to "
                           "--viz-dir")
    runp.add_argument("--viz-dir", default="frames")
    runp.add_argument("--viz-every", type=int, default=1)
    runp.add_argument("--viz-avi", "--viz-video", default=None,
                      metavar="VIDEO",
                      help="write the frames into an MJPEG video during the "
                           "run; .mp4/.m4v -> MP4 (needs Pillow), else AVI "
                           "(raw DIB frames without Pillow)")
    runp.add_argument("--viz-fps", type=int, default=25,
                      help="playback rate of --viz-avi")
    runp.add_argument("--viz-serve", type=int, default=None, metavar="PORT",
                      help="serve a live view over HTTP on 127.0.0.1:PORT "
                           "(0 picks a free port)")
    runp.add_argument("--log-every", type=int, default=None,
                      help="progress-log cadence in steps (0 = none); "
                           "default: chunks of ~0.5 s of card work")
    runp.add_argument("--log-jsonl", default=None)
    runp.add_argument("--log-csv", default=None)
    runp.add_argument("--checkpoint", default=None)
    runp.add_argument("--checkpoint-every", type=int, default=0)
    runp.add_argument("--resume", default=None,
                      help="resume from a checkpoint file (either package's)")
    runp.add_argument("--energy", action="store_true",
                      help="report total-energy drift (float64; K8 above "
                           "262,144 bodies)")
    runp.add_argument("--profile", default=None, metavar="DIR",
                      help="write a torch.profiler trace to DIR/trace.json")
    runp.add_argument("--sort-every", type=int, default=0,
                      help="Morton-sort the bodies first and every K steps "
                           "(0 = never); pallas_fast wants sorted bodies")
    runp.add_argument("--save-trajectory", default=None, metavar="NPZ",
                      help="capture position snapshots and save")
    runp.add_argument("--snap-every", type=int, default=1)
    runp.add_argument("--traj-vel", action="store_true",
                      help="also capture velocities in --save-trajectory")
    runp.add_argument("--quiet", action="store_true")
    runp.set_defaults(fn=cmd_run)

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
                    help="numpy (vectorized) or native (C++/OpenMP, "
                         "built from native/ at first use); the long-"
                         "horizon phase prefers native unless numpy is "
                         "given explicitly")
    vp.add_argument("--oracle-f32", action="store_true")
    vp.add_argument("--analytic", action="store_true",
                    help="closed-form two-body (Kepler) gates through "
                         "--impl instead of the oracle; --steps > 20 sets "
                         "the steps a period (default 2048)")
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

    itp = sub.add_parser(
        "interactive",
        help="the reference's stdin console flow (main.cpp:163-228)")
    itp.add_argument("--n", type=int, default=8192)
    itp.add_argument("--viz-dir", default="frames")
    itp.add_argument("--device", default="cuda",
                     help="torch device: cuda (K1 / K10) or cpu (xla / "
                          "xla_nxn)")
    itp.set_defaults(fn=cmd_interactive)

    rp = sub.add_parser("render", help="rasterize saved trajectory to PNGs")
    rp.add_argument("trajectory")
    rp.add_argument("--out-dir", default="frames")
    rp.add_argument("--width", type=int, default=800)
    rp.add_argument("--height", type=int, default=600)
    rp.add_argument("--max-view", type=float, default=200_000.0)
    rp.add_argument("--gif", default=None, metavar="GIF",
                    help="also assemble the frames into an animated GIF")
    rp.add_argument("--gif-delay-cs", type=int, default=4)
    rp.add_argument("--avi", "--video", default=None, metavar="VIDEO",
                    help="also write an MJPEG video; .mp4/.m4v -> MP4 "
                         "(needs Pillow), else AVI")
    rp.add_argument("--fps", type=int, default=25,
                    help="video playback rate")
    rp.add_argument("--device", default="cuda",
                    help="torch device the frames are rendered on")
    rp.set_defaults(fn=cmd_render)

    anp = sub.add_parser(
        "analyze",
        help="structure/health diagnostics from a saved trajectory "
             "(COM drift, Lagrangian radii, pair correlation)")
    anp.add_argument("trajectory")
    anp.add_argument("--bins", type=int, default=32)
    anp.add_argument("--json", action="store_true",
                     help="emit the full series as one JSON object")
    anp.add_argument("--energy-max-n", type=int, default=16384,
                     help="skip the O(N^2) host-f64 energy/virial series "
                          "above this many bodies (needs --traj-vel "
                          "trajectories)")
    anp.set_defaults(fn=cmd_analyze)
    return ap


def main(argv: Optional["list[str]"] = None) -> int:
    args = build_parser().parse_args(argv)
    # The kernels' build root (NBODY_COMPCACHE: a directory, or off).
    from .utils.compcache import enable_compilation_cache
    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
