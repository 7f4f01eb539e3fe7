"""The high-level simulation loop: ``SimResult``, ``auto_log_every`` and
``Simulation`` of ``nbody_tpu/models/simulation.py``.

``Simulation`` owns a state and a config and runs chunks of steps with
host services between them: structured logging, checkpoints (a cadence,
or the end state), the NaN watchdog and energy accounting.  A chunk is
one launch of the resident kernel K3/K4 where ``should_use_resident``
routes there, else ``run_steps``' per-step loop.  Both give the same
steps whatever the chunking, so a log or checkpoint cadence that cuts
chunks changes no result.  ``sort_every`` Morton-sorts the state
(``models/ordering.py``) before the first chunk and then every
``sort_every`` steps, after that step's checkpoint, as the JAX package
does; the sort permutes body identity.

With ``mesh=`` (``parallel/mesh.py``) every chunk runs through
``run_steps_sharded`` over the mesh with the ``comm`` tier, and a KDK
prime through ``prime_kdk_sharded``; the state between chunks is the
gathered, unpadded state, so checkpoints and trajectories take the
single-device path.  The energy does too up to ``MAX_HOST_ENERGY_N``
bodies; past it a mesh run's energy is computed on the mesh
(``parallel/energy.py``: the halved ring of K8 row-sum programs, with the
heartbeat), as in the JAX package.  A mesh run never takes the resident
kernels, and forcing them on a mesh is refused, as in the JAX package.

With a ``frame_streamer`` (``viz/stream.py``, ``viz/server.py``,
``viz/video.py``) the run renders every ``cfg.viz_every``-th state on the
card as a packed one-byte-a-pixel map, copies each chunk's maps to pinned
host memory on a side stream while the card runs the next chunk, and
colorizes and submits them on the host (``_FrameCopy``).  The streamer's
``view_state`` (zoom, pan) and ``control_state`` (pause, stop) are read
at chunk boundaries.  Under ``auto`` in the resident window a chunk's
frames come from K3 launches of ``viz_every`` steps.

Huge N routes as in the JAX package.  ``should_use_flat`` gives a
single-device run the flat ``(3N,)`` state (``state.pos`` is ``(3N,)``,
the view of the ``(N, 3)`` tensor) and ``run_steps_flat``;
``should_use_multiprog`` gives it the bounded dispatch
(``run_steps_multiprog``), and a mesh with ``comm="ring"`` the bounded
mesh (``parallel/multiprog.py``).  Both take precedence over the resident
kernels; forcing those against them raises, as in the JAX package, and so
does flat + mesh.  A bounded run renders its frames at chunk boundaries,
and with a logger that is not quiet it prints ``_ProgressHeartbeat``'s
line while a force evaluation of six programs or more runs.  The bound
is a heartbeat granularity: the card has no program kill, so the JAX
package's cap on fused chunks and its warning are not copied.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SimConfig
from ..io.checkpoint import (load_checkpoint, load_checkpoint_meta,
                             save_checkpoint)
from ..io.logger import RunLogger
from ..ops.forces import resolve_impl
from ..ops.resident import run_steps_resident, should_use_resident
from ..ops.step import (prime_kdk, prime_kdk_flat, run_steps,
                        run_steps_flat, run_steps_multiprog,
                        run_trajectory_frames, should_use_flat,
                        should_use_multiprog)
from ..parallel import energy as penergy
from ..parallel.multiprog import run_steps_sharded_multiprog
from ..parallel.ring import (_resolve_local_impl, prime_kdk_sharded,
                             render_weights_sharded,
                             run_steps_sharded,
                             run_trajectory_frames_sharded)
from ..utils.timing import StepTimer, sync_stream
from ..viz.raster import colorize, render_weights, render_weights_flat
from .energy import energy_f64
from .init import init_state, init_state_flat
from .ordering import morton_sort_state
from .state import (SimState, flat_from_state, is_flat, state_from_flat)

# Interactions per second that ``auto_log_every`` sizes chunks at: K2 at
# N = 1,048,576 ran 2090-2096 GInter/s on an H100 80GB HBM3 at 700 W
# (PERF.md, "Where the time goes"), the port's fastest measured rate, so
# the estimate errs towards longer chunks at every N.
CARD_RATE = 2.1e12


@dataclasses.dataclass
class SimResult:
    state: SimState
    steps_run: int
    ms_per_step: float
    ginter_per_s: float
    energy_initial: Optional[float] = None
    energy_final: Optional[float] = None

    @property
    def energy_drift(self) -> Optional[float]:
        if self.energy_initial is None or self.energy_final is None:
            return None
        scale = abs(self.energy_initial) or 1.0
        return abs(self.energy_final - self.energy_initial) / scale


def auto_log_every(cfg: SimConfig, n_steps: int) -> int:
    """Default progress-log cadence (``log_every=None``).

    Every chunk boundary syncs the card (the timer and the NaN watchdog
    need real state), so a chunk is sized to >= ~0.5 s of device work at
    ``CARD_RATE``, with at most ~50 log lines a run.  A cadence that
    divides ``n_steps`` is preferred when one lies within 4x of the
    target (the JAX package's rule, where a ragged tail recompiles; here
    it keeps the chunks even)."""
    per_step_s = cfg.interactions_per_step / CARD_RATE
    target = max(1, int(0.5 / per_step_s), n_steps // 50)
    if n_steps <= target:
        return target
    above = None      # smallest divisor >= target
    below = None      # largest divisor in [target/2, target)
    d = 1
    while d * d <= n_steps:
        if n_steps % d == 0:
            for c in (d, n_steps // d):
                if c >= target:
                    if above is None or c < above:
                        above = c
                elif 2 * c >= target and (below is None or c > below):
                    below = c
        d += 1
    if above is not None and above <= 4 * target and above < n_steps:
        return above
    if below is not None:
        return below
    return target


class _ProgressHeartbeat:
    """The progress line of a bounded force evaluation, the JAX package's
    ``_ProgressHeartbeat``: the ``progress(done, total, acc)`` callback of
    the bounded dispatch.  At 16.7M bodies one evaluation is ~24 programs
    and ~100 s of kernels during which the host is otherwise silent.
    Every ``total // 10`` programs (and at the last) it waits for the
    compute stream of ``acc``'s card (of every card when ``acc`` is None,
    as the mesh energy passes it) and prints ``force eval: k/P programs
    (x%), ETA m:ss``; a program it does not print adds no wait, and an
    evaluation of fewer than ``min_programs`` programs prints nothing."""

    def __init__(self, logger, min_programs: int = 6,
                 sync_every: Optional[int] = None):
        self.logger = logger
        self.min_programs = min_programs
        self.sync_every = sync_every
        self._t0 = 0.0
        self._last_done = 0

    def __call__(self, done: int, total: int, acc) -> None:
        if total < self.min_programs:
            return
        if done <= self._last_done or self._t0 == 0.0:
            # The first program of an evaluation: its clock starts here.
            self._t0 = time.perf_counter()
        self._last_done = done
        every = self.sync_every or max(1, total // 10)
        if done % every and done != total:
            return
        # The programs so far have run.
        if acc is not None:
            sync_stream(acc.device)
        elif torch.cuda.is_initialized():
            for d in range(torch.cuda.device_count()):
                sync_stream(torch.device("cuda", d))
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        eta = elapsed / done * (total - done)
        self.logger.banner(
            f"  force eval: {done}/{total} programs "
            f"({100.0 * done / total:.0f}%), ETA {int(eta // 60)}:"
            f"{int(eta % 60):02d}")


class Route(NamedTuple):
    """Where a ``Simulation`` sends its steps."""
    impl: str           # the force impl (a shard's, on a mesh)
    flat: bool          # the flat state (one device)
    bounded: bool       # the bounded dispatch (prog_cap's programs)
    resident: bool      # the resident kernels K3 / K4


def simulation_route(cfg: SimConfig, mesh=None, comm: str = "ring") -> Route:
    """The route a ``Simulation`` of ``cfg`` (on ``mesh`` under ``comm``)
    takes; raises where the config's options refuse one another."""
    impl = resolve_impl(cfg, sharded=mesh is not None)
    if mesh is not None:
        impl = _resolve_local_impl(cfg.impl, mesh, comm, default=impl)
    if mesh is not None and cfg.flat_state:
        raise ValueError(
            "flat-state + mesh is unnecessary by design: a mesh shard "
            "is (N/P, 3), and mesh runs at any N route through the "
            "sharded bounded programs (parallel/multiprog.py); drop "
            "--flat-state (or --shards for the single-device flat mode)")
    flat = mesh is None and should_use_flat(cfg, impl)
    # The bounded dispatch: the flat mode always; else a pallas_sym* impl
    # with a prog_cap or one evaluation past the default cap (a device, or
    # a shard of a ring mesh).  A forced resident run keeps a cap that
    # does not split one step.
    forced_resident = (
        cfg.resident is True and mesh is None
        and (cfg.prog_cap is None
             or cfg.interactions_per_step <= cfg.prog_cap))
    bounded = flat or (
        (mesh is None or comm == "ring") and not forced_resident
        and should_use_multiprog(cfg, impl,
                                 mesh.size if mesh is not None else 1))
    # Raises naming the reasons when resident=True is out of scope.
    resident = (not bounded and should_use_resident(
        cfg, impl, sharded=mesh is not None))
    if cfg.resident is True and not resident:
        should_use_resident(cfg, impl, sharded=mesh is not None)
        raise ValueError(
            "resident=True but flat/multiprog routing preempts the "
            "resident kernels (whole steps in one launch); drop "
            "--resident on or the conflicting scale options")
    return Route(impl, flat, bounded, resident)


class Simulation:
    """Owns a state + config; runs chunks of steps with host-side services
    (logging / checkpoints / watchdog / energy) between chunks."""

    def __init__(self, cfg: SimConfig, state=None,
                 logger: Optional[RunLogger] = None, mesh=None,
                 comm: str = "ring"):
        self.cfg = cfg
        self.logger = logger or RunLogger(quiet=True)
        self.mesh = mesh
        self.comm = comm
        route = simulation_route(cfg, mesh, comm)
        self.impl = route.impl
        self._flat = route.flat
        self._use_multiprog = route.bounded
        self._resident = route.resident
        if state is None:
            state = init_state_flat(cfg) if self._flat else init_state(cfg)
        elif self._flat and not is_flat(state):
            state = flat_from_state(state)
        elif not self._flat and is_flat(state):
            state = state_from_flat(state)
        self.state = state
        if cfg.integrator != "reference":
            # The prime is a whole force evaluation: it gets a heartbeat.
            beat = (_ProgressHeartbeat(self.logger)
                    if self._use_multiprog and not self.logger.quiet
                    else None)
            if mesh is not None:
                self.state = prime_kdk_sharded(self.state, cfg, mesh,
                                               impl=self.impl, comm=comm,
                                               progress=beat)
            elif self._flat:
                self.state = prime_kdk_flat(self.state, cfg, impl=self.impl,
                                            progress=beat)
            else:
                # The resident kernels compute K2's sums for either impl
                # they serve (RESIDENT_IMPLS), so a resident run primes on
                # K2 too: a resume, which primes again, then repeats the
                # uninterrupted run's bits (the JAX package primes
                # ``pallas_sym`` on its own tile and differs by a rounding).
                prime_impl = "pallas_sym2" if self._resident else self.impl
                self.state = prime_kdk(self.state, cfg, impl=prime_impl,
                                       progress=beat)
        self.step_count = 0
        # The bounded dispatch's per-program callback f(done, total, acc);
        # ``run`` installs a heartbeat when it is None.
        self.progress = None

    @classmethod
    def resume(cls, path: str, cfg: Optional[SimConfig] = None,
               logger: Optional[RunLogger] = None,
               overrides: Optional[dict] = None,
               device=None, mesh=None,
               comm: str = "ring") -> "Simulation":
        """Resume from a checkpoint written by either package.

        With ``overrides`` (the CLI passes the flags the user set) the
        saved config is the base and only those fields change, so a resume
        keeps the original physics.  The device is this invocation's:
        ``device``, else ``cfg.device``, else the default ``cuda``; a
        checkpoint written on the card resumes on the CPU and the reverse.
        ``n_bodies`` always follows the stored state.  With ``mesh`` the
        run continues sharded over it.  The layout is decided from the
        metadata, as in the JAX package: a run that ``should_use_flat``
        loads the flat state; a saved ``flat_state=True`` resumed onto a
        mesh is cleared with a warning (flat is single-device), unless
        ``overrides`` asks for it, which then raises."""
        if device is None:
            device = cfg.device if cfg is not None else SimConfig.device
        step_count, saved_cfg, n_saved = load_checkpoint_meta(path)
        if saved_cfg is not None and overrides is not None:
            cfg = saved_cfg.replace(**overrides)
        else:
            cfg = cfg or saved_cfg
        if cfg is None:
            raise ValueError(
                f"checkpoint {path} has no embedded config; pass cfg=")
        cfg = cfg.replace(device=str(device))
        if cfg.n_bodies != n_saved:
            warnings.warn(
                f"checkpoint {path} holds {n_saved} bodies but config says "
                f"n_bodies={cfg.n_bodies}; using the checkpoint's {n_saved}")
            cfg = cfg.replace(n_bodies=n_saved)
        if (mesh is not None and cfg.flat_state
                and not (overrides or {}).get("flat_state")):
            warnings.warn(
                "checkpoint config has flat_state=True but flat mode is "
                "single-device; resuming onto the mesh in (N, 3) layout")
            cfg = cfg.replace(flat_state=None)
        flat = mesh is None and should_use_flat(cfg, resolve_impl(cfg))
        state, _, _ = load_checkpoint(path, device=device, flat=flat)
        sim = cls(cfg, state=state, logger=logger, mesh=mesh, comm=comm)
        sim.step_count = step_count
        return sim

    def _total_energy(self) -> float:
        """Total energy for ``track_energy``: float64 on the host up to
        ``MAX_HOST_ENERGY_N`` bodies, kernel K8 above; past it a mesh run
        computes on the mesh (``parallel/energy.py``: K8's row sums a
        shard, no shard sweeping all N^2) with the heartbeat, where the
        JAX package does.  The threshold is read at each call."""
        if (self.mesh is not None
                and self.cfg.n_bodies > penergy.MAX_HOST_ENERGY_N):
            return penergy.total_energy_sharded(
                self.state, self.cfg.eps2, self.mesh,
                progress=self.progress)
        return energy_f64(self.state, self.cfg.eps2)

    def _run_chunk(self, n: int) -> None:
        if self.mesh is not None and self._use_multiprog:
            self.state = run_steps_sharded_multiprog(
                self.state, self.cfg, self.mesh, n, impl=self.impl,
                comm=self.comm, progress=self.progress)
        elif self.mesh is not None:
            self.state = run_steps_sharded(self.state, self.cfg, self.mesh,
                                           n, impl=self.impl,
                                           comm=self.comm)
        elif self._flat:
            self.state = run_steps_flat(self.state, self.cfg, n,
                                        impl=self.impl,
                                        progress=self.progress)
        elif self._use_multiprog:
            self.state = run_steps_multiprog(self.state, self.cfg, n,
                                             impl=self.impl,
                                             progress=self.progress)
        elif self._resident:
            self.state = run_steps_resident(self.state, self.cfg, n)
        else:
            self.state = run_steps(self.state, self.cfg, n, impl=self.impl)

    def run(self, n_steps: Optional[int] = None,
            log_every: Optional[int] = None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0,
            frame_streamer=None,
            track_energy: bool = False,
            nan_watchdog: bool = True,
            sort_every: int = 0) -> SimResult:
        # A heartbeat for the bounded dispatch, owned by this call (and
        # removed however it ends) when the caller installed none.
        own = (self.progress is None and self._use_multiprog
               and not self.logger.quiet)
        if own:
            self.progress = _ProgressHeartbeat(self.logger)
        try:
            return self._run(n_steps, log_every, checkpoint_path,
                             checkpoint_every, frame_streamer, track_energy,
                             nan_watchdog, sort_every)
        finally:
            if own:
                self.progress = None

    def _sort(self, state):
        """Morton-sort ``state`` (only the labels move), flat or not."""
        cfg = self.cfg
        if not is_flat(state):
            return morton_sort_state(state, -cfg.max_pos, cfg.max_pos)[0]
        return flat_from_state(morton_sort_state(
            state_from_flat(state), -cfg.max_pos, cfg.max_pos)[0])

    def _run(self, n_steps, log_every, checkpoint_path, checkpoint_every,
             frame_streamer, track_energy, nan_watchdog,
             sort_every) -> SimResult:
        n_steps = n_steps if n_steps is not None else self.cfg.steps
        cfg = self.cfg
        if log_every is None:
            log_every = auto_log_every(cfg, n_steps)
        timer = StepTimer(n_bodies=cfg.n_bodies)
        device = self.state.pos.device

        e0 = self._total_energy() if track_energy else None
        if self.mesh is not None:
            self.logger.banner(f"== {self.mesh.describe()}, comm="
                               f"{self.comm} ==")
        self.logger.banner(
            f"== nbody_tpu_torch: N={cfg.n_bodies} steps={n_steps} "
            f"impl={self.impl}"
            + (" (resident)" if self._resident else "")
            + (" (flat)" if self._flat else "")
            + f" integrator={cfg.integrator} dt={cfg.dt} eps2={cfg.eps2} "
            f"device={device} ==")

        # A chunk runs uninterrupted on the card; the log, checkpoint and
        # sort cadences bound it, and chunks end exactly on checkpoint and
        # sort steps.  Frames come batched when every such cadence is a
        # multiple of viz_every: each chunk renders its frames on the
        # device (run_trajectory_frames, or its sharded form), capped at
        # a 32 MiB batch of packed maps, and ships them in one copy that
        # overlaps the next chunk.  Otherwise a chunk would cut a frame's
        # stretch of steps, so chunks end on viz_every steps too and each
        # frame is rendered at the end of its chunk (boundary frames); so
        # do bounded runs, whose steps go through the bounded dispatch.
        viz = frame_streamer is not None and cfg.viz_every > 0
        batched = viz and not self._use_multiprog and all(
            c % cfg.viz_every == 0 for c in (checkpoint_every, sort_every)
            if c > 0)
        boundaries = [c for c in (
            checkpoint_every, sort_every,
            cfg.viz_every if viz and not batched else 0) if c > 0]
        cadences = [log_every if log_every > 0 else n_steps, *boundaries]
        if batched:
            frame_bytes = cfg.viz_width * cfg.viz_height
            cadences.append(cfg.viz_every
                            * max(1, min(24, (32 << 20) // frame_bytes)))
        chunk = max(1, min(cadences))
        if batched and chunk % cfg.viz_every:
            chunk = max(cfg.viz_every, chunk - chunk % cfg.viz_every)
        if sort_every > 0:
            # Sort before the first chunk; only the labels move.
            self.state = self._sort(self.state)

        copier = _FrameCopy(device) if viz else None
        pending = None        # the frames of the last chunk, on their way
        frame_idx = 0

        def camera():
            """The streamer's view (the live viewer's zoom and pan) as the
            rasterizer's ``(max_view, cu, cv)``; None for a fixed view."""
            vs = getattr(frame_streamer, "view_state", None)
            if vs is None:
                return None
            zoom, cx, cy = vs()
            return (cfg.max_view / zoom, cx * cfg.max_view,
                    cy * cfg.max_view)

        def drain():
            """Colorize and submit the frames whose copy was queued last;
            called after the next chunk is queued, so that copy overlapped
            the chunk's compute."""
            nonlocal pending, frame_idx
            if pending is None:
                return
            for f in copier.wait(pending):
                frame_streamer.submit(frame_idx, colorize(f))
                frame_idx += 1
            pending = None

        def poll_control() -> bool:
            """The streamer's run control (the live viewer's /stop, /pause,
            /resume): True to stop, after a checkpoint when a path is set;
            blocks while paused, with the card idle between chunks."""
            ctl = getattr(frame_streamer, "control_state", None)
            if ctl is None:
                return False
            state = ctl()
            while state == "pause":
                time.sleep(0.25)
                state = ctl()
            if state != "stop":
                return False
            if checkpoint_path:
                save_checkpoint(checkpoint_path, self.state,
                                self.step_count, cfg)
            self.logger.banner(
                f"== run stopped by viewer control at step "
                f"{self.step_count}"
                + (f" (checkpointed -> {checkpoint_path})"
                   if checkpoint_path else "") + " ==")
            return True

        done = 0
        first_chunk_s = 0.0
        stopped = False
        # The first chunk (kernel builds, allocator warm-up) is timed apart.
        while done < n_steps:
            todo = min(chunk, n_steps - done)
            for c in boundaries:
                todo = min(todo, c - done % c)
            first = done == 0
            t0 = time.perf_counter()
            if not first:
                timer.start()
            if batched:
                if self.mesh is not None:
                    self.state, frames = run_trajectory_frames_sharded(
                        self.state, cfg, self.mesh, todo,
                        frame_every=cfg.viz_every, impl=self.impl,
                        comm=self.comm, view=camera())
                else:
                    self.state, frames = run_trajectory_frames(
                        self.state, cfg, todo, frame_every=cfg.viz_every,
                        impl=self.impl, packed=True, view=camera(),
                        resident=self._resident)
                drain()
                pending = copier.start(frames)
            else:
                self._run_chunk(todo)
                drain()
            sync_stream(device)
            if not first:
                timer.stop(todo)
            else:
                first_chunk_s = time.perf_counter() - t0
            done += todo
            self.step_count += todo

            if nan_watchdog and not bool(
                    torch.isfinite(self.state.pos[:1]).all()):
                raise FloatingPointError(
                    f"non-finite positions at step {self.step_count}; "
                    f"reduce dt or check initial conditions")

            if viz and not batched and (done % cfg.viz_every == 0
                                        or done == n_steps):
                view = camera() or (cfg.max_view, 0.0, 0.0)
                if self.mesh is not None:
                    w8 = render_weights_sharded(self.state, cfg, self.mesh,
                                                view)
                else:
                    render = (render_weights_flat if self._flat
                              else render_weights)
                    w8 = render(
                        self.state.pos, self.state.mass, cfg.min_mass,
                        cfg.max_mass, view[0], cfg.viz_width,
                        cfg.viz_height, 2, view[1], view[2])
                pending = copier.start(w8[None])

            if checkpoint_every > 0 and checkpoint_path and (
                    done % checkpoint_every == 0 or done == n_steps):
                save_checkpoint(checkpoint_path, self.state,
                                self.step_count, cfg)

            if sort_every > 0 and done % sort_every == 0 and done < n_steps:
                self.state = self._sort(self.state)

            if log_every > 0 and timer.total_steps:
                self.logger.log(
                    step=self.step_count,
                    sim_time=self.step_count * cfg.dt,
                    ms_per_step=round(timer.ms_per_step, 4),
                    steps_per_s=round(timer.steps_per_s, 3),
                    ginter_per_s=round(timer.ginter_per_s, 2),
                )

            if done < n_steps and poll_control():
                stopped = True
                break
        drain()

        if checkpoint_path and checkpoint_every <= 0 and not stopped:
            # A checkpoint path without a cadence saves the end state (a
            # viewer's stop has checkpointed already).
            save_checkpoint(checkpoint_path, self.state, self.step_count, cfg)

        e1 = self._total_energy() if track_energy else None
        if timer.total_steps:
            ms_per_step = timer.ms_per_step
            ginter = timer.ginter_per_s
        else:
            # Every step ran in the first chunk; report it (an upper
            # bound on the cost, build time included) rather than 0.
            steps0 = max(1, done)
            ms_per_step = 1000.0 * first_chunk_s / steps0
            ginter = float(cfg.n_bodies) ** 2 * steps0 / first_chunk_s / 1e9 \
                if first_chunk_s else 0.0
        result = SimResult(
            state=self.state, steps_run=done, ms_per_step=ms_per_step,
            ginter_per_s=ginter, energy_initial=e0, energy_final=e1)
        if track_energy:
            self.logger.log(step=self.step_count,
                            sim_time=self.step_count * cfg.dt,
                            energy=e1, energy_drift=result.energy_drift)
        return result


class _FrameCopy:
    """The device-to-host leg of the frame stream.  ``start`` queues the
    copy of a batch of frames into pinned host memory on a side stream,
    behind the work that renders them, so the copy runs while the card
    computes the next chunk; ``wait`` returns the frames as numpy.  On
    the CPU the frames are already on the host."""

    def __init__(self, device: torch.device):
        self._stream = (torch.cuda.Stream(device) if device.type == "cuda"
                        else None)

    def start(self, frames: torch.Tensor):
        if self._stream is None:
            return frames, None
        self._stream.wait_stream(torch.cuda.current_stream(frames.device))
        with torch.cuda.stream(self._stream):
            host = torch.empty(frames.shape, dtype=frames.dtype,
                               pin_memory=True)
            host.copy_(frames, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        # The allocator must not hand the frames' memory to the next
        # chunk before the copy has read it.
        frames.record_stream(self._stream)
        return host, done

    @staticmethod
    def wait(pending) -> np.ndarray:
        host, done = pending
        if done is not None:
            done.synchronize()
        return host.numpy()
