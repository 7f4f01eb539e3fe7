"""The sharded all-pairs sweeps: the one-sided ring, the Newton's-third-law
ring and the all-gather, with the sharded step loop, as in
``nbody_tpu/parallel/ring.py``.

Bodies are cut into P shards (``parallel/mesh.py``).  Each shard's i-side
meets every j-shard in P hops: the one-sided ring rotates positions and
masses around the mesh and sweeps each visitor with a one-sided rect form;
the N3L ring stops halfway, computes each visiting shard two-sided
through ``rect_forces_sym`` (K2-rect) and sends the j-side partial home in
a buffer that travels with the visitor; the all-gather variant gathers the
whole j-side once.

What survives from JAX's ``shard_map`` + ``ppermute``: the schedule, per
shard, written once against a small collective object (``LocalComm``:
``ppermute``, ``all_gather``, ``axis_size``, ``axis_index`` and ``map``
for the per-shard work).  ``LocalComm`` holds every shard in one process
as a list of tensors: ``ppermute`` is a rotation of the list plus
``Tensor.to`` (a no-op on one card, a peer copy across cards, which
PyTorch queues behind both cards' current streams, so the receiving
card's next launch waits for it and the host does not) and
``all_gather`` is ``torch.cat`` onto each card once.  Across cards the
shards' launches are queued card after card with no host sync between
them, so the cards run at once.  The JAX package is one process too
(nothing in it calls ``jax.distributed``), so a collective object over
processes is not part of the port.
PyTorch runs eagerly, so the step loop is a Python loop that queues the
kernels on the card; XLA's async collective scheduling, which overlaps
the TPU's hops with compute, has no counterpart needed on one card.

``comm="rdma"`` and ``"rdma_overlap"`` take the fused ring K13
(``parallel/rdma_ring.py``): one launch computes a force evaluation of
every shard, the sym ladder two-sided over half the ring and the one-sided
family (``pallas``, ``pallas_turbo``) over all of it; ``auto`` resolves to
``pallas_sym2`` for both.

The bounded mesh (``parallel/multiprog.py``) runs this same N3L ring
with each shard's sweeps cut into programs (``ring_forces_local_sym``'s
``progress`` and ``max_prog_interactions``); the step loop and the KDK
prime take its force function through ``force=``, and
``prime_kdk_sharded`` routes there when ``should_use_multiprog`` engages
on the mesh, as in the JAX package.

Frames on the mesh (``render_weights_sharded``,
``run_trajectory_frames_sharded``): each shard rasterizes its own bodies
and the maps, gathered once onto the state's device (each card's bytes
moved once), are max-combined, the rasterizer's own brightest-point rule,
so the pixels are
those of the gathered state's render and the zero-mass padding never
draws.  The ring's pair potential, a mesh run's energy past the host
wall, is ``parallel/energy.py``: K8's row sums of each shard against a
visitor that walks this module's ``LocalComm``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..config import SimConfig
from ..models.integrators import (KDK_WEIGHTS, kdk_drift, kdk_kick,
                                  reference_update)
from ..models.state import SimState, pad_state_to, round_up, unpad_state
from ..ops.forces_fast import rect_forces_fast
from ..ops.forces_sym import SYM_TILE
from ..ops.forces_sym_variants import forces_pallas_sym, rect_forces_sym
from ..ops.forces_tiled import rect_forces_tiled, rect_forces_tiled_kahan
from ..ops.forces_tiled_tc import rect_forces_tiled_tc
from ..ops.forces_torch import rect_forces
from .mesh import Mesh, gather_state, shard_state
from .rdma_ring import rdma_forces_local, rdma_variant

COMMS = ("ring", "allgather", "rdma", "rdma_overlap")

# impl -> one-sided rect kernel variant (the allgather path, the
# one-sided ring, and the antipodal step of the even-P sym ring).  The
# pair-symmetric impls map to their one-sided accuracy twins.
_RECT_VARIANTS = {"pallas": "vpu", "pallas_sym": "vpu",
                  "pallas_sym2": "vpu", "pallas_kahan": "vpu_kahan",
                  "pallas_mxu": "mxu", "pallas_fast": "fast",
                  "pallas_turbo": "turbo", "pallas_sym_turbo": "turbo",
                  "pallas_sym_turbo2": "turbo", "pallas_sym_mxu": "mxu"}

# impl -> pair-symmetric kernel variant: these route comm="ring" through
# the N3L ring (ring_forces_local_sym), which computes every unordered
# cross-shard pair once.
_SYM_VARIANTS = {"pallas_sym": "vpu", "pallas_sym2": "vpu2",
                 "pallas_sym_turbo": "turbo",
                 "pallas_sym_turbo2": "turbo2", "pallas_sym_mxu": "mxu"}


class LocalComm:
    """The collectives of one process that holds every shard of ``mesh``:
    a sharded value is a list with one tensor per shard."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    @property
    def axis_size(self) -> int:
        return self.mesh.size

    def axis_index(self) -> "list[int]":
        return list(range(self.mesh.size))

    def map(self, fn, *values) -> list:
        """``fn`` applied shard by shard."""
        return [fn(*args) for args in zip(*values)]

    def ppermute(self, values: list, perm) -> list:
        """Shard ``src``'s value moves to shard ``dst`` for each pair."""
        out = [None] * self.mesh.size
        for src, dst in perm:
            out[dst] = values[src].to(self.mesh.devices[dst])
        return out

    def all_gather(self, values: list) -> list:
        """Every shard gets the values of all shards, in shard order."""
        full = {}
        for d in self.mesh.devices:
            if d not in full:
                full[d] = torch.cat([v.to(d) for v in values])
        return [full[d] for d in self.mesh.devices]


def _local_rect_forces(pos_i, pos_j, mass_j, cfg: SimConfig, impl: str,
                       self_tile: bool = False):
    """One shard's (i-shard x j-tile) force block.  ``self_tile`` marks the
    rotation where the j tile is the shard's own (index equality means the
    same body): the masked tensor-core and fast tiers mask the self-pair
    there only."""
    if not impl.startswith("pallas"):
        return rect_forces(pos_i, pos_j, mass_j, cfg.eps2, chunk=cfg.chunk)
    variant = _RECT_VARIANTS.get(impl)
    if variant is None:
        raise ValueError(f"unsupported sharded pallas impl {impl!r}")
    if variant == "vpu":
        return rect_forces_tiled(pos_i, pos_j, mass_j, cfg.eps2)
    if variant == "vpu_kahan":
        return rect_forces_tiled_kahan(pos_i, pos_j, mass_j, cfg.eps2)
    if variant == "fast":
        return rect_forces_fast(pos_i, pos_j, mass_j, cfg.eps2, self_tile)
    return rect_forces_tiled_tc(pos_i, pos_j, mass_j, cfg.eps2, variant,
                                self_tile)


def _resolve_local_impl(impl: Optional[str], mesh: Mesh,
                        comm: str = "ring",
                        default: Optional[str] = None) -> str:
    """Resolve None/'auto' for the sharded entry points: ``pallas_sym2``
    under both rdma comms on any device (K13 takes the sym ladder and the
    one-sided family only; JAX's ``cli.py:398`` asks for it under
    ``rdma`` alone and so refuses ``rdma_overlap`` with auto), else
    ``default`` (the caller's own resolution) or the exact one-sided
    kernel K1 on a card and the plain path on the CPU."""
    if impl is not None and impl != "auto":
        return impl
    if comm.startswith("rdma"):
        return "pallas_sym2"
    if default is not None:
        return default
    return "pallas" if mesh.devices[0].type == "cuda" else "xla"


def ring_forces_local(pos_l, mass_l, cfg: SimConfig, impl: str,
                      comm: LocalComm):
    """The one-sided ring: each shard sweeps its own shard (rotation 0,
    ``self_tile=True``), then P - 1 rotating j-tiles."""
    p = comm.axis_size
    perm = [(i, (i + 1) % p) for i in range(p)]
    acc = comm.map(lambda x, m: _local_rect_forces(x, x, m, cfg, impl,
                                                   self_tile=True),
                   pos_l, mass_l)
    pos_j, mass_j = pos_l, mass_l
    for _ in range(p - 1):
        pos_j = comm.ppermute(pos_j, perm)
        mass_j = comm.ppermute(mass_j, perm)
        acc = comm.map(lambda a, x, xj, mj: a + _local_rect_forces(
            x, xj, mj, cfg, impl), acc, pos_l, pos_j, mass_j)
    return acc


def ring_forces_local_sym(pos_l, mass_l, cfg: SimConfig, impl: str,
                          comm: LocalComm, progress=None,
                          max_prog_interactions: Optional[float] = None):
    """Newton's-third-law ring: every unordered shard pair computed once.

    The self shard runs the pair-symmetric kernel of the impl's variant.
    At each of the (P - 1) // 2 cross rotations a shard computes its
    i-shard against the visiting shard two-sided (``rect_forces_sym``),
    keeps the i-side and adds the j-side into a buffer that travels with
    the visitor; for even P the antipodal rotation is its own mirror and
    runs one-sided on both owners; a last hop ships each travel buffer
    home.

    With ``max_prog_interactions`` (the bounded mesh) every shard's self
    and rect sweeps run in programs of at most that many interactions,
    and ``progress(done, total, acc)`` is called after each of them and
    after each shard's antipodal sweep (one launch, one program); the
    launches and the sums are those of the unbounded ring."""
    variant = _SYM_VARIANTS[impl]
    p = comm.axis_size
    fwd = [(i, (i + 1) % p) for i in range(p)]
    half = (p - 1) // 2
    eps2 = cfg.eps2
    bound = {"progress": progress,
             "max_prog_interactions": max_prog_interactions}

    acc_i = comm.map(lambda x, m: forces_pallas_sym(x, m, eps2,
                                                    variant=variant, **bound),
                     pos_l, mass_l)
    acc_t = comm.map(torch.zeros_like, pos_l)
    pos_j, mass_j = pos_l, mass_l
    for _ in range(half):
        pos_j = comm.ppermute(pos_j, fwd)
        mass_j = comm.ppermute(mass_j, fwd)
        acc_t = comm.ppermute(acc_t, fwd)
        both = comm.map(lambda x, m, xj, mj: rect_forces_sym(
            x, m, xj, mj, eps2, variant=variant, **bound), pos_l, mass_l,
            pos_j, mass_j)
        acc_i = comm.map(lambda a, ab: a + ab[0], acc_i, both)
        acc_t = comm.map(lambda t, ab: t + ab[1], acc_t, both)

    if p % 2 == 0:
        pos_j = comm.ppermute(pos_j, fwd)
        mass_j = comm.ppermute(mass_j, fwd)

        def antipodal(a, x, xj, mj):
            out = a + _local_rect_forces(x, xj, mj, cfg, impl)
            if progress is not None:
                progress(1, 1, out)
            return out
        acc_i = comm.map(antipodal, acc_i, pos_l, pos_j, mass_j)

    if half > 0:
        back = [(i, (i - half) % p) for i in range(p)]
        acc_i = comm.map(torch.add, acc_i, comm.ppermute(acc_t, back))
    return acc_i


def allgather_forces_local(pos_l, mass_l, cfg: SimConfig, impl: str,
                           comm: LocalComm):
    """Gather the whole j-side once, then one rect sweep per shard.  For
    the masked tiers each shard's gathered copy is rolled so that its own
    shard comes first: then index equality means the same body and the
    square self-pair mask is right for the whole rectangle."""
    pos_all = comm.all_gather(pos_l)
    mass_all = comm.all_gather(mass_l)
    if _RECT_VARIANTS.get(impl) in ("mxu", "fast", "turbo"):
        def masked(x, xa, ma, i):
            shift = i * x.shape[0]
            return _local_rect_forces(x, torch.roll(xa, -shift, 0),
                                      torch.roll(ma, -shift, 0), cfg, impl,
                                      self_tile=True)
        return comm.map(masked, pos_l, pos_all, mass_all, comm.axis_index())
    return comm.map(lambda x, xa, ma: _local_rect_forces(x, xa, ma, cfg,
                                                         impl),
                    pos_l, pos_all, mass_all)


def _local_force_fn(impl: str, comm: str):
    """The per-shard force sweep for an (impl, comm) pair: the one routing
    rule the step loop and the KDK priming share."""
    if comm == "rdma":
        return rdma_forces_local
    if comm == "rdma_overlap":
        return functools.partial(rdma_forces_local, overlap=True)
    if comm == "ring" and impl in _SYM_VARIANTS:
        return ring_forces_local_sym
    if comm == "ring":
        return ring_forces_local
    return allgather_forces_local


def _one_step_local(mass_l, cfg: SimConfig, impl: str, comm: str,
                    coll: LocalComm, force=None):
    """The per-shard step ``(pos, vel, acc) -> (pos, vel, acc)`` for the
    comm tier and integrator (sharded values in, sharded values out);
    ``force``: the per-shard sweep in place of the comm tier's."""
    force = force or _local_force_fn(impl, comm)
    weights = KDK_WEIGHTS.get(cfg.integrator)
    if weights is not None:
        # KDK-composed schemes: the first half-kick uses the carried
        # acceleration (callers prime it with prime_kdk_sharded).
        def one_step(carry):
            pos, vel, acc = carry
            for w in weights:
                wdt = w * cfg.dt
                vel_half = coll.map(lambda v, a: kdk_kick(v, a, wdt), vel,
                                    acc)
                pos = coll.map(lambda x, v: kdk_drift(x, v, wdt), pos,
                               vel_half)
                acc = force(pos, mass_l, cfg, impl, coll)
                vel = coll.map(lambda v, a: kdk_kick(v, a, wdt), vel_half,
                               acc)
            return pos, vel, acc
    elif cfg.integrator == "reference":
        def one_step(carry):
            pos, vel, _ = carry
            acc = force(pos, mass_l, cfg, impl, coll)
            new = coll.map(lambda x, v, a: reference_update(x, v, a, cfg.dt),
                           pos, vel, acc)
            return [x for x, _ in new], [v for _, v in new], acc
    else:
        raise ValueError(f"unknown integrator {cfg.integrator!r}")
    return one_step


def shard_padding(cfg: SimConfig, n_devices: int) -> int:
    """Padded N: divisible by P into shards of whole 256-body kernel tiles.
    (The JAX package pads each shard to its Pallas block sizes; the
    kernels here mask ragged tiles, and whole tiles keep the shards'
    sweeps free of half-empty tiles.)"""
    return round_up(cfg.n_bodies, n_devices * SYM_TILE)


def _local_impl(impl: Optional[str], mesh: Mesh, comm: str) -> str:
    """The checked comm and the resolved impl of a sharded entry point;
    under the rdma comms an impl K13 does not take raises ValueError
    naming rdma, as in the JAX package."""
    if comm not in COMMS:
        raise ValueError(f"comm must be one of {COMMS}, got {comm!r}")
    local_impl = _resolve_local_impl(impl, mesh, comm)
    if comm.startswith("rdma"):
        rdma_variant(local_impl)
    return local_impl


def _sharded(state: SimState, cfg: SimConfig, mesh: Mesh):
    """The state padded with zero-mass ghosts and cut into shards."""
    shards = shard_state(pad_state_to(state, shard_padding(cfg, mesh.size)),
                         mesh)
    return ([s.pos for s in shards], [s.vel for s in shards],
            [s.acc for s in shards], [s.mass for s in shards])


def run_steps_sharded(state: SimState, cfg: SimConfig, mesh: Mesh,
                      n_steps: int, impl: Optional[str] = None,
                      comm: str = "ring", force=None) -> SimState:
    """Run ``n_steps`` on the mesh: the state is padded with zero-mass
    ghosts, cut into shards, advanced shard by shard through the comm
    tier's sweep (or ``force(pos, mass, cfg, impl, comm)``, the bounded
    mesh's), and gathered and unpadded on the state's device."""
    return run_trajectory_frames_sharded(state, cfg, mesh, n_steps,
                                         frame_every=n_steps + 1, impl=impl,
                                         comm=comm, force=force)[0]


def _render_shards(pos: list, mass: list, cfg: SimConfig, coll: LocalComm,
                   view: "tuple | None", device) -> torch.Tensor:
    """One packed ``(H, W)`` uint8 map of the sharded bodies on
    ``device``: each shard's own map, max-combined over the mesh (the
    maps gathered once, onto ``device`` alone)."""
    from ..viz.raster import render_weights
    mv, cu, cv = view if view is not None else (cfg.max_view, 0.0, 0.0)
    maps = coll.map(lambda p, m: render_weights(
        p, m, cfg.min_mass, cfg.max_mass, mv, cfg.viz_width,
        cfg.viz_height, 2, cu, cv), pos, mass)
    return torch.stack([m.to(device) for m in maps]).amax(0)


def render_weights_sharded(state: SimState, cfg: SimConfig, mesh: Mesh,
                           view: "tuple | None" = None) -> torch.Tensor:
    """One packed ``(H, W)`` uint8 weight map of ``state`` rendered on the
    mesh: the state cut into shards as a sharded step cuts it, each shard
    rasterized on its device, the maps max-combined.  Pixel-identical to
    ``render_weights`` of the whole state."""
    pos, _, _, mass = _sharded(state, cfg, mesh)
    return _render_shards(pos, mass, cfg, LocalComm(mesh), view,
                          state.pos.device)


def run_trajectory_frames_sharded(
        state: SimState, cfg: SimConfig, mesh: Mesh, n_steps: int,
        frame_every: int = 1, impl: Optional[str] = None,
        comm: str = "ring", view: "tuple | None" = None, force=None):
    """``ops.step.run_trajectory_frames`` on the mesh: ``n_steps`` sharded
    steps with the sharded state rendered every ``frame_every``-th step
    (``_render_shards``), the shards gathered once at the end.

    Returns ``(final SimState, frames (F, H, W) uint8 packed weight maps
    on the state's device)``; ``viz.raster.colorize`` gives the RGB."""
    local_impl = _local_impl(impl, mesh, comm)
    pos, vel, acc, mass = _sharded(state, cfg, mesh)
    coll = LocalComm(mesh)
    one_step = _one_step_local(mass, cfg, local_impl, comm, coll, force)
    n_frames = n_steps // frame_every
    frames = torch.empty((n_frames, cfg.viz_height, cfg.viz_width),
                         dtype=torch.uint8, device=state.pos.device)
    carry = (pos, vel, acc)
    for k in range(n_steps):
        carry = one_step(carry)
        if (k + 1) % frame_every == 0:
            frames[k // frame_every] = _render_shards(
                carry[0], mass, cfg, coll, view, state.pos.device)
    out = gather_state([SimState(*s) for s in zip(*carry, mass)],
                       device=state.pos.device)
    return unpad_state(out, state.n), frames


def prime_kdk_sharded(state: SimState, cfg: SimConfig, mesh: Mesh,
                      impl: Optional[str] = None,
                      comm: str = "ring", progress=None,
                      force=None) -> SimState:
    """Seed ``state.acc = a(x_0)`` through the mesh's sweep, the sharded
    ``ops.step.prime_kdk``: through the bounded mesh
    (``parallel/multiprog.py``, ``progress`` its per-program callback)
    where ``should_use_multiprog`` engages with the ring, as the step loop
    routes, or through ``force`` when given."""
    from ..ops.step import should_use_multiprog
    local_impl = _local_impl(impl, mesh, comm)
    if (force is None and comm == "ring" and local_impl in _SYM_VARIANTS
            and should_use_multiprog(cfg, local_impl, mesh.size)):
        from .multiprog import prime_kdk_sharded_multiprog
        return prime_kdk_sharded_multiprog(state, cfg, mesh, impl=local_impl,
                                           progress=progress)
    pos, _, _, mass = _sharded(state, cfg, mesh)
    acc = (force or _local_force_fn(local_impl, comm))(
        pos, mass, cfg, local_impl, LocalComm(mesh))
    acc = torch.cat([a.to(state.pos.device) for a in acc])
    return state._replace(acc=acc[:state.n])
