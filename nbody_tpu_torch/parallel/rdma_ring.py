"""K13: the fused ring, one launch a card per force evaluation over the
shards the card holds, as ``nbody_tpu/parallel/rdma_ring.py``.

The JAX kernel (``_make_ring_kernel``) runs the whole P-phase ring of one
TPU inside one ``pallas_call``: a one-sided self sweep, then D data hops,
each forwarding a ``[posT; mass; travel acc]`` payload to the right
neighbour by remote DMA and computing against it, and a return hop that
ships each travel partial home.  On the pair-symmetric ladder (the
``pallas_sym*`` impls) the first ``(P - 1) // 2`` hops are two-sided: the
i side stays, the j side is added into the payload's travel rows; for even
P the antipodal hop is one-sided; D = ``(P - 1) // 2`` for odd P and
``P // 2`` for even P.  The one-sided family (``_RDMA_ONE_SIDED``) sweeps
all P - 1 hops one-sided with data-only payloads.

On one card one cooperative launch (``csrc/rdma_ring.cu``,
``rdma_ring_kernel``) runs the ring of every shard, the payloads copied
from shard to shard between grid syncs.  Across cards each card runs one
launch a force evaluation (``rdma_flag_kernel``) over the shards it
holds, each shard's work done by its own group of the launch's CTAs, and
the hops are JAX's protocol with flags for its semaphores: a shard pushes its
payload into its right neighbour's slot ``d % 2`` (peer stores over
NVLink where the neighbour lies on another card, plain stores on one
card), then releases an arrival flag in the neighbour's memory, which the
neighbour acquires before it reads; one ack a phase to the left neighbour
says a slot is free again, with JAX's prophylactic ack before the loop and
its drain after it; the return hop pushes each travel partial into its
home shard.  The flags keep their values across launches and count up by
epoch (one a force evaluation), so a launch never reads an earlier one's
signal; every wait is bounded, and one that runs out sets the card's
error word, which the wrapper turns into a raise (``check_errors``).
``launch_plan`` is the protocol's layout for a placement: each card's
launch, each hop's kind, the return hops and the flags' values after an
evaluation.  Shards on CUDA cards run; a mix of CUDA and other devices
raises, and nothing falls back to the ppermute ring.  The flag kernel
gives the grid-sync kernel's bits (the same slots, tiles and reduce
within a shard), and on one card it also runs as one launch whose P
groups order themselves by the flags, or as G launches on G streams (the
launches of G cards with only the peer mapping left out): ``_launch``'s
test knobs.  On one card it is slower than the grid-sync kernel (its
one-sided phases ~10%, ``PERF.md`` §6), so both stay.

``comm="rdma_overlap"`` is JAX's ``overlap=True``: the data of the next
hop is copied under the current hop's compute, the j side of a hop sums
into a private ``jacc`` from zero and is folded in as ``travel + jacc``
once the travel rows (one hop behind) have arrived.  The results differ
from the sequential protocol at rounding only.

The mass-scaled ``vpu2`` sums are divided by the body's mass after the
return hop; a real body of mass 0 gets its row recomputed one-sided over
all bodies, where JAX's ``_inv_mass_scale`` gives it an acceleration of
exactly 0 (ROADMAP Queue 3).  Masses do not change during a run, so the
wrapper knows once a mass tensor which shards hold such a body; only
their finish reads the other shards' bodies (through peer pointers), and
the positions barrier holds every launch open until those reads are done,
so that no card's integrator moves a body that is still being read.

The port's shards are whole 256-body tiles (``parallel/ring.py``,
``shard_padding``): ``--block-i/-j/-u`` are accepted and do not change
K13's tiles, so JAX's gcd clamp of its blocks has no counterpart.

``rdma_ring`` launches the kernel for a CUDA tensor (counted on
``rdma_ring.launches``, one a card an evaluation) or raises, and takes the
plain PyTorch twin ``rdma_ring_plain`` (the same phases, slots, tiles and
association orders) only for a CPU tensor; ``rdma_ring_sharded`` takes one
tensor a shard, on any cards.  ``rdma_forces_local`` is the per-shard
entry point of the sharded step loop (lists in, lists out).
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import torch

from ..config import SimConfig
from ..ops import _build
from ..ops import forces_sym as _k2
from ..ops import forces_sym_tc as _ktc
from ..ops.forces_sym import SLOT_BUDGET_BYTES, SYM_TILE
from ..ops.forces_tiled_tc import (bf16_split, mass_folded_pack, pair_inv,
                                   position_pack, tile_result)

# One-sided impls that ride the ring with data-only payloads over the full
# P - 1 phases, and their variants.
_RDMA_ONE_SIDED = {"pallas": "vpu", "pallas_turbo": "turbo"}
# The kernel's variants, in csrc/rdma_ring.cu's RingVariant order.
VARIANTS = ("vpu2", "vpu", "turbo", "mxu", "turbo2")
# Variants whose sums carry the receiving body's mass.
_MASS_SCALED = ("vpu2",)
# Variants whose one-sided self tile masks the self pair (the bf16
# weights do not cancel r = 0).
_MASKED_SELF = ("turbo", "mxu", "turbo2")

_c_ll, _c_ptr, _c_int = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
_c_ull = ctypes.c_ulonglong

# The flag protocol's layout (csrc/rdma_ring.cu: RING_MAX_SHARDS,
# RING_EPOCH_SHIFT, RING_PEER_FLOATS, RingFlag), checked against the build
# by ``bind``: a shard's flag words, the payload floats a body of its
# buffer (data slots 2 x 4, travel slots 2 x 3, the return hop's 3).
RING_MAX_SHARDS = 64
EPOCH_SHIFT = 20
PEER_FLOATS = 17
FLAG = {"data": 0, "trav": 2, "ack": 4, "ret": 5, "enter": 6, "done": 8}
FLAG_WORDS = FLAG["done"] + RING_MAX_SHARDS
# The wait kinds of the card's error word (RingWait), by code.
WAITS = {1: "ack", 2: "data", 3: "travel", 4: "return hop", 5: "entered",
         6: "positions barrier", 7: "group barrier"}
# The bound of every wait in the kernel: a wait is for a neighbour's phase
# of equal work, so a healthy one is short; 60 s marks a fault.
SPIN_NS = 60 * 10 ** 9


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument types on a build of rdma_ring.cu (the
    package's, an earlier one, or a copy that tools/k1_ring_variants.py
    edits) and check its layout against this module's; a build from before
    the flag protocol has the grid-sync entries only."""
    if lib.nbt_rdma_ring.argtypes is None:
        lib.nbt_rdma_ring.argtypes = [
            _c_int, _c_ptr, _c_ptr, _c_ll, _c_ll, _c_ll, _c_int, _c_int,
            _c_int, ctypes.c_float, *[_c_ptr] * 8, _c_ptr]
        lib.nbt_rdma_ring.restype = _c_int
        lib.nbt_rdma_ring_max_blocks.argtypes = [_c_int]
        lib.nbt_rdma_ring_max_blocks.restype = _c_int
        lib.nbt_rdma_ring_tile.argtypes = []
        lib.nbt_rdma_ring_tile.restype = _c_int
        if _build.query(None, lib.nbt_rdma_ring_tile) != SYM_TILE:
            raise RuntimeError("SYM_TILE differs between forces_sym.py and "
                               "csrc/rdma_ring.cu")
        if hasattr(lib, "nbt_rdma_flags"):
            _bind_flags(lib)
    return lib


def _bind_flags(lib) -> None:
    lib.nbt_rdma_flags.argtypes = [
        _c_int, _c_ll, _c_ll, _c_ll, _c_int, _c_int, _c_int, ctypes.c_float,
        _c_int, _c_ptr, _c_ptr, _c_ull, _c_ull, _c_ull, *[_c_ptr] * 8,
        _c_int, _c_int, _c_ptr]
    lib.nbt_rdma_flags.restype = _c_int
    lib.nbt_rdma_flags_max_blocks.argtypes = [_c_int]
    lib.nbt_rdma_flags_max_blocks.restype = _c_int
    lib.nbt_rdma_flag_geometry.argtypes = [_c_int]
    lib.nbt_rdma_flag_geometry.restype = _c_ll
    lib.nbt_rdma_enable_peers.argtypes = [_c_ptr, _c_int]
    lib.nbt_rdma_enable_peers.restype = _c_int
    built = [_build.query(None, lib.nbt_rdma_flag_geometry, k)
             for k in range(10)]
    if built != [FLAG_WORDS, RING_MAX_SHARDS, EPOCH_SHIFT, PEER_FLOATS,
                 *FLAG.values()]:
        raise RuntimeError(f"the flag layout of csrc/rdma_ring.cu ({built}) "
                           f"differs from parallel/rdma_ring.py's")


def _lib():
    return bind(_build.load("rdma_ring"))


def ring_phases(p: int, one_sided: bool) -> "tuple[int, int]":
    """(two-sided phases, D): ``((P - 1) // 2, D)`` on the sym ladder with
    D = ``(P - 1) // 2`` for odd P and ``P // 2`` for even P; ``(0, P - 1)``
    for the one-sided family."""
    if one_sided:
        return 0, p - 1
    half = (p - 1) // 2
    return half, half if p % 2 else p // 2


def ring_chunk(p: int, c: int, budget: int = SLOT_BUDGET_BYTES) -> int:
    """Column tiles a chunk: as many as fit ``budget`` bytes of row and
    column slots, 2 * P * C * 3 float32 a column tile, at most C / 256."""
    per = 2 * p * c * 3 * 4
    if per > budget:
        raise ValueError(
            f"rdma_ring: one column tile's slots need {per} bytes, more than "
            f"the {budget}-byte budget (P={p}, C={c})")
    return min(c // SYM_TILE, budget // per)


def max_blocks(variant: str, lib=None, device="cuda",
               protocol: str = "grid") -> int:
    """The co-resident CTAs of the variant's kernel on ``device``'s card:
    the grid of its launch (``lib`` another build, as ``_launch`` takes
    it; ``protocol`` "flags" for the flag kernel)."""
    lib = lib or _lib()
    entry = (lib.nbt_rdma_flags_max_blocks if protocol == "flags"
             else lib.nbt_rdma_ring_max_blocks)
    return _build.query(device, entry, VARIANTS.index(variant))


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """The flag protocol on a placement of P shards: ``launches``, one a
    card, ``(card, shards)`` in the order the cards first appear, each
    card's shards in mesh order (its launch's groups); ``hops[s]`` the kind
    of shard s's hop to s + 1, "local" (plain stores on one card) or
    "peer" (peer stores into another card); ``returns[s]`` the return hop
    of shard s, ``(home, kind)`` with home (s - D) mod P, None without
    travel rows."""

    p: int
    half: int
    d_final: int
    launches: tuple
    hops: tuple
    returns: tuple

    def flags_after(self, epoch: int, overlap: bool,
                    readers: "frozenset[int]" = frozenset()) -> "dict":
        """The flag words one evaluation of ``epoch`` leaves in a shard:
        word index -> epoch << EPOCH_SHIFT plus the last k it released
        there (csrc/rdma_ring.cu, RingFlag); words it does not write keep
        their earlier value.  ``readers``: the shards whose finish reads
        every shard's bodies (their done words; a reader's own is not
        written)."""
        e = epoch << EPOCH_SHIFT
        words = {FLAG["enter"]: e + 1}
        if self.p > 1:
            words[FLAG["ack"]] = e + self.d_final
        for k in (0, 1):
            last = [d for d in range(1, self.d_final + 1) if d % 2 == k]
            if last:
                words[FLAG["data"] + k] = e + last[-1]
                if overlap and self.half > 0:
                    words[FLAG["trav"] + k] = e + last[-1]
        if self.half > 0:
            words[FLAG["ret"]] = e + 1
        for r in readers:
            words[FLAG["done"] + r] = e + 1
        return words


def launch_plan(devices, one_sided: bool = False) -> RingPlan:
    """``RingPlan`` of shards placed on ``devices`` (shard s on
    ``devices[s]``, any hashable card labels)."""
    p = len(devices)
    if not 1 <= p <= RING_MAX_SHARDS:
        raise ValueError(f"rdma_ring: 1 to {RING_MAX_SHARDS} shards, got {p}")
    half, d_final = ring_phases(p, one_sided)
    cards = list(dict.fromkeys(devices))
    launches = tuple((d, tuple(s for s in range(p) if devices[s] == d))
                     for d in cards)

    def kind(a, b):
        return "local" if devices[a] == devices[b] else "peer"
    hops = tuple(kind(s, (s + 1) % p) for s in range(p))
    returns = tuple(((s - d_final) % p, kind(s, (s - d_final) % p))
                    if half > 0 else None for s in range(p))
    return RingPlan(p, half, d_final, launches, hops, returns)


def _check(pos, mass, p, variant, one_sided):
    _build.check_bodies("rdma_ring", pos, mass)
    if variant not in VARIANTS:
        raise ValueError(f"rdma_ring: variant must be one of {VARIANTS}, "
                         f"got {variant!r}")
    if one_sided and variant not in _RDMA_ONE_SIDED.values():
        raise ValueError(f"rdma_ring: the one-sided family is "
                         f"{sorted(_RDMA_ONE_SIDED.values())}, got "
                         f"{variant!r}")
    if p < 1 or pos.shape[0] % (p * SYM_TILE):
        raise ValueError(
            f"rdma_ring: {pos.shape[0]} bodies are not {p} shards of whole "
            f"{SYM_TILE}-body tiles; pad with parallel.ring.shard_padding")


# -- the plain PyTorch twin

def _warp_rows(terms):
    """Row sums (k, T, 3) of a tile's pair terms (k, T, T, 3) as K13's
    exact tiles add them: each warp's 32 columns, then the warps' partials
    in warp order."""
    k, t = terms.shape[:2]
    parts = terms.view(k, t, t // 32, 32, 3).sum(3)
    rows = parts[:, :, 0]
    for w in range(1, parts.shape[2]):
        rows = rows + parts[:, :, w]
    return rows


def _exact_terms(eps2, xi, mi, xj, mj, scaled):
    """The exact pair terms w inv r of a tile, (k, T, T, 3): w = m_i m_j
    (vpu2, ``scaled``) or m_j (vpu's row side)."""
    r = xj[:, None, :, :] - xi[:, :, None, :]
    d2 = (r * r).sum(-1) + eps2
    w = mi[:, :, None] * mj[:, None, :] if scaled else mj[:, None, :]
    return (w * torch.rsqrt(d2 * d2 * d2))[..., None] * r


def _tile_both(variant: str, eps2: float):
    """The two-sided tile of a cross phase: (rows, columns) -> (row sums,
    column sums), each (k, T, 3), signed accelerations (vpu2: mass-scaled).
    vpu2 is K2's pair tile (its row sums in warp order), vpu K7's; K13's
    turbo, mxu and turbo2 keep the unfused geometry (``pair_inv``), not
    K2-rect's trimmed one."""
    if variant == "vpu2":
        def tiles(xi, mi, xj, mj):
            terms = _exact_terms(eps2, xi, mi, xj, mj, True)
            return _warp_rows(terms), -terms.sum(1)
        return tiles
    if variant == "vpu":
        return _k2._pair_tiles(eps2, True, 1)
    return lambda xi, mi, xj, mj: _ktc._pair_tiles(xi, mi, xj, mj, eps2,
                                                   variant, trimmed=False)


def _tile_i(variant: str, eps2: float, xi, mi, xj, mj, self_tile=None):
    """The one-sided tile (JAX's ``_tile_i``): the row sums (k, T, 3) of
    the two-sided tile's i side, in its scale; for vpu2 and vpu the
    one-sided tile of ``csrc/onesided_tile.cuh`` (row sums in warp order).
    ``self_tile``: the index k whose tile pairs a tile with itself, where
    the tensor-core variants zero the self pair's weight."""
    if variant in ("vpu2", "vpu"):
        return _warp_rows(_exact_terms(eps2, xi, mi, xj, mj,
                                       variant == "vpu2"))
    inv = pair_inv(xi, xj, eps2)
    if self_tile is not None:
        inv[self_tile].fill_diagonal_(0.0)
    if variant == "turbo":
        w = (mj[:, None, :] * inv).to(torch.bfloat16).float()
        return tile_result(w @ position_pack(xj), xi)
    pj = mass_folded_pack(xj, mj)
    if variant == "turbo2":
        return tile_result(inv.to(torch.bfloat16).float() @ pj, xi)
    hi, lo = bf16_split(inv)
    return tile_result(hi @ pj + lo @ pj, xi)


def _phase(variant, eps2, xi, mi, xj, mj, trav, overlap, self_phase):
    """One phase of one shard: rows (nt, T, 3) / (nt, T) against the
    payload's columns, column tile by column tile in order.  Returns the
    row sums (nt, T, 3), each the sum over the column tiles from zero, and
    for a two-sided phase (``trav`` given) the travel rows (nt, T, 3):
    ``(t + aj_0) + aj_1 ...`` over the row tiles in order, or with
    ``overlap`` ``t + jacc``, jacc summed from zero."""
    nt, width = mi.shape
    both = _tile_both(variant, eps2) if trav is not None else None
    rows = torch.zeros_like(xi)
    out = []
    for j in range(nt):
        xj_t = xj[j].expand(nt, width, 3)
        mj_t = mj[j].expand(nt, width)
        if both is None:
            masked = self_phase and variant in _MASKED_SELF
            part = _tile_i(variant, eps2, xi, mi, xj_t, mj_t,
                           self_tile=j if masked else None)
        else:
            part, cols = both(xi, mi, xj_t, mj_t)
            t = torch.zeros_like(trav[j]) if overlap else trav[j]
            for i in range(nt):
                t = t + cols[i]
            out.append(trav[j] + t if overlap else t)
        rows = rows + part
    return rows, (torch.stack(out) if both is not None else None)


def rdma_ring_plain(pos: torch.Tensor, mass: torch.Tensor, p: int,
                    eps2: float, variant: str, one_sided: bool = False,
                    overlap: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of K13 on P packed shards (P*C, 3), (P*C,) ->
    (P*C, 3): the one-sided self phase (the self pair masked for the
    tensor-core variants), the payloads forwarded shard to shard, the
    two-sided phases on K2-rect's tiles, the variant's one-sided tile for
    the antipodal and the one-sided family's phases, the return hop, the
    kernel's association orders (row sums over the column tiles, then into
    the accumulator in phase order; travel rows over the row tiles, or
    ``travel + jacc`` under ``overlap``), and for vpu2 the 1/m descale with
    massless rows recomputed one-sided over all bodies.  The column chunks
    of the kernel do not change its sums and are not modelled."""
    half, d_final = ring_phases(p, one_sided)
    nt = pos.shape[0] // p // SYM_TILE
    xs = pos.view(p, nt, SYM_TILE, 3)
    ms = mass.view(p, nt, SYM_TILE)
    data = [(xs[s], ms[s]) for s in range(p)]
    trav = [torch.zeros_like(xs[s]) for s in range(p)]
    acc = [None] * p
    for d in range(d_final + 1):
        if d > 0:   # forward: shard s receives its left neighbour's payload
            data = [data[(s - 1) % p] for s in range(p)]
            trav = [trav[(s - 1) % p] for s in range(p)]
        two = 0 < d <= half
        for s in range(p):
            rows, t = _phase(variant, eps2, xs[s], ms[s], *data[s],
                             trav[s] if two else None, overlap, d == 0)
            acc[s] = rows if d == 0 else acc[s] + rows
            if two:
                trav[s] = t
    if half > 0:   # the return hop: shard s's travel goes to s - D
        acc = [acc[s] + trav[(s + d_final) % p] for s in range(p)]
    out = torch.cat([a.reshape(-1, 3) for a in acc])
    if variant in _MASS_SCALED:
        out = _k2.rect_descale_plain(out, pos, mass, pos, mass, eps2)
    return out


# -- the kernel

class _MeshFlags:
    """The flag words of the shards of one placement, kept across
    evaluations (zero when made), the epoch counter, and each card's error
    word with its mirror in pinned host memory, which the kernel writes
    with the error and the host reads without waiting for the card."""

    def __init__(self, devices):
        self.index = {}
        self.words, self.err, self.host = {}, {}, {}
        for s, d in enumerate(devices):
            self.index[s] = sum(1 for x in devices[:s] if x == d)
        for d in dict.fromkeys(devices):
            count = sum(1 for x in devices if x == d)
            self.words[d] = torch.zeros(count, FLAG_WORDS, dtype=torch.int64,
                                        device=d)
            self.err[d] = torch.zeros(1, dtype=torch.int64, device=d)
            self.host[d] = torch.zeros(1, dtype=torch.int64, pin_memory=True)
        self.epoch = 0

    def flags_ptr(self, devices, s) -> int:
        return self.words[devices[s]][self.index[s]].data_ptr()

    def failure(self, block: bool) -> "str | None":
        """The first error word set so far (after every card's queued work
        with ``block``), decoded; None while none is set."""
        for d, host in self.host.items():
            if block:
                torch.cuda.synchronize(d)
            code = int(host)
            if code:
                return (f"a {WAITS.get(code >> 8, code >> 8)} wait of shard "
                        f"{code & 0xff} on {d} ran past {SPIN_NS / 1e9:g} s "
                        f"(error word {code:#x}; the flags of the card's "
                        f"shards: {self.words[d][:, :8].tolist()})")
        return None


# One _MeshFlags a placement (the shards' devices, in order).
_FLAGS: "dict[tuple, _MeshFlags]" = {}
# Cards with peer access enabled among them (``enable_peers``).
_PEERS: "set[tuple]" = set()


def check_errors(block: bool = True) -> None:
    """Raise if a wait of an earlier K13 launch ran out (each launch also
    checks, without waiting, what has come home before it starts); the
    placement's flags are then made anew."""
    for key, flags in list(_FLAGS.items()):
        why = flags.failure(block)
        if why is not None:
            del _FLAGS[key]
            raise RuntimeError(f"rdma_ring: {why}; the launch's results are "
                               f"not the ring's")


def enable_peers(devices) -> None:
    """Enable peer access once between every pair of the CUDA cards in
    ``devices``; raises if a card cannot reach another's memory."""
    cards = tuple(sorted({torch.device(d).index for d in devices}))
    if len(cards) < 2 or cards in _PEERS:
        return
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(
                    f"rdma_ring: card {a} cannot map card {b}'s memory (no "
                    f"peer access); K13 across cards needs it")
    arr = (_c_int * len(cards))(*cards)
    rc = _build.query(torch.device("cuda", cards[0]),
                      _lib().nbt_rdma_enable_peers, arr, len(cards))
    if rc != 0:
        raise RuntimeError(f"rdma_ring: enabling peer access among cards "
                           f"{cards} failed ({rc})")
    _PEERS.add(cards)


# id(mass) -> (a weak reference to it, its version, P, which shards hold a
# body of mass 0).
_ZERO_MASS: dict = {}


def _zero_mass_shards(mass: torch.Tensor, p: int) -> "tuple[bool, ...]":
    """Which of the P shards of ``mass`` hold a body of mass 0: one host
    sync a mass tensor (and version), since masses do not change in a
    run."""
    hit = _ZERO_MASS.get(id(mass))
    if (hit is None or hit[0]() is not mass or hit[1] != mass._version
            or hit[2] != p):
        for key in [k for k, v in _ZERO_MASS.items() if v[0]() is None]:
            del _ZERO_MASS[key]
        zeros = tuple((mass.reshape(p, -1) == 0).any(1).tolist())
        hit = _ZERO_MASS[id(mass)] = (weakref.ref(mass), mass._version, p,
                                      zeros)
    return hit[3]


def _launch(pos, mass, p, eps2, variant, one_sided, overlap, slot_budget,
            phases=0, lib=None, protocol="grid", streams=1):
    """One evaluation on P packed shards on one card: one K13 launch of
    the grid-sync kernel, or with ``protocol="flags"`` of the flag kernel
    (bit-equal, and on one card slower: ``PERF.md`` §6, K13); ``phases``
    > 0 runs the first phases only, ``lib`` is another build of
    rdma_ring.cu (``bind``) in place of the package's, and ``streams`` = G
    > 1 makes the flag kernel's launch G launches on G streams of the card
    (the launches of G cards): knobs for timing the ring's parts and
    designs and for testing the cross-card launches on one card, never
    taken by the force path (the G launches take half the card between
    them, so that each finds room beside the others)."""
    if protocol == "grid":
        return _launch_grid(pos, mass, p, eps2, variant, one_sided, overlap,
                            slot_budget, phases, lib)
    c = pos.shape[0] // p
    zeros = _zero_mass_shards(mass, p) if variant in _MASS_SCALED else ()
    outs = _launch_flags(
        list(pos.view(p, c, 3)), list(mass.view(p, c)), eps2, variant,
        one_sided, overlap, slot_budget, phases, lib, streams, (pos, mass),
        zeros)
    return outs[0][1] if len(outs) == 1 else torch.cat([o for _, o in outs])


def _launch_flags(pos_l, mass_l, eps2, variant, one_sided, overlap,
                  slot_budget, phases=0, lib=None, streams=1, packed=None,
                  zeros=()):
    """The flag protocol's launches for one evaluation of shards
    ``pos_l``/``mass_l`` (C bodies each, on CUDA cards): one launch a card
    (``streams`` launches of the one card), the payload buffers of every
    shard allocated before any launch so that each launch holds every
    shard's pointers.  ``packed``: the one card's (pos, mass) that the
    shards are views of; ``zeros``: which shards hold a body of mass 0.
    Returns each launch's (shards, accelerations (G*C, 3)), its shards'
    rows in their order."""
    lib = lib or _lib()
    p, c = len(pos_l), pos_l[0].shape[0]
    devices = tuple(x.device for x in pos_l)
    plan = launch_plan(devices, one_sided)
    check_errors(block=False)
    flags = _FLAGS.get(devices)
    if flags is None:
        flags = _FLAGS[devices] = _MeshFlags(devices)
    enable_peers(devices)
    launches = plan.launches
    if streams > 1:
        if len(launches) > 1:
            raise ValueError("rdma_ring: the G-stream form is for shards "
                             "that share one card")
        card, shards = launches[0]
        k = -(-p // streams)
        launches = tuple((card, shards[i:i + k]) for i in range(0, p, k))
    # Every card's packed bodies and payload buffers first: the table of
    # every shard's pointers that each launch takes.
    cards = {}
    for d, shards in plan.launches:
        if packed is not None:
            cpos, cmass = packed
        elif len(shards) == 1:
            cpos, cmass = pos_l[shards[0]], mass_l[shards[0]]
        else:
            cpos = torch.cat([pos_l[s] for s in shards])
            cmass = torch.cat([mass_l[s] for s in shards])
        cards[d] = (cpos, cmass, cpos.new_empty(len(shards), PEER_FLOATS * c))
    table = []
    for s, d in enumerate(devices):
        cpos, cmass, peer = cards[d]
        k = flags.index[s]
        table += [cpos.data_ptr() + k * c * 12, cmass.data_ptr() + k * c * 4,
                  peer[k].data_ptr(), flags.flags_ptr(devices, s)]
    table = (_c_ll * len(table))(*table)
    readers = sum(1 << s for s, z in enumerate(zeros) if z)
    half, _ = ring_phases(p, one_sided)
    flags.epoch += 1
    outs, keep, side = [], [], []
    for d, shards in launches:
        g = len(shards)
        jcw = ring_chunk(g, c, slot_budget)
        new = pos_l[shards[0]].new_empty
        si = new(g * jcw * c * 3)
        sj = new(g * jcw * c * 3) if half > 0 else None
        raw, acc, out = new(g * c * 3), new(g * c * 3), new(g * c, 3)
        bar = torch.zeros(g, dtype=torch.int64, device=d)
        grid, coop = 0, 1
        stream = None
        if streams > 1:
            grid = max_blocks(variant, lib, d, "flags") // (
                2 * len(launches))
            coop = 0
            stream = torch.cuda.Stream(d)
            stream.wait_stream(torch.cuda.current_stream(d))
            side.append(stream)
        with torch.cuda.stream(stream):
            rdma_ring.launches += 1
            _build.launch(
                "rdma_ring", out, lib.nbt_rdma_flags, VARIANTS.index(variant),
                p, c, jcw, int(one_sided), int(overlap), int(phases),
                float(eps2), g, (_c_int * g)(*shards), table, flags.epoch,
                SPIN_NS, readers, si.data_ptr(),
                sj.data_ptr() if sj is not None else None, raw.data_ptr(),
                acc.data_ptr(), out.data_ptr(), bar.data_ptr(),
                flags.err[d].data_ptr(), flags.host[d].data_ptr(), grid,
                coop)
        outs.append((shards, out))
        if stream is not None:
            # Allocated on the card's current stream, used on the side
            # stream: kept from reuse until that stream's launch is done.
            for t in (si, sj, raw, acc, out, bar):
                if t is not None:
                    t.record_stream(stream)
            keep.append((si, sj, raw, acc, bar))
    for stream in side:
        torch.cuda.current_stream(stream.device).wait_stream(stream)
    return outs


def _launch_grid(pos, mass, p, eps2, variant, one_sided, overlap,
                 slot_budget, phases=0, lib=None):
    """One launch of the grid-sync kernel: every shard of one card, the
    hops ordered by grid syncs."""
    n = pos.shape[0]
    c = n // p
    jcw = ring_chunk(p, c, slot_budget)
    half, _ = ring_phases(p, one_sided)
    new = pos.new_empty
    dpos, dmass, trav = new(2 * n * 3), new(2 * n), new(2 * n * 3)
    si = new(p * jcw * c * 3)
    sj = new(p * jcw * c * 3) if half > 0 else None
    raw, acc, out = new(n * 3), new(n * 3), torch.empty_like(pos)
    rdma_ring.launches += 1
    _build.launch(
        "rdma_ring", pos, (lib or _lib()).nbt_rdma_ring,
        VARIANTS.index(variant), pos.data_ptr(), mass.data_ptr(), p, c, jcw,
        int(one_sided), int(overlap), int(phases), float(eps2),
        dpos.data_ptr(), dmass.data_ptr(), trav.data_ptr(), si.data_ptr(),
        sj.data_ptr() if sj is not None else None, raw.data_ptr(),
        acc.data_ptr(), out.data_ptr())
    return out


def rdma_ring(pos: torch.Tensor, mass: torch.Tensor, p: int, eps2: float,
              variant: str, one_sided: bool = False, overlap: bool = False,
              slot_budget: int = SLOT_BUDGET_BYTES) -> torch.Tensor:
    """The ring's accelerations of P packed shards, (P*C, 3), (P*C,) ->
    (P*C, 3), shard s at rows s*C, C a multiple of 256: one K13 launch
    (``variant`` one of ``VARIANTS``; ``one_sided`` for the pallas /
    pallas_turbo family, vpu and turbo), its column tiles in chunks whose
    slots fit ``slot_budget`` bytes."""
    _check(pos, mass, p, variant, one_sided)
    if pos.device.type == "cpu":
        return rdma_ring_plain(pos, mass, p, eps2, variant, one_sided,
                               overlap)
    return _launch(pos, mass, p, eps2, variant, one_sided, overlap,
                   slot_budget)


# K13 launches (one a card a force evaluation).
rdma_ring.launches = 0


def rdma_ring_sharded(pos_l, mass_l, eps2: float, variant: str,
                      one_sided: bool = False, overlap: bool = False,
                      slot_budget: int = SLOT_BUDGET_BYTES) -> list:
    """``rdma_ring`` of P shards given one tensor each, (C, 3) and (C,),
    lists in and out: across CUDA cards the flag kernel, one launch a card
    over the shards it holds (peer access enabled among the cards); on one
    card ``rdma_ring``'s grid-sync launch; on the CPU the plain twin;
    raises for shards that are not all on CUDA cards or all on the CPU."""
    kinds = {x.device.type for x in (*pos_l, *mass_l)}
    if kinds == {"cpu"} or (kinds == {"cuda"}
                            and len({x.device for x in pos_l}) == 1):
        # One device: the plain twin on the CPU, the grid-sync kernel on a
        # card.
        out = rdma_ring(torch.cat(pos_l), torch.cat(mass_l), len(pos_l),
                        eps2, variant, one_sided, overlap, slot_budget)
        return list(out.split(pos_l[0].shape[0]))
    if kinds != {"cuda"}:
        raise ValueError(
            f"comm='rdma': K13 runs shards that all lie on CUDA cards (or "
            f"its plain twin, shards that all lie on the CPU); these lie on "
            f"{sorted({str(x.device) for x in pos_l})}")
    p = len(pos_l)
    for x, m in zip(pos_l, mass_l):
        _check(x, m, 1, variant, one_sided)
        if x.shape != pos_l[0].shape or m.device != x.device:
            raise ValueError("rdma_ring: shards of one size, each shard's "
                             "pos and mass on one card")
    zeros = (tuple(_zero_mass_shards(m, 1)[0] for m in mass_l)
             if variant in _MASS_SCALED else ())
    if p > RING_MAX_SHARDS:
        raise ValueError(f"rdma_ring: at most {RING_MAX_SHARDS} shards")
    out = [None] * p
    for shards, acc in _launch_flags(pos_l, mass_l, eps2, variant, one_sided,
                                     overlap, slot_budget, zeros=zeros):
        for k, s in enumerate(shards):
            out[s] = acc[k * pos_l[0].shape[0]:(k + 1) * pos_l[0].shape[0]]
    return out


def rdma_variant(impl: str) -> "tuple[str, bool]":
    """(variant, one_sided) of an impl under ``comm="rdma"``: the sym
    ladder two-sided, the one-sided family one-sided; raises ValueError
    naming rdma for any other impl."""
    from .ring import _SYM_VARIANTS
    if impl in _SYM_VARIANTS:
        return _SYM_VARIANTS[impl], False
    if impl in _RDMA_ONE_SIDED:
        return _RDMA_ONE_SIDED[impl], True
    raise ValueError(
        f"comm='rdma' supports the pallas_sym* ladder and the one-sided "
        f"{sorted(_RDMA_ONE_SIDED)} family, got {impl!r}")


def rdma_forces_local(pos_l, mass_l, cfg: SimConfig, impl: str, comm,
                      overlap: bool = False):
    """The ring's per-shard accelerations (lists in, lists out; ``comm``
    the mesh's ``LocalComm``) through K13, one launch a card
    (``rdma_ring_sharded``)."""
    variant, one_sided = rdma_variant(impl)
    return rdma_ring_sharded(pos_l, mass_l, cfg.eps2, variant, one_sided,
                             overlap)
