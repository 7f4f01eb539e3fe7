"""K13: the fused ring, one cooperative launch per force evaluation over
every shard on the card, as ``nbody_tpu/parallel/rdma_ring.py``.

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

Here every shard lies on one card and one launch (``csrc/rdma_ring.cu``)
runs the ring of all P shards: the payloads are copied from shard to
shard in device memory between grid syncs, and each travel partial is
added into its home shard's accumulator.  The acks, the barrier
semaphore, ``collective_id`` and the DMA semaphores of the JAX kernel do
not survive: a grid sync orders a slot's writer before its reader on one
card.  Across cards the hop needs peer access or one process per card
(ROADMAP Queue 1 item 14); the wrapper raises if the shards lie on more
than one device, and never falls back to the ppermute ring.

``comm="rdma_overlap"`` is JAX's ``overlap=True``: the data of the next
hop is copied under the current hop's compute, the j side of a hop sums
into a private ``jacc`` from zero and is folded in as ``travel + jacc``
once the travel rows (one hop behind) have arrived.  The results differ
from the sequential protocol at rounding only.

The mass-scaled ``vpu2`` sums are divided by the body's mass after the
return hop; a real body of mass 0 gets its row recomputed one-sided over
all bodies, where JAX's ``_inv_mass_scale`` gives it an acceleration of
exactly 0 (ROADMAP Queue 3).

The port's shards are whole 256-body tiles (``parallel/ring.py``,
``shard_padding``): ``--block-i/-j/-u`` are accepted and do not change
K13's tiles, so JAX's gcd clamp of its blocks has no counterpart.

``rdma_ring`` launches the kernel for a CUDA tensor (counted on
``rdma_ring.launches``) or raises, and takes the plain PyTorch twin
``rdma_ring_plain`` (the same phases, slots, tiles and association orders)
only for a CPU tensor.  ``rdma_forces_local`` is the per-shard entry point
of the sharded step loop (lists in, lists out).
"""

from __future__ import annotations

import ctypes

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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument types on a build of rdma_ring.cu (the
    package's, an earlier one, or a copy that tools/k1_ring_variants.py
    edits)."""
    if lib.nbt_rdma_ring.argtypes is None:
        lib.nbt_rdma_ring.argtypes = [
            _c_int, _c_ptr, _c_ptr, _c_ll, _c_ll, _c_ll, _c_int, _c_int,
            _c_int, ctypes.c_float, *[_c_ptr] * 8, _c_ptr]
        lib.nbt_rdma_ring.restype = _c_int
        lib.nbt_rdma_ring_max_blocks.argtypes = [_c_int]
        lib.nbt_rdma_ring_max_blocks.restype = _c_int
        lib.nbt_rdma_ring_tile.argtypes = []
        lib.nbt_rdma_ring_tile.restype = _c_int
        if lib.nbt_rdma_ring_tile() != SYM_TILE:
            raise RuntimeError("SYM_TILE differs between forces_sym.py and "
                               "csrc/rdma_ring.cu")
    return lib


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


def max_blocks(variant: str, lib=None) -> int:
    """The co-resident CTAs of the variant's kernel: its cooperative grid
    on this card (``lib`` another build, as ``_launch`` takes it)."""
    return (lib or _lib()).nbt_rdma_ring_max_blocks(VARIANTS.index(variant))


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

def _launch(pos, mass, p, eps2, variant, one_sided, overlap, slot_budget,
            phases=0, lib=None):
    """One K13 launch; ``phases`` > 0 runs the first phases only and
    ``lib`` is another build of rdma_ring.cu (``bind``) in place of the
    package's: knobs for timing the ring's parts and its designs, never
    taken by the force path."""
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
    _build.check_launch("rdma_ring", (lib or _lib()).nbt_rdma_ring(
        VARIANTS.index(variant), pos.data_ptr(), mass.data_ptr(), p, c, jcw,
        int(one_sided), int(overlap), int(phases), float(eps2),
        dpos.data_ptr(), dmass.data_ptr(), trav.data_ptr(), si.data_ptr(),
        sj.data_ptr() if sj is not None else None, raw.data_ptr(),
        acc.data_ptr(), out.data_ptr(), _build.stream_handle(pos)))
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


# Force evaluations that launched K13.
rdma_ring.launches = 0


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
    the mesh's ``LocalComm``) through one K13 launch over every shard.
    Raises unless every shard lies on one device."""
    variant, one_sided = rdma_variant(impl)
    devices = {x.device for x in pos_l}
    if len(devices) > 1:
        raise ValueError(
            f"comm='rdma': K13 runs the ring of shards that lie on one card; "
            f"these lie on {sorted(map(str, devices))}.  The hop between "
            f"cards needs peer access or one process per card (ROADMAP "
            f"Queue 1 item 14)")
    out = rdma_ring(torch.cat(pos_l), torch.cat(mass_l), comm.axis_size,
                    cfg.eps2, variant, one_sided, overlap)
    return list(out.split(pos_l[0].shape[0]))
