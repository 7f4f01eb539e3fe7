"""K2 and K7: the Newton's-third-law exact force tiers, hand-written in
CUDA.

The counterpart of ``nbody_tpu/ops/forces_pallas_sym.py`` variant ``vpu2``
as ``_forces_sym_padded`` composes it: one-sided diagonal tiles
(``_diag_kernel_vpu``), each unordered off-diagonal tile pair once with the
shared weight ``F = m_i m_j inv`` (``_make_sym_kernel`` /
``_pair_products_sym``), row sums for the i-side and negated column sums
for the j-side, and the 1/m descale of ``_inv_mass_scale``.  The kernels
are in ``csrc/forces_sym.cu``, whose header states the enumeration, the
slot layout and the determinism contract; in short:

- bodies are cut into tiles of ``SYM_TILE``; row tile I meets column tile
  ``(I + d) mod nb`` for offsets d = 1 .. nb//2 (for even nb the last
  offset is taken by the rows I < nb/2 only), which visits every unordered
  tile pair once;
- each (I, d) writes its row sums to slot ``si[d][I]`` and its column sums
  to slot ``sj[d][J]``: every slot has one writer, so there are no atomics
  and the results are bit-reproducible;
- a reduce pass adds the slots in a fixed order (offset by offset, i-side
  before j-side), descales by 1/m and adds the one-sided diagonal tile;
- offsets run in chunks whose slots fit ``SLOT_BUDGET_BYTES``, each chunk
  folded into a running sum;
- a real body of mass 0 gets its row recomputed one-sided, because the
  mass-scaled sums cannot be descaled there.

Not ported, because they exist only for the TPU: the VMEM panels
(``_panel_layout``, and the panel pairs through which one device's large
N takes rect sweeps).  On the card one sweep covers every N whose slots
for one offset fit ``SLOT_BUDGET_BYTES`` (N_pad <= 2^31 / 24, about
89.5M bodies).

The bounded dispatch of the JAX package (``forces_pallas_sym_chunked``)
survives as a heartbeat granularity: ``sweep`` and ``rect_sweep`` (and
their twins) take ``max_prog_interactions``, cut their offset or column
chunks into programs of at most that many interactions
(``sweep_programs``, ``rect_programs``; the unit of GInter/s, two a pair)
and call ``progress(done, total, out)`` after each program.  The
launches, the slots and the reduce order are those of the unbounded
sweep, so the bounded result is bit-equal to the unbounded one.  The card
has no program kill: what the bound buys is a host that hears from a
16.7M-body force evaluation every few seconds.

K7 (``forces_sym_vpu``, ``impl="pallas_sym"``) is the counterpart of
variant ``vpu`` (``_pair_terms``, ``_accum_i_vpu``, ``_accum_j_vpu``): the
same schedule and slots, but per pair ``inv`` is computed once and each
side is weighed by the other body's mass, ``fi = m_j inv`` for the row
sums and ``fj = m_i inv`` for the negated column sums.  Nothing is
mass-scaled, so there is no descale and no one-sided recompute: a real
massless body is complete from its slots, and the diagonal is the exact
one-sided tile of K5/K6.  Its pair pass runs K2's pair tile with K7's
weights (``sym_pair_core<SYM_K7>`` in ``csrc/sym_common.cuh``: eight rows
a lane, 17 issue slots a pair): 404.2 ms at N = 1,048,576 on an H100
80GB HBM3 at 700 W, against 533.0 on the one-row-a-thread
``sym_tile_core`` it ran before.  K2's instantiation of the tile, which
K3/K4 share, keeps its code.

The wrappers take the plain PyTorch versions (``forces_sym_plain``,
``forces_sym_vpu_plain``: the same tiles, enumeration, slot layout and
reduction order) only for CPU tensors.  For a CUDA tensor they launch the
kernels or raise.  The sweep over offset chunks and slots (``sweep`` on
the card, ``sweep_plain`` in the twins) is shared with the tensor-core
tiers K5/K6/K14a-c (``ops/forces_sym_tc.py``).

K2-rect (``rect_forces_sym_vpu2``, ``rect_forces_sym_vpu``, and on the
fold schedule ``rect_forces_sym_fold`` / ``rect_forces_sym_vpu_fold``;
``_make_rect_kernel`` and ``_make_rect_kernel_fold`` behind JAX's
``rect_forces_sym``) runs K2's and K7's tiles between two disjoint body
sets A and B, the cross rotation of the Newton's-third-law ring: every
(row superblock of A, column superblock of B) once, no diagonal, the row
and column sums in one-writer slots reduced in a fixed order
(``csrc/rect_common.cuh`` states the layout), B's superblocks in chunks
of ``rect_chunks``.  Every exact sweep, classic or fold, runs the pair
tile, ``sym_pair_core`` (``csrc/sym_common.cuh``: eight rows a lane in
registers, row partials added in warp order) with K2's or K7's math,
and so do K15's vpu_* rect forms (``ops/ablation_sym.py``).  The
mass-scaled vpu2 sums are divided by m on both sides, and a real
massless body's cross sum is recomputed one-sided over the other set.
Its twins (``rect_forces_sym_plain``) share the square twins' tile
functions; ``rect_sweep`` / ``rect_sweep_plain`` are shared with the
tensor-core variants (``ops/forces_sym_tc.py``).

K14d, the fold schedule (``forces_sym_fold`` with K2's math,
``forces_sym_vpu_fold`` with K7's; ``_make_sym_kernel_fold``), runs the
same sweep on superblocks of ``block_u`` bodies (``sub = block_u / 256``
row tiles, default ``FOLD_BLOCK_U``): offsets are superblock offsets.  Where
one CTA a (superblock I, offset d) item would leave CTA slots of the card
empty (N = 8192), an item is a thread-block cluster of ``sub`` CTAs: CTA r
runs the pair tile of row tile r against each column tile and adds the
tiles' row sums in column-tile order into one i-side slot write, and the
column sums of each column tile are added across the cluster's row tiles,
in row-tile order, into one j-side slot write.  Larger launches (N =
1,048,576) take one CTA an item, which runs the row tiles in turn with the
same grouping and so gives the same bits (``FOLD_AUTO``).  The diagonal
superblocks are one-sided exact on K1's one-sided tile, and K2's math
recomputes a real massless row one-sided over all N.  The rect folds run
the same items.  Its twins are the classic twins at ``block_u`` (the
classic sweep is the fold at ``block_u = 256``), with the same grouping.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .forces_torch import rect_forces

# Tile width and threads per block (SYM_TILE in csrc/forces_sym.cu).
SYM_TILE = 256
# Device memory the i- and j-side slots of one offset chunk may take.
SLOT_BUDGET_BYTES = 2 << 30
# The fold schedule's superblock width: the JAX exact tier's block_u below
# 512k bodies; at most FOLD_SUB_MAX row tiles (csrc/forces_sym.cu).
FOLD_BLOCK_U = 1024
FOLD_SUB_MAX = 8
# How the fold passes spread their (superblock, offset) items, set with a
# library's nbt_sym_fold_mode (FoldMode in csrc/forces_sym.cu): a cluster
# of sub CTAs an item where one CTA an item would leave CTA slots of the
# card empty, else one CTA an item (auto); or either, forced.  All three
# give the same bits.
FOLD_AUTO, FOLD_CLUSTER, FOLD_CTA = 0, 1, 2

_c_ll, _c_ptr, _c_int = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
# The C entries of K2-rect (csrc/rect_common.cuh): a pair pass (pos_a,
# mass_a, na, pos_b, mass_b, nb, na_s, j_lo, jc, eps2, si, sj, stream; the
# exact tiers add sub before si) and the reduce pass.
RECT_PAIRS_ARGTYPES = [_c_ptr, _c_ptr, _c_ll, _c_ptr, _c_ptr, _c_ll, _c_ll,
                       _c_ll, _c_ll, ctypes.c_float, _c_ptr, _c_ptr, _c_ptr]
RECT_REDUCE_ARGTYPES = [_c_ptr, _c_ptr, _c_ll, _c_ptr, _c_ptr, _c_ll, _c_ll,
                        _c_ll, _c_ll, _c_ll, _c_ptr, _c_ptr, _c_ptr, _c_int,
                        _c_int, _c_int, ctypes.c_float, _c_ptr, _c_ptr,
                        _c_ptr]


def _lib():
    lib = _build.load("forces_sym")
    if lib.nbt_sym_pairs.argtypes is None:
        bind(lib)
    return lib


def bind(lib) -> None:
    """Set the argument and result types of the C entries of a
    ``forces_sym`` library (the package's, or a build of other sources with
    the same entries) and check its SYM_TILE and FOLD_SUB_MAX."""
    lib.nbt_sym_pairs.argtypes = [_c_ptr, _c_ptr, _c_ll, _c_ll, _c_ll,
                                  _c_ll, ctypes.c_float, _c_ptr, _c_ptr,
                                  _c_ptr]
    lib.nbt_sym_pairs.restype = _c_int
    lib.nbt_sym_reduce.argtypes = [_c_ptr, _c_ptr, _c_ll, _c_ll, _c_ll,
                                   _c_ll, _c_ptr, _c_ptr, _c_ptr, _c_int,
                                   _c_int, ctypes.c_float, _c_ptr,
                                   _c_ptr]
    lib.nbt_sym_reduce.restype = _c_int
    lib.nbt_sym_vpu_pairs.argtypes = lib.nbt_sym_pairs.argtypes
    lib.nbt_sym_vpu_pairs.restype = _c_int
    lib.nbt_sym_vpu_reduce.argtypes = lib.nbt_sym_reduce.argtypes
    lib.nbt_sym_vpu_reduce.restype = _c_int
    for name in ("nbt_sym_fold_pairs", "nbt_sym_vpu_fold_pairs"):
        fn = getattr(lib, name)
        fn.argtypes = [*lib.nbt_sym_pairs.argtypes[:-1], _c_int, _c_ptr]
        fn.restype = _c_int
    for name in ("nbt_sym_fold_reduce", "nbt_sym_vpu_fold_reduce"):
        fn = getattr(lib, name)
        fn.argtypes = [*lib.nbt_sym_reduce.argtypes[:-1], _c_int, _c_ptr]
        fn.restype = _c_int
    for name in ("nbt_rect_sym_pairs", "nbt_rect_sym_vpu_pairs"):
        fn = getattr(lib, name)
        fn.argtypes = RECT_PAIRS_ARGTYPES[:-3] + [_c_int] \
            + RECT_PAIRS_ARGTYPES[-3:]
        fn.restype = _c_int
    lib.nbt_rect_reduce.argtypes = RECT_REDUCE_ARGTYPES
    lib.nbt_rect_reduce.restype = _c_int
    # The folds' spread knob and their CTAs an SM (FoldMode in
    # csrc/forces_sym.cu; a build of sources before them lacks both).
    if hasattr(lib, "nbt_sym_fold_mode"):
        lib.nbt_sym_fold_mode.argtypes = [_c_int]
        lib.nbt_sym_fold_mode.restype = _c_int
        lib.nbt_sym_fold_per_sm.argtypes = [_c_int, _c_int]
        lib.nbt_sym_fold_per_sm.restype = _c_int
    lib.nbt_sym_fold_sub_max.restype = _c_int
    if _build.query(None, lib.nbt_sym_fold_sub_max) != FOLD_SUB_MAX:
        raise RuntimeError("FOLD_SUB_MAX differs between forces_sym.py "
                           "and csrc/forces_sym.cu")
    lib.nbt_sym_tile.argtypes = []
    lib.nbt_sym_tile.restype = _c_int
    if _build.query(None, lib.nbt_sym_tile) != SYM_TILE:
        raise RuntimeError("SYM_TILE differs between forces_sym.py and "
                           "csrc/forces_sym.cu")


def offset_rows(nb: int, d: int) -> int:
    """How many row tiles (I = 0 .. k-1) take offset ``d``: all of them,
    except the half offset d = nb/2 of an even nb."""
    return nb // 2 if 2 * d == nb else nb


def tile_pairs(nb: int) -> "list[tuple[int, int]]":
    """The (row tile, column tile) pairs the sweep visits, in launch
    order: every unordered off-diagonal pair of ``nb`` tiles once."""
    return [(i, (i + d) % nb) for d in range(1, nb // 2 + 1)
            for i in range(offset_rows(nb, d))]


def offset_chunks(nb: int, n_pad: int,
                  budget: int = SLOT_BUDGET_BYTES) -> "list[tuple[int, int]]":
    """Split the offsets 1 .. nb//2 into (first offset, count) chunks whose
    two (count, n_pad, 3) float32 slot arrays fit ``budget`` bytes."""
    n_off = nb // 2
    per_offset = 2 * n_pad * 3 * 4
    if n_off and per_offset > budget:
        raise ValueError(
            f"forces_sym: one offset's slots need {per_offset} bytes, more "
            f"than the {budget}-byte budget (N_pad={n_pad})")
    step = max(1, budget // per_offset)
    return [(lo, min(step, n_off - lo + 1))
            for lo in range(1, n_off + 1, step)]


def program_groups(costs, cap: "float | None") -> "list[tuple[int, int]]":
    """Cut a run of launches with these interaction counts into programs:
    (start, stop) ranges of consecutive launches of at most ``cap``
    interactions each, a launch above ``cap`` a program of its own; one
    program when ``cap`` is None."""
    if cap is None:
        return [(0, len(costs))]
    groups, start, total = [], 0, 0.0
    for k, c in enumerate(costs):
        if k > start and total + c > cap:
            groups.append((start, k))
            start, total = k, 0.0
        total += c
    groups.append((start, len(costs)))
    return groups


def sweep_programs(n: int, cap: "float | None", width: int = SYM_TILE,
                   slot_budget: int = SLOT_BUDGET_BYTES):
    """The plan of a square sweep over ``n`` bodies in tiles of ``width``:
    its offset chunks and their programs under ``cap`` interactions
    (``program_groups``).  A chunk's interactions are two a pair of its
    tile pairs; the last chunk's reduce also adds the diagonal tiles."""
    nb = -(-n // width)
    chunks = offset_chunks(nb, nb * width, slot_budget) or [(1, 0)]
    costs = [2.0 * width * width
             * sum(offset_rows(nb, d) for d in range(lo, lo + dc))
             for lo, dc in chunks]
    costs[-1] += float(nb * width * width)
    return chunks, program_groups(costs, cap)


def sweep_plain(pos: torch.Tensor, mass: torch.Tensor, slot_budget: int,
                pair_tiles, width: int = SYM_TILE, progress=None,
                max_prog_interactions: "float | None" = None):
    """The plain twins' sweep, shared by K2, K7, K5/K6/K14a-c and the fold
    schedule: the bodies padded to whole tiles of ``width``, every
    off-diagonal tile pair visited by offset with ``pair_tiles(x_rows,
    m_rows, x_cols, m_cols) -> (row sums, column sums)``, each (k, width,
    3), written to the slots and the slots summed in the kernels' order.
    Returns the padded tiles (nb, width, 3), (nb, width) and the slot sums
    (n_pad, 3).  ``progress`` and ``max_prog_interactions``: the
    kernels' program plan (``sweep``)."""
    tile = width
    n = pos.shape[0]
    nb = -(-n // tile)
    n_pad = nb * tile
    pos_p = torch.cat([pos, pos.new_zeros(n_pad - n, 3)])
    mass_p = torch.cat([mass, mass.new_zeros(n_pad - n)])
    pt, mt = pos_p.view(nb, tile, 3), mass_p.view(nb, tile)
    raw = pos_p.new_zeros(n_pad, 3)
    chunks, groups = sweep_programs(n, max_prog_interactions, tile,
                                    slot_budget)
    for g, (lo, hi) in enumerate(groups):
        for d_lo, dc in chunks[lo:hi]:
            si = pos_p.new_zeros(dc, nb, tile, 3)
            sj = pos_p.new_zeros(dc, nb, tile, 3)
            for dk in range(dc):
                rows = torch.arange(offset_rows(nb, d_lo + dk),
                                    device=pos.device)
                cols = (rows + d_lo + dk) % nb
                si[dk, rows], sj[dk, cols] = pair_tiles(
                    pt[rows], mt[rows], pt[cols], mt[cols])
            for dk in range(dc):
                raw = raw + si[dk].view(n_pad, 3)
                raw = raw + sj[dk].view(n_pad, 3)
        if progress is not None:
            progress(g + 1, len(groups), raw)
    return pt, mt, raw


def diag_plain(pt: torch.Tensor, mt: torch.Tensor,
               eps2: float) -> torch.Tensor:
    """The diagonal tiles, one-sided with m_j weights: (nb, T, 3), (nb, T)
    -> (nb * T, 3)."""
    r = pt[:, None, :, :] - pt[:, :, None, :]
    d2 = (r * r).sum(-1) + eps2
    f = mt[:, None, :] * torch.rsqrt(d2 * d2 * d2)
    return (f[..., None] * r).sum(2).view(-1, 3)


def descale_plain(pt: torch.Tensor, mt: torch.Tensor, raw: torch.Tensor,
                  pos: torch.Tensor, mass: torch.Tensor,
                  eps2: float) -> torch.Tensor:
    """The accelerations from mass-scaled slot sums (K2, turbof): the
    diagonal tiles plus the sums times 1/m, and the rows of real bodies of
    mass 0, whose sums cannot be descaled, recomputed one-sided."""
    mass_p = mt.flatten()
    inv_m = torch.where(mass_p != 0, 1.0 / mass_p, torch.zeros_like(mass_p))
    acc = (diag_plain(pt, mt, eps2) + raw * inv_m[:, None])[:pos.shape[0]]
    zero = torch.nonzero(mass == 0).flatten()
    if zero.numel():
        acc[zero] = rect_forces(pos[zero], pos, mass, eps2)
    return acc


# Pairs the twins' tile functions compute at once: items beyond it are
# taken in groups (the sums do not depend on the grouping).
_TWIN_PAIRS = 1 << 22


def _pair_tiles(eps2: float, k7: bool, sub: int):
    """The exact pair tiles of K2 (``k7=False``: F = m_i m_j inv on both
    sides, mass-scaled) or K7 (fi = m_j inv, fj = m_i inv) over tiles of
    ``sub`` row and column tiles, grouped as the kernels group them: row
    sums over each 256-column tile, added across the column tiles in order;
    column sums over each 256-row tile, added across the row tiles in
    order, negated."""
    def one_group(xi, mi, xj, mj):
        r = xj[:, None, :, :] - xi[:, :, None, :]
        d2 = (r * r).sum(-1) + eps2
        inv = torch.rsqrt(d2 * d2 * d2)
        if k7:
            pi = (mj[:, None, :] * inv)[..., None] * r
            pj = (mi[:, :, None] * inv)[..., None] * r
        else:
            pi = pj = ((mi[:, :, None] * mj[:, None, :]) * inv)[..., None] * r
        k, u = pj.shape[:2]
        rows = pi.view(k, u, sub, u // sub, 3).sum(3)
        cols = pj.view(k, sub, u // sub, u, 3).sum(2)
        row, fold = rows[:, :, 0], cols[:, 0]
        for tile in range(1, sub):
            row = row + rows[:, :, tile]
            fold = fold + cols[:, tile]
        return row, -fold

    def pair_tiles(xi, mi, xj, mj):
        step = max(1, _TWIN_PAIRS // (xi.shape[1] * xj.shape[1]))
        if xi.shape[0] <= step:
            return one_group(xi, mi, xj, mj)
        parts = [one_group(xi[g:g + step], mi[g:g + step], xj[g:g + step],
                           mj[g:g + step])
                 for g in range(0, xi.shape[0], step)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    return pair_tiles


def forces_sym_plain(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                     slot_budget: int = SLOT_BUDGET_BYTES,
                     block_u: int = SYM_TILE, progress=None,
                     max_prog_interactions: "float | None" = None
                     ) -> torch.Tensor:
    """Plain PyTorch twin of K2 (``block_u = 256``) and of its fold
    schedule, with the kernels' tiles, enumeration, slot layout, fold and
    reduction order (summation within a tile differs)."""
    pt, mt, raw = sweep_plain(pos, mass, slot_budget,
                              _pair_tiles(eps2, False, block_u // SYM_TILE),
                              block_u, progress, max_prog_interactions)
    return descale_plain(pt, mt, raw, pos, mass, eps2)


def forces_sym_vpu_plain(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                         slot_budget: int = SLOT_BUDGET_BYTES,
                         block_u: int = SYM_TILE, progress=None,
                         max_prog_interactions: "float | None" = None
                         ) -> torch.Tensor:
    """Plain PyTorch twin of K7 (``block_u = 256``) and of its fold
    schedule, with K2's tiles, enumeration, slot layout and reduction
    order: the slot sums plus the exact diagonal tiles, no descale."""
    pt, mt, raw = sweep_plain(pos, mass, slot_budget,
                              _pair_tiles(eps2, True, block_u // SYM_TILE),
                              block_u, progress, max_prog_interactions)
    return (diag_plain(pt, mt, eps2) + raw)[:pos.shape[0]]


def sweep(what: str, pos: torch.Tensor, mass: torch.Tensor, eps2: float,
          slot_budget: int, pairs, reduce, width: int = SYM_TILE,
          extra: tuple = (), progress=None,
          max_prog_interactions: "float | None" = None) -> torch.Tensor:
    """Launch a pair-symmetric sweep on the card, shared by K2, K7,
    K5/K6/K14a-c and the fold schedule (``width`` its superblock, ``extra``
    its row-tile count): per offset chunk, ``pairs(pos, mass, n, nb, d_lo,
    dc, eps2, si, sj, *extra, stream)`` and ``reduce(pos, mass, n, nb,
    d_lo, dc, si, sj, raw, first, last, eps2, out, *extra, stream)`` (the C
    entries, pointers as ints).  With ``max_prog_interactions`` the chunks
    run in programs of at most that many interactions
    (``sweep_programs``), and ``progress(done, total, out)`` is called
    after each program's launches are queued."""
    n = pos.shape[0]
    nb = -(-n // width)
    n_pad = nb * width
    chunks, groups = sweep_programs(n, max_prog_interactions, width,
                                    slot_budget)
    out = torch.empty_like(pos)
    slot_len = max(dc for _, dc in chunks) * n_pad * 3
    si = pos.new_empty(slot_len)
    sj = pos.new_empty(slot_len)
    raw = pos.new_empty(n_pad * 3) if len(chunks) > 1 else None
    raw_ptr = raw.data_ptr() if raw is not None else None
    eps2 = float(eps2)
    for g, (lo, hi) in enumerate(groups):
        for k in range(lo, hi):
            d_lo, dc = chunks[k]
            _build.launch(f"{what} pairs", pos, pairs, pos.data_ptr(),
                          mass.data_ptr(), n, nb, d_lo, dc, eps2,
                          si.data_ptr(), sj.data_ptr(), *extra)
            _build.launch(f"{what} reduce", pos, reduce, pos.data_ptr(),
                          mass.data_ptr(), n, nb, d_lo, dc, si.data_ptr(),
                          sj.data_ptr(), raw_ptr, int(k == 0),
                          int(k == len(chunks) - 1), eps2, out.data_ptr(),
                          *extra)
        if progress is not None:
            progress(g + 1, len(groups), out)
    return out


def forces_sym(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
               slot_budget: int = SLOT_BUDGET_BYTES, progress=None,
               max_prog_interactions: "float | None" = None) -> torch.Tensor:
    """Softened all-pairs accelerations (N,3),(N,) -> (N,3) through K2,
    each pair computed once (``progress``, ``max_prog_interactions``: the
    bounded dispatch of ``sweep``)."""
    _build.check_bodies("forces_sym", pos, mass)
    if pos.device.type == "cpu":
        return forces_sym_plain(pos, mass, eps2, slot_budget,
                                progress=progress,
                                max_prog_interactions=max_prog_interactions)
    lib = _lib()
    forces_sym.launches += 1
    return sweep("forces_sym", pos, mass, eps2, slot_budget,
                 lib.nbt_sym_pairs, lib.nbt_sym_reduce, progress=progress,
                 max_prog_interactions=max_prog_interactions)


def forces_sym_vpu(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                   slot_budget: int = SLOT_BUDGET_BYTES, progress=None,
                   max_prog_interactions: "float | None" = None
                   ) -> torch.Tensor:
    """Softened all-pairs accelerations (N,3),(N,) -> (N,3) through K7
    (``impl="pallas_sym"``), each pair computed once."""
    _build.check_bodies("forces_sym_vpu", pos, mass)
    if pos.device.type == "cpu":
        return forces_sym_vpu_plain(
            pos, mass, eps2, slot_budget, progress=progress,
            max_prog_interactions=max_prog_interactions)
    lib = _lib()
    forces_sym_vpu.launches += 1
    return sweep("forces_sym_vpu", pos, mass, eps2, slot_budget,
                 lib.nbt_sym_vpu_pairs, lib.nbt_sym_vpu_reduce,
                 progress=progress,
                 max_prog_interactions=max_prog_interactions)


def _fold_sub(block_u: int) -> int:
    """The row tiles of a fold superblock of ``block_u`` bodies; raises
    unless it is a whole number of tiles, 1 .. FOLD_SUB_MAX."""
    sub, rem = divmod(block_u, SYM_TILE)
    if rem or not 1 <= sub <= FOLD_SUB_MAX:
        raise ValueError(
            f"fold: block_u must be a multiple of {SYM_TILE} up to "
            f"{FOLD_SUB_MAX * SYM_TILE}, got {block_u}")
    return sub


def _fold(what: str, k7: bool, pos, mass, eps2, block_u, slot_budget,
          progress, max_prog_interactions):
    sub = _fold_sub(block_u)
    _build.check_bodies(what, pos, mass)
    plain = forces_sym_vpu_plain if k7 else forces_sym_plain
    if pos.device.type == "cpu":
        return plain(pos, mass, eps2, slot_budget, block_u, progress,
                     max_prog_interactions)
    lib = _lib()
    prefix = "nbt_sym_vpu_fold" if k7 else "nbt_sym_fold"
    _FOLD_COUNTERS[k7].launches += 1
    return sweep(what, pos, mass, eps2, slot_budget,
                 getattr(lib, f"{prefix}_pairs"),
                 getattr(lib, f"{prefix}_reduce"), block_u, (sub,),
                 progress, max_prog_interactions)


def forces_sym_fold(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                    block_u: int = FOLD_BLOCK_U,
                    slot_budget: int = SLOT_BUDGET_BYTES, progress=None,
                    max_prog_interactions: "float | None" = None
                    ) -> torch.Tensor:
    """Softened all-pairs accelerations (N,3),(N,) -> (N,3) through K14d
    with K2's math (``variant="vpu2", schedule="fold"``)."""
    return _fold("forces_sym_fold", False, pos, mass, eps2, block_u,
                 slot_budget, progress, max_prog_interactions)


def forces_sym_vpu_fold(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                        block_u: int = FOLD_BLOCK_U,
                        slot_budget: int = SLOT_BUDGET_BYTES, progress=None,
                        max_prog_interactions: "float | None" = None
                        ) -> torch.Tensor:
    """Softened all-pairs accelerations (N,3),(N,) -> (N,3) through K14d
    with K7's math (``variant="vpu", schedule="fold"``)."""
    return _fold("forces_sym_vpu_fold", True, pos, mass, eps2, block_u,
                 slot_budget, progress, max_prog_interactions)


# Force evaluations that launched the kernels: K2, K7, and K14d with K2's
# and with K7's math.
forces_sym.launches = 0
forces_sym_vpu.launches = 0
forces_sym_fold.launches = 0
forces_sym_vpu_fold.launches = 0
_FOLD_COUNTERS = {False: forces_sym_fold, True: forces_sym_vpu_fold}


# -- K2-rect: the rect sweep between two disjoint body sets

def rect_chunks(na_pad: int, nb_s: int,
                budget: int = SLOT_BUDGET_BYTES) -> "list[tuple[int, int]]":
    """Split B's ``nb_s`` column superblocks into (first, count) chunks
    whose slots (a row slot of A's ``na_pad`` bodies and a column slot of
    one superblock per row superblock: 2 * na_pad * 3 float32 a column
    superblock) fit ``budget`` bytes."""
    per = 2 * na_pad * 3 * 4
    if per > budget:
        raise ValueError(
            f"rect_forces_sym: one column superblock's slots need {per} "
            f"bytes, more than the {budget}-byte budget (na_pad={na_pad})")
    step = budget // per
    return [(lo, min(step, nb_s - lo)) for lo in range(0, nb_s, step)]


def rect_programs(na: int, nb: int, cap: "float | None",
                  width: int = SYM_TILE, slot_budget: int = SLOT_BUDGET_BYTES):
    """The plan of a rect sweep of ``na`` x ``nb`` bodies: B's column
    chunks (``rect_chunks``) and their programs under ``cap``
    interactions, two a pair of A's padded rows and a chunk's columns."""
    na_pad, nb_s = -(-na // width) * width, -(-nb // width)
    chunks = rect_chunks(na_pad, nb_s, slot_budget)
    return chunks, program_groups(
        [2.0 * na_pad * jc * width for _, jc in chunks], cap)


def _pad_tiles(pos, mass, width):
    n = pos.shape[0]
    k = -(-n // width)
    pos_p = torch.cat([pos, pos.new_zeros(k * width - n, 3)])
    mass_p = torch.cat([mass, mass.new_zeros(k * width - n)])
    return pos_p.view(k, width, 3), mass_p.view(k, width)


def rect_sweep_plain(pos_a, mass_a, pos_b, mass_b, slot_budget, pair_tiles,
                     width: int = SYM_TILE, progress=None,
                     max_prog_interactions: "float | None" = None):
    """The plain twins' rect sweep, shared by every K2-rect variant: A and
    B padded to superblocks of ``width``, every (IA, JB) superblock pair
    visited once with ``pair_tiles(x_rows, m_rows, x_cols, m_cols) -> (row
    sums, column sums)`` (the square sweep's tile functions), the row sums
    written to slot [JB][IA] and the column sums to slot [IA][JB] of a
    column chunk, and the slots summed in the kernels' order: for A, the
    column superblocks in order into a running sum; for B, the row
    superblocks in order.  Returns the raw sums (na, 3), (nb, 3).
    ``progress`` and ``max_prog_interactions``: the kernels' program plan
    (``rect_sweep``)."""
    na, nb = pos_a.shape[0], pos_b.shape[0]
    pa, ma = _pad_tiles(pos_a, mass_a, width)
    pb, mb = _pad_tiles(pos_b, mass_b, width)
    na_s = pa.shape[0]
    na_pad = na_s * width
    raw_a = pos_a.new_zeros(na_pad, 3)
    raw_b = []
    chunks, groups = rect_programs(na, nb, max_prog_interactions, width,
                                   slot_budget)
    for g, (lo, hi) in enumerate(groups):
        for j_lo, jc in chunks[lo:hi]:
            si = pos_a.new_zeros(jc, na_s, width, 3)
            sj = pos_a.new_zeros(na_s, jc, width, 3)
            for jk in range(jc):
                xj = pb[j_lo + jk].expand(na_s, width, 3)
                mj = mb[j_lo + jk].expand(na_s, width)
                si[jk], sj[:, jk] = pair_tiles(pa, ma, xj, mj)
            for jk in range(jc):
                raw_a = raw_a + si[jk].view(na_pad, 3)
            col = sj[0]
            for ia in range(1, na_s):
                col = col + sj[ia]
            raw_b.append(col.reshape(-1, 3))
        if progress is not None:
            progress(g + 1, len(groups), raw_a)
    return raw_a[:na], torch.cat(raw_b)[:nb]


def rect_descale_plain(raw, pos, mass, pos_o, mass_o, eps2):
    """The cross accelerations from mass-scaled sums (vpu2, turbof): the
    sums times 1/m, and the rows of real bodies of mass 0 recomputed
    one-sided over the other set."""
    inv_m = torch.where(mass != 0, 1.0 / mass, torch.zeros_like(mass))
    acc = raw * inv_m[:, None]
    zero = torch.nonzero(mass == 0).flatten()
    if zero.numel():
        acc[zero] = rect_forces(pos[zero], pos_o, mass_o, eps2)
    return acc


def rect_forces_sym_plain(pos_a, mass_a, pos_b, mass_b, eps2: float,
                          k7: bool = False, block_u: int = SYM_TILE,
                          slot_budget: int = SLOT_BUDGET_BYTES,
                          progress=None,
                          max_prog_interactions: "float | None" = None):
    """Plain PyTorch twin of K2-rect with K2's math (``k7=False``,
    variant vpu2) or K7's (variant vpu), classic (``block_u = 256``) or
    fold: the kernels' superblocks, enumeration, slot layout, fold and
    reduction order.  The classic vpu2 kernel runs K2's pair tile
    (``sym_pair_core``), whose twin is K2's square twin's tile: the sum
    within a tile differs (the kernel adds its row partials in warp
    order), so the two agree at the exact tolerance, not bit for bit.
    Returns (acc_a, acc_b)."""
    raw_a, raw_b = rect_sweep_plain(
        pos_a, mass_a, pos_b, mass_b, slot_budget,
        _pair_tiles(eps2, k7, block_u // SYM_TILE), block_u, progress,
        max_prog_interactions)
    if k7:
        return raw_a, raw_b
    return (rect_descale_plain(raw_a, pos_a, mass_a, pos_b, mass_b, eps2),
            rect_descale_plain(raw_b, pos_b, mass_b, pos_a, mass_a, eps2))


def rect_sweep(what, pos_a, mass_a, pos_b, mass_b, eps2, slot_budget,
               pairs, reduce, descale, width=SYM_TILE, extra=(),
               progress=None, max_prog_interactions=None):
    """Launch a K2-rect sweep on the card, shared by every variant: per
    column chunk ``pairs(pos_a, mass_a, na, pos_b, mass_b, nb, na_s, j_lo,
    jc, eps2, *extra, si, sj, stream)`` and ``reduce`` (the C entries,
    pointers as ints).  With ``max_prog_interactions`` the chunks run in
    programs (``rect_programs``) and ``progress(done, total, acc_a)`` is
    called after each.  Returns (acc_a, acc_b)."""
    na, nb = pos_a.shape[0], pos_b.shape[0]
    na_s = -(-na // width)
    na_pad = na_s * width
    chunks, groups = rect_programs(na, nb, max_prog_interactions, width,
                                   slot_budget)
    acc_a, acc_b = torch.empty_like(pos_a), torch.empty_like(pos_b)
    slot_len = max(jc for _, jc in chunks) * na_pad * 3
    si, sj = pos_a.new_empty(slot_len), pos_a.new_empty(slot_len)
    raw = pos_a.new_empty(na_pad * 3) if len(chunks) > 1 else None
    raw_ptr = raw.data_ptr() if raw is not None else None
    ptrs = (pos_a.data_ptr(), mass_a.data_ptr(), na, pos_b.data_ptr(),
            mass_b.data_ptr(), nb, na_s)
    eps2 = float(eps2)
    for g, (lo, hi) in enumerate(groups):
        for k in range(lo, hi):
            j_lo, jc = chunks[k]
            _build.launch(f"{what} pairs", pos_a, pairs, *ptrs, j_lo, jc,
                          eps2, *extra, si.data_ptr(), sj.data_ptr())
            _build.launch(f"{what} reduce", pos_a, reduce, *ptrs, width,
                          j_lo, jc, si.data_ptr(), sj.data_ptr(), raw_ptr,
                          int(k == 0), int(k == len(chunks) - 1),
                          int(descale), eps2, acc_a.data_ptr(),
                          acc_b.data_ptr())
        if progress is not None:
            progress(g + 1, len(groups), acc_a)
    return acc_a, acc_b


def check_rect_sets(what, pos_a, mass_a, pos_b, mass_b) -> None:
    """The rect wrappers' contract: both sets pass ``check_bodies`` on one
    device."""
    _build.check_bodies(what, pos_a, mass_a)
    _build.check_bodies(what, pos_b, mass_b)
    if pos_a.device != pos_b.device:
        raise ValueError(f"{what}: set A on {pos_a.device}, set B on "
                         f"{pos_b.device}")


def _rect(k7: bool, pos_a, mass_a, pos_b, mass_b, eps2, block_u,
          slot_budget, progress, max_prog_interactions):
    sub = _fold_sub(block_u)
    counter = _RECT_COUNTERS[k7, sub > 1]
    check_rect_sets(counter.__name__, pos_a, mass_a, pos_b, mass_b)
    if pos_a.device.type == "cpu":
        return rect_forces_sym_plain(pos_a, mass_a, pos_b, mass_b, eps2, k7,
                                     block_u, slot_budget, progress,
                                     max_prog_interactions)
    lib = _lib()
    counter.launches += 1
    return rect_sweep(
        counter.__name__, pos_a, mass_a, pos_b, mass_b, eps2, slot_budget,
        lib.nbt_rect_sym_vpu_pairs if k7 else lib.nbt_rect_sym_pairs,
        lib.nbt_rect_reduce, not k7, block_u, (sub,), progress,
        max_prog_interactions)


def rect_forces_sym_vpu2(pos_a, mass_a, pos_b, mass_b, eps2: float,
                         slot_budget: int = SLOT_BUDGET_BYTES, progress=None,
                         max_prog_interactions: "float | None" = None):
    """Cross accelerations of two disjoint body sets through K2-rect with
    K2's math (variant vpu2): (na,3),(na,),(nb,3),(nb,) -> (acc_a, acc_b),
    each A x B pair computed once (``progress``,
    ``max_prog_interactions``: the bounded dispatch of ``rect_sweep``)."""
    return _rect(False, pos_a, mass_a, pos_b, mass_b, eps2, SYM_TILE,
                 slot_budget, progress, max_prog_interactions)


def rect_forces_sym_vpu(pos_a, mass_a, pos_b, mass_b, eps2: float,
                        slot_budget: int = SLOT_BUDGET_BYTES, progress=None,
                        max_prog_interactions: "float | None" = None):
    """K2-rect with K7's math (variant vpu)."""
    return _rect(True, pos_a, mass_a, pos_b, mass_b, eps2, SYM_TILE,
                 slot_budget, progress, max_prog_interactions)


def rect_forces_sym_fold(pos_a, mass_a, pos_b, mass_b, eps2: float,
                         block_u: int = FOLD_BLOCK_U,
                         slot_budget: int = SLOT_BUDGET_BYTES, progress=None,
                         max_prog_interactions: "float | None" = None):
    """K2-rect on the fold schedule with K2's math (variant vpu2, A's rows
    in superblocks of ``block_u``; ``len(pos_a)`` a multiple of it)."""
    return _rect(False, pos_a, mass_a, pos_b, mass_b, eps2, block_u,
                 slot_budget, progress, max_prog_interactions)


def rect_forces_sym_vpu_fold(pos_a, mass_a, pos_b, mass_b, eps2: float,
                             block_u: int = FOLD_BLOCK_U,
                             slot_budget: int = SLOT_BUDGET_BYTES,
                             progress=None,
                             max_prog_interactions: "float | None" = None):
    """K2-rect on the fold schedule with K7's math (variant vpu)."""
    return _rect(True, pos_a, mass_a, pos_b, mass_b, eps2, block_u,
                 slot_budget, progress, max_prog_interactions)


# Rect sweeps that launched K2-rect: classic and fold, K2's and K7's math.
rect_forces_sym_vpu2.launches = 0
rect_forces_sym_vpu.launches = 0
rect_forces_sym_fold.launches = 0
rect_forces_sym_vpu_fold.launches = 0
_RECT_COUNTERS = {(False, False): rect_forces_sym_vpu2,
                  (True, False): rect_forces_sym_vpu,
                  (False, True): rect_forces_sym_fold,
                  (True, True): rect_forces_sym_vpu_fold}
