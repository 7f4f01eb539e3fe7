"""K15: the bench-only ablations of the pair-symmetric tiles, hand-written
in CUDA for Hopper.

The counterpart of ``nbody_tpu/ops/ablation_sym.py`` (``_make_tri``, the
triangular sweep, and ``_make_rect``, the panel pair, both over the tile
``_tile``): measurement kernels that price one mechanism each of K7's
exact tile (``vpu_*``) and K5's tensor-core tile (``tmm_*``).  Four of
the seven compute wrong physics on purpose:

==========  ============================================  ============  ========
name        tile (off-diagonal)                           physics       control
==========  ============================================  ============  ========
vpu_noj     K7's, row sums only                           j half        vpu (K7)
                                                          dropped
vpu_fix0    K7's, every column sum added into tile 0      wrong         vpu (K7)
vpu_rc      K7's, differences recomputed per component    exact (= K7)  vpu (K7)
tmm_full    K5's                                          = K5          turbo
tmm_noscat  K5's, every column sum added into tile 0      wrong         turbo
tmm_noj     K5's i-side product only                      j half        turbo
                                                          dropped
tmm_nomm    K5's pair terms and both bf16 roundings, no   wrong         turbo
            mma: each row gets sum bf16(m_j inv) +
            sum bf16(m_i inv) in all three components
==========  ============================================  ============  ========

Every form ablates the tile its control runs.  The ``tmm_*`` forms ablate
K5's tile, on the trimmed geometry (``pair_inv_fma``,
``csrc/sym_tc_tile.cuh``: ``tc_trimmed``): ``tmm_noj``'s row sums are K5's
bit for bit, and ``tmm_nomm`` builds K5's two weight registers by K5's
roundings; their twins are K5's twin's row half and the sums of its bf16
weights (``forces_sym_tc._pair_tiles``, ``_turbo_weights``), so that the
two cannot drift apart.

The ``vpu_*`` forms ablate K7, on K2's pair tile (``sym_pair_core``,
``csrc/sym_common.cuh``: eight rows a lane, one column accumulator rotating
around the warp), and K7 itself is their control: ``vpu_noj`` is K7's row
side alone, so its row sums are K7's bit for bit (its twin is K7's twin's
row half); ``vpu_rc`` takes the differences again for its six
accumulating FMAs, so its results are K7's bit for bit (its twin's are
K7's twin's); and ``vpu_fix0`` is K7's tile with its column sums stored in
the writer's own slot; in the rect sweep that is K2-rect vpu's kernel
itself, and only fix0's reduce is its own.  ``CONTROLS`` names each form's
control (the variant it is timed against and, under
``control_occupancy()``, pinned to).

As in the JAX package, the diagonal tiles stay exact and one-sided for
all seven forms, nothing is mass-scaled, and the names are reachable only
after ``enable()``: it registers the wrappers with the variant entry points
(``ops/forces_sym_variants.py``: ``forces_pallas_sym(variant=...)`` and
``rect_forces_sym(variant=...)``, classic schedule only) and adds the
names to ``SYM_VARIANTS``.  No impl, ``auto``, ``SimConfig`` or CLI verb
reaches them.

The kernels run K2's schedule (``ops/forces_sym.py``): 256-wide tiles,
the offsets of ``tile_pairs``, one writer per slot, offsets (rect: column
superblocks) in chunks of the slot budget, and a fixed-order reduce.
``tmm_full`` is K5's pair pass itself (the JAX control rebuilt the j
positions from the transposed tile, which the card's K5 never needed),
and with K5's reduce bit-equal to K5.  ``vpu_fix0`` and ``tmm_noscat``
cannot add into one slot in grid order as JAX does: each CTA keeps its
own slot and the reduce adds all of them, per offset, into tile 0's
bodies (``csrc/forces_sym.cu`` states the order), so results are
bit-reproducible and chunk-invariant.  The C entries are in
``csrc/forces_sym.cu`` (``vpu_*`` and the none / fix0 reduce passes) and
``csrc/forces_sym_tc.cu`` (``tmm_*``).

The wrappers take the plain twins (``forces_sym_ablation_plain``,
``rect_forces_sym_ablation_plain``: the kernels' tiles, enumeration, slot
layout and reduction order, but for the order of fix0's sum into tile 0)
only for CPU tensors; for a CUDA tensor they
launch the kernels or raise.  Each form counts its launches on its own
wrapper: ``SYM_WRAPPERS[name].launches`` (``forces_sym_<name>``) and
``RECT_WRAPPERS[name].launches`` (``rect_forces_sym_<name>``).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _build
from . import forces_sym as _k2
from . import forces_sym_tc as _ktc
from . import forces_sym_variants as _variants
from .forces_sym import (RECT_PAIRS_ARGTYPES, RECT_REDUCE_ARGTYPES,
                         SLOT_BUDGET_BYTES, SYM_TILE, check_rect_sets,
                         diag_plain, rect_sweep, rect_sweep_plain, sweep,
                         sweep_plain)

ABLATION_NAMES = ("vpu_noj", "vpu_fix0", "vpu_rc",
                  "tmm_full", "tmm_noscat", "tmm_noj", "tmm_nomm")
# Each ablation's control, a variant of forces_pallas_sym: K7 ("vpu") for
# the vpu_* forms, K5 ("turbo") for the tmm_* forms.
CONTROLS = {n: "vpu" if n.startswith("vpu_") else "turbo"
            for n in ABLATION_NAMES}
# How each one's column sums reach the bodies: through K7's / K5's slot sum
# ("slots"), not at all ("none"), or all into tile 0 ("fix0").
J_MODE = {"vpu_noj": "none", "vpu_fix0": "fix0", "vpu_rc": "slots",
          "tmm_full": "slots", "tmm_noscat": "fix0", "tmm_noj": "none",
          "tmm_nomm": "none"}


def _pair_tiles(eps2: float, name: str):
    """The plain tile of ablation ``name``: (k, T, 3) x (k, T, 3) -> row
    sums, column sums (k, T, 3), as the kernel's tile computes them."""
    k7 = _k2._pair_tiles(eps2, True, 1)

    def pair_tiles(xi, mi, xj, mj):
        if name == "vpu_fix0":
            return k7(xi, mi, xj, mj)
        if name in ("tmm_full", "tmm_noscat"):
            return _ktc._pair_tiles(xi, mi, xj, mj, eps2, "turbo")
        none = xi.new_zeros(xj.shape)
        # vpu_noj on K7's twin and tmm_noj and tmm_nomm on K5's: their row
        # halves, and the sums of K5's bf16 weights (on pair_inv_fma, as
        # the kernels).
        if name == "vpu_noj":
            return k7(xi, mi, xj, mj)[0], none
        if name == "tmm_noj":
            return _ktc._pair_tiles(xi, mi, xj, mj, eps2, "turbo")[0], none
        if name == "tmm_nomm":
            wi, wj = _ktc._turbo_weights(xi, mi, xj, mj, eps2)
            return (wi.sum(2) + wj.sum(2))[..., None].expand(-1, -1, 3), none
        # vpu_rc: the differences again for the accumulate.
        r = xj[:, None, :, :] - xi[:, :, None, :]
        d2 = (r * r).sum(-1) + eps2
        inv = torch.rsqrt(d2 * d2 * d2)
        fi = (mj[:, None, :] * inv)[..., None]
        fj = (mi[:, :, None] * inv)[..., None]
        r = xj[:, None, :, :] - xi[:, :, None, :]
        return (fi * r).sum(2), -(fj * r).sum(1)
    return pair_tiles


def _fix0_tiles(eps2: float, name: str):
    """The plain tile of ablation ``name`` for the shared sweeps, and a
    list of what it adds to tile 0 (B's superblock 0).  For ``fix0`` the
    tile hands the sweep no column sums and appends each visit's, summed
    over its row tiles, to the list; for the others the list stays empty.
    The twins are held to the kernels at a tolerance, so the order of that
    sum need not be the reduce's."""
    tiles = _pair_tiles(eps2, name)
    tile0 = []
    if J_MODE[name] != "fix0":
        return tiles, tile0

    def pair_tiles(xi, mi, xj, mj):
        rows, cols = tiles(xi, mi, xj, mj)
        tile0.append(cols.sum(0))
        return rows, torch.zeros_like(cols)
    return pair_tiles, tile0


def forces_sym_ablation_plain(pos: torch.Tensor, mass: torch.Tensor,
                              eps2: float, name: str,
                              slot_budget: int = SLOT_BUDGET_BYTES,
                              progress=None, max_prog_interactions=None
                              ) -> torch.Tensor:
    """Plain PyTorch twin of K15's triangular sweep for ablation ``name``:
    the kernels' tiles, enumeration, slot layout and reduction order (but
    for fix0's sum into tile 0), the slot sums plus the exact one-sided
    diagonal tiles."""
    pair_tiles, tile0 = _fix0_tiles(eps2, name)
    pt, mt, raw = sweep_plain(pos, mass, slot_budget, pair_tiles,
                              progress=progress,
                              max_prog_interactions=max_prog_interactions)
    for cols in tile0:
        raw[:SYM_TILE] += cols
    return (diag_plain(pt, mt, eps2) + raw)[:pos.shape[0]]


def rect_forces_sym_ablation_plain(pos_a, mass_a, pos_b, mass_b, eps2: float,
                                   name: str,
                                   slot_budget: int = SLOT_BUDGET_BYTES,
                                   progress=None, max_prog_interactions=None):
    """Plain PyTorch twin of K15's rect sweep for ablation ``name``.
    Returns (acc_a, acc_b)."""
    pair_tiles, tile0 = _fix0_tiles(eps2, name)
    acc_a, acc_b = rect_sweep_plain(
        pos_a, mass_a, pos_b, mass_b, slot_budget, pair_tiles,
        progress=progress, max_prog_interactions=max_prog_interactions)
    head = acc_b[:SYM_TILE]
    for cols in tile0:
        head += cols[:head.shape[0]]
    return acc_a, acc_b


def _entries(name: str):
    """The C entries of ablation ``name``: (square pairs, square reduce,
    rect pairs, rect reduce), argtypes set."""
    sym = _k2._lib()
    lib = _ktc._lib() if name.startswith("tmm_") else sym
    pairs = getattr(lib, f"nbt_sym_{name}_pairs")
    rect_pairs = getattr(lib, f"nbt_rect_{name}_pairs")
    if pairs.argtypes is None:
        pairs.argtypes = sym.nbt_sym_pairs.argtypes
        rect_pairs.argtypes = RECT_PAIRS_ARGTYPES
        pairs.restype = rect_pairs.restype = ctypes.c_int
        for kind in ("noj", "fix0"):
            fn = getattr(sym, f"nbt_sym_{kind}_reduce")
            fn.argtypes = sym.nbt_sym_reduce.argtypes
            fn.restype = ctypes.c_int
            fn = getattr(sym, f"nbt_rect_{kind}_reduce")
            fn.argtypes = RECT_REDUCE_ARGTYPES
            fn.restype = ctypes.c_int
    mode = J_MODE[name]
    if mode == "slots":
        reduce = (lib.nbt_sym_tc_reduce if lib is not sym
                  else sym.nbt_sym_vpu_reduce)
        rect_reduce = (lib.nbt_rect_tc_reduce if lib is not sym
                       else sym.nbt_rect_reduce)
    else:
        kind = "noj" if mode == "none" else "fix0"
        reduce = getattr(sym, f"nbt_sym_{kind}_reduce")
        rect_reduce = getattr(sym, f"nbt_rect_{kind}_reduce")
    return pairs, reduce, rect_pairs, rect_reduce


def _check(name: str) -> None:
    if name not in ABLATION_NAMES:
        raise ValueError(f"ablation must be one of {ABLATION_NAMES}, got "
                         f"{name!r}")


def forces_sym_ablation(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                        name: str, slot_budget: int = SLOT_BUDGET_BYTES,
                        progress=None, max_prog_interactions=None
                        ) -> torch.Tensor:
    """(N,3),(N,) -> (N,3) through K15's triangular sweep for ablation
    ``name``."""
    _check(name)
    counter = SYM_WRAPPERS[name]
    _build.check_bodies(counter.__name__, pos, mass)
    if pos.device.type == "cpu":
        return forces_sym_ablation_plain(pos, mass, eps2, name, slot_budget,
                                         progress, max_prog_interactions)
    pairs, reduce = _entries(name)[:2]
    counter.launches += 1
    return sweep(counter.__name__, pos, mass, eps2, slot_budget, pairs,
                 reduce, progress=progress,
                 max_prog_interactions=max_prog_interactions)


def rect_forces_sym_ablation(pos_a, mass_a, pos_b, mass_b, eps2: float,
                             name: str, slot_budget: int = SLOT_BUDGET_BYTES,
                             progress=None, max_prog_interactions=None):
    """(na,3),(na,),(nb,3),(nb,) -> (acc_a, acc_b) through K15's rect
    sweep for ablation ``name``, each A x B pair computed once."""
    _check(name)
    counter = RECT_WRAPPERS[name]
    check_rect_sets(counter.__name__, pos_a, mass_a, pos_b, mass_b)
    if pos_a.device.type == "cpu":
        return rect_forces_sym_ablation_plain(
            pos_a, mass_a, pos_b, mass_b, eps2, name, slot_budget, progress,
            max_prog_interactions)
    pairs, reduce = _entries(name)[2:]
    counter.launches += 1
    return rect_sweep(counter.__name__, pos_a, mass_a, pos_b, mass_b, eps2,
                      slot_budget, pairs, reduce, False, progress=progress,
                      max_prog_interactions=max_prog_interactions)


def _wrapper(name: str, rect: bool):
    if rect:
        def wrapper(pos_a, mass_a, pos_b, mass_b, eps2: float,
                    slot_budget: int = SLOT_BUDGET_BYTES, progress=None,
                    max_prog_interactions=None):
            return rect_forces_sym_ablation(pos_a, mass_a, pos_b, mass_b,
                                            eps2, name, slot_budget,
                                            progress, max_prog_interactions)
    else:
        def wrapper(pos, mass, eps2: float,
                    slot_budget: int = SLOT_BUDGET_BYTES, progress=None,
                    max_prog_interactions=None):
            return forces_sym_ablation(pos, mass, eps2, name, slot_budget,
                                       progress, max_prog_interactions)
    kind = "rect_forces_sym" if rect else "forces_sym"
    wrapper.__name__ = wrapper.__qualname__ = f"{kind}_{name}"
    wrapper.__doc__ = f"K15 {'rect' if rect else 'triangular'} sweep, {name}."
    wrapper.launches = 0
    return wrapper


# One wrapper and launch counter a form, by name: the triangular sweep
# (``forces_sym_<name>``) and the rect sweep (``rect_forces_sym_<name>``).
SYM_WRAPPERS = {n: _wrapper(n, False) for n in ABLATION_NAMES}
RECT_WRAPPERS = {n: _wrapper(n, True) for n in ABLATION_NAMES}


# The triangular sweep's pair kernels by their ids in SymMath
# (csrc/sym_common.cuh) and SymTcVariant (csrc/sym_tc_tile.cuh): the
# controls K7 ("vpu") and K5 ("turbo"), and the seven ablations.
_PAIRS_ID = {"vpu": 1, "vpu_noj": 2, "vpu_fix0": 3, "vpu_rc": 4,
             "turbo": 0, "tmm_full": 5, "tmm_noscat": 6, "tmm_noj": 7,
             "tmm_nomm": 8}


def ctas_per_sm(device="cuda") -> "dict[str, int]":
    """The CTAs per SM of the triangular sweep's pair kernels of the
    controls (K7 "vpu", K5 "turbo") and the seven ablations, as they
    launch now (the occupancy ``device``'s card computes)."""
    sym, tc = _k2._lib(), _ktc._lib()
    return {name: _build.query(device, sym.nbt_sym_pairs_ctas
                               if name.startswith("vpu")
                               else tc.nbt_sym_tc_pairs_ctas, i)
            for name, i in _PAIRS_ID.items()}


@contextlib.contextmanager
def control_occupancy():
    """While open, the triangular sweep's ablation pair kernels run at
    their control's CTAs per SM (``CONTROLS``: K7's for the vpu_* forms,
    K5's for tmm_*): each launch reserves the least dynamic shared memory
    that brings it there, and no kernel reads it.  A knob for timing the
    split only: an ablation with fewer registers than its control fits
    more CTAs on an SM, and would price that with the mechanism it
    removes.  Raises if a form cannot be brought to its control's
    count."""
    pins = (_k2._lib().nbt_sym_abl_pin, _ktc._lib().nbt_sym_tc_abl_pin)
    try:
        for pin in pins:
            if _build.query("cuda", pin, 1) < 0:
                raise RuntimeError(
                    f"{pin.__name__}: no dynamic shared memory brings every "
                    f"ablation to its control's CTAs per SM")
        yield
    finally:
        for pin in pins:
            _build.query("cuda", pin, 0)


def enable() -> None:
    """Register the ablation kernels with the variant entry points and
    make the names dispatchable through ``forces_pallas_sym(variant=...)``
    and ``rect_forces_sym(variant=...)``; calling it again changes
    nothing."""
    _variants.ABLATION_SYM_KERNELS.update(SYM_WRAPPERS)
    _variants.ABLATION_RECT_KERNELS.update(RECT_WRAPPERS)
    _variants.SYM_VARIANTS = _variants.SYM_VARIANTS + tuple(
        n for n in ABLATION_NAMES if n not in _variants.SYM_VARIANTS)
