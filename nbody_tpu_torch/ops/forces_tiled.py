"""K1 and K11: the one-sided exact force tiles, hand-written in CUDA for
Hopper.

K1 is the counterpart of ``nbody_tpu/ops/forces_pallas.py`` variant
``vpu`` (``_force_kernel_vpu``): ``acc_i = sum_j m_j r_ij
rsqrt((|r_ij|^2+eps2)^3)`` with no i != j guard (the self-pair vanishes by
r = 0).  The kernel is ``csrc/forces_tiled.cu``: row blocks of
``K1_BLOCK_ROWS`` rows (four a lane) against j slices of whole
``K1_TILE``-body tiles (``k1_slices``), each tile's contribution summed
from zero and added to the slice's sum, the slices' sums added in slice
order by a second launch; the ragged j edge is masked as zero-mass
bodies.  K11 (variant ``vpu_kahan``, ``_force_kernel_vpu_kahan``,
``impl="pallas_kahan"``) takes K1's work items, slice plan and pair loop
whole: each tile's contribution enters the slice's running sum through a
Kahan two-sum with a carried compensation, each slice writes its sum and
its compensation, and the second launch merges the slices in slice order:
their sums by an exact two-sum, whose errors are carried with the slices'
compensations and folded in once (``csrc/forces_tiled.cu`` states the
form).  With one slice (N = 1M) the result is the sweep's compensated sum
as JAX's kernel returns it.  On an H100 80GB HBM3 at 700 W an evaluation
takes 552.6 ms at N = 1,048,576 and 0.0453 ms of the card's time at 8192,
against 688.3 and 0.2023 on the one-thread-a-row design before it.

The wrappers take the plain PyTorch version (``rect_forces_tiled_plain``,
the same tiles, slices and order) only for tensors on the CPU.  For a CUDA
tensor they launch the kernel or raise.  Each kernel counts its force
evaluations on its own wrapper: ``forces_tiled.launches`` (K1, whose
slot reduce is a second launch of the same evaluation) and
``forces_tiled_kahan.launches`` (K11).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# The j-tile width (K1_TILE in csrc/forces_tiled.cu; K11's block width) and
# K1's rows a block (K1_BLOCK_ROWS).
K1_TILE = 128
K1_BLOCK_ROWS = 512
# K1's work items wanted an evaluation: about two waves of the eight
# 128-thread blocks an SM that an H100's 132 SMs hold at once (1024 and
# 512 were slower on the 262,144² sweep, tools/k1_ring_variants.py).
K1_ITEMS = 2048
# Bytes K1's slice slots may take.
K1_SLOT_BUDGET = 1 << 30

_c_ll, _c_ptr, _c_int = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument types on a build of forces_tiled.cu
    (the package's, or a copy that tools/k1_ring_variants.py edits)."""
    if lib.nbt_forces_tiled.argtypes is None:
        lib.nbt_forces_tiled.argtypes = [
            _c_ptr, _c_ll, _c_ptr, _c_ptr, _c_ll, _c_ll, _c_int,
            ctypes.c_float, _c_ptr, _c_ptr, _c_ptr]
        lib.nbt_forces_tiled_kahan.argtypes = lib.nbt_forces_tiled.argtypes
        lib.nbt_forces_tiled_geometry.argtypes = [_c_int]
        for fn in (lib.nbt_forces_tiled, lib.nbt_forces_tiled_kahan,
                   lib.nbt_forces_tiled_geometry):
            fn.restype = ctypes.c_int
        if (_build.query(None, lib.nbt_forces_tiled_geometry, 0),
                _build.query(None, lib.nbt_forces_tiled_geometry, 1)) != (
                    K1_TILE, K1_BLOCK_ROWS):
            raise RuntimeError("K1_TILE / K1_BLOCK_ROWS differ between "
                               "forces_tiled.py and csrc/forces_tiled.cu")
    return lib


def _lib():
    return bind(_build.load("forces_tiled"))


def slice_plan(ni: int, nj: int, tile: int, block_rows: int, items: int,
               slot_bytes: int, slices: "int | None" = None
               ) -> "tuple[int, int]":
    """(slices, tiles a slice) of a one-sided sweep in (row block, j slice)
    work items, rows in blocks of ``block_rows``, the j-set in tiles of
    ``tile`` bodies: ``slices`` if given, else as many as bring the items
    (row blocks x slices) to ``items``, at least one and at most one a
    tile, within ``K1_SLOT_BUDGET`` at ``slot_bytes`` a row and slice; the
    tiles split evenly, the last slice the shortest."""
    tiles = max(1, -(-nj // tile))
    if slices is None:
        row_blocks = max(1, -(-ni // block_rows))
        slices = min(-(-items // row_blocks),
                     K1_SLOT_BUDGET // max(1, ni * slot_bytes))
    tps = -(-tiles // max(1, min(tiles, slices)))
    return -(-tiles // tps), tps


def k1_slices(ni: int, nj: int, slices: "int | None" = None,
              kahan: bool = False) -> "tuple[int, int]":
    """(slices, tiles a slice) of K1's (``kahan``: K11's, whose slots hold
    a sum and a compensation) j-set (``slice_plan``)."""
    return slice_plan(ni, nj, K1_TILE, K1_BLOCK_ROWS, K1_ITEMS,
                      24 if kahan else 12, slices)


def kahan_add(s: torch.Tensor, c: torch.Tensor,
              t: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """s + t with the carried compensation c, a Kahan two-sum (the
    kernel's kahan_add; the value is s - c): returns the new (s, c)."""
    y = t - c
    u = s + y
    return u, (u - s) - y


def two_sum(a: torch.Tensor,
            b: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """(s, e) with a + b = s + e exactly (Knuth's two-sum, the kernel's
    two_sum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def rect_forces_tiled_plain(pos_i: torch.Tensor, pos_j: torch.Tensor,
                            mass_j: torch.Tensor, eps2: float,
                            kahan: bool = False,
                            slices: "int | None" = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernels: the j-set swept in tiles of
    ``K1_TILE`` bodies, the last tile padded with zero-mass bodies at the
    origin, in slices of whole tiles (``k1_slices``; ``slices`` overrides
    the count).  K1: each tile's (Ni,3) contribution added to its slice's
    sum, the slices' sums added in slice order.  K11 (``kahan``): each
    tile's contribution Kahan-added into its slice's (s, c); one slice
    gives s, more are merged in slice order, the sums by an exact two-sum
    whose errors are carried with the slices' c, folded in once (S - C)."""
    tile = K1_TILE
    nj = pos_j.shape[0]
    nj_pad = -(-nj // tile) * tile
    pos_j = torch.cat([pos_j, pos_j.new_zeros(nj_pad - nj, 3)])
    mass_j = torch.cat([mass_j, mass_j.new_zeros(nj_pad - nj)])

    def contrib(s):
        r = pos_j[None, s:s + tile, :] - pos_i[:, None, :]   # (Ni, T, 3)
        d2 = (r * r).sum(-1) + eps2
        f = mass_j[None, s:s + tile] * torch.rsqrt(d2 * d2 * d2)
        return (f[:, :, None] * r).sum(1)

    n_slices, tps = k1_slices(pos_i.shape[0], nj, slices, kahan)
    acc = comp = None
    for k in range(n_slices):
        part = c = torch.zeros_like(pos_i)
        for s in range(k * tps * tile, min((k + 1) * tps * tile, nj_pad),
                       tile):
            if kahan:
                part, c = kahan_add(part, c, contrib(s))
            else:
                part = part + contrib(s)
        if acc is None:
            acc, comp = part, c
        elif kahan:
            acc, e = two_sum(acc, part)
            comp = (comp + c) - e
        else:
            acc = acc + part
    return acc - comp if kahan and n_slices > 1 else acc


def sweep(lib, pos_i: torch.Tensor, pos_j: torch.Tensor,
          mass_j: torch.Tensor, eps2: float, kahan: bool) -> torch.Tensor:
    """One evaluation of K1 or K11 (``kahan``) through ``lib`` (the
    package's build of forces_tiled.cu, or another's: ``bind``), without
    the wrappers' checks and counters; raises if the launch fails."""
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    acc = torch.empty_like(pos_i)
    slices, tps = k1_slices(ni, nj, kahan=kahan)
    slots = (pos_i.new_empty((2 if kahan else 1) * slices * ni * 3)
             if slices > 1 else None)
    entry = lib.nbt_forces_tiled_kahan if kahan else lib.nbt_forces_tiled
    _build.launch("forces_tiled_kahan" if kahan else "forces_tiled", acc,
                  entry, pos_i.data_ptr(), ni, pos_j.data_ptr(),
                  mass_j.data_ptr(), nj, tps, slices, float(eps2),
                  slots.data_ptr() if slots is not None else None,
                  acc.data_ptr())
    return acc


def _launch(pos_i, pos_j, mass_j, eps2, kahan, lib=None):
    """One evaluation of K1 or K11 (``kahan``) on the card, or the twin for
    CPU tensors; ``lib`` another build of forces_tiled.cu (``bind``) in
    place of the package's, for the timing tools."""
    what = "forces_tiled_kahan" if kahan else "forces_tiled"
    _build.check_rect(what, pos_i, pos_j, mass_j)
    if pos_i.device.type == "cpu":
        return rect_forces_tiled_plain(pos_i, pos_j, mass_j, eps2, kahan)
    lib = lib or _lib()
    if kahan:
        forces_tiled_kahan.launches += 1
    else:
        forces_tiled.launches += 1
    return sweep(lib, pos_i, pos_j, mass_j, eps2, kahan)


def forces_tiled(pos: torch.Tensor, mass: torch.Tensor,
                 eps2: float) -> torch.Tensor:
    """Softened all-pairs accelerations (N,3),(N,) -> (N,3) through K1."""
    return _launch(pos, pos, mass, eps2, False)


def rect_forces_tiled(pos_i: torch.Tensor, pos_j: torch.Tensor,
                      mass_j: torch.Tensor, eps2: float) -> torch.Tensor:
    """Forces of body set j on body set i through K1:
    (Ni,3),(Nj,3),(Nj,) -> (Ni,3).  No self-pair mask is needed: a body
    present in both sets meets itself at r = 0."""
    return _launch(pos_i, pos_j, mass_j, eps2, False)


def forces_tiled_kahan(pos: torch.Tensor, mass: torch.Tensor,
                       eps2: float) -> torch.Tensor:
    """Softened all-pairs accelerations (N,3),(N,) -> (N,3) through K11
    (``impl="pallas_kahan"``)."""
    return _launch(pos, pos, mass, eps2, True)


def rect_forces_tiled_kahan(pos_i: torch.Tensor, pos_j: torch.Tensor,
                            mass_j: torch.Tensor,
                            eps2: float) -> torch.Tensor:
    """Forces of body set j on body set i through K11, the ring's form:
    (Ni,3),(Nj,3),(Nj,) -> (Ni,3)."""
    return _launch(pos_i, pos_j, mass_j, eps2, True)


# Force evaluations launched through the wrappers (both entry points
# each): K1, K11.
forces_tiled.launches = 0
forces_tiled_kahan.launches = 0
