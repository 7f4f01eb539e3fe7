"""K12: the one-sided ``fast`` tier, centred distances and the accumulation
both on the tensor cores, hand-written in CUDA for Hopper.

The counterpart of ``nbody_tpu/ops/forces_pallas.py`` variant ``fast``
(``_force_kernel_fast`` with ``split_f=True``).  Per j-tile of
``FAST_TILE_J`` bodies, with ``c`` the tile's centroid (the zero-mass
ghosts that pad the last tile included, as the JAX package's ``mean``
includes them), ``u = x_i - c`` and ``v = x_j - c``:

- ``cross = u . v`` is one bf16 product of the K=18 packs
  ``[uh um ul uh uh um]`` and ``[vh vh vh vm vl vm]`` of the 3-limb bf16
  splits (``_pack_u18`` / ``_pack_v18``), summed in float32: the six limb
  products that keep ~24 bits of ``u . v``;
- ``d2 = (|u|^2 + eps2) - 2 cross + |v|^2``, clamped at ``eps2``;
  where it falls below ``CLOSE_PAIR_SCALE`` of ``|u|^2 + eps2 + |v|^2``,
  the direct ``|x_j - x_i|^2 + eps2`` in its place;
- ``f = m_j rsqrt(d2^3)``, the self-pair masked by index, split into bf16
  hi/lo limbs and multiplied with the tile's position pack, the per-tile
  correction ``sum f x_j - x_i sum f`` turning the product into an
  acceleration (K10's accumulation, ``ops/forces_tiled_tc.py``).

The centred expansion cancels: its float32 error, about 2^-21 (|u|^2 +
|v|^2), grows with the tile's extent, so the bodies should be
Morton-sorted (``models/ordering.py``, ``run --sort-every``).  A pair
closer than that error comes out at the eps2 clamp in the JAX kernel, its
force up to ~1e7 times too large, and every run from the uniform box then
blows up within tens of steps (ROADMAP Queue 3); the direct distance for
such pairs is the port's repair, which leaves every other pair as JAX
computes it.  The tile width sets the centroids, so kernel and twin use
one width, and the tests compare with the JAX package at ``block_j =
FAST_TILE_J``.

The kernel is ``csrc/forces_fast.cu`` (packs, mma and correction from
``csrc/tc_common.cuh``): a prologue writes each j-tile's centroid and
packs once an evaluation, blocks of ``FAST_ROWS`` rows stream them, and
at small N the j-tiles are cut into ``j_splits`` ranges whose partial
sums are added in range order.  The twin follows the same tiles and
ranges, so the two sum alike.  The wrappers take the plain PyTorch
version only for CPU tensors; for a CUDA tensor they launch the kernel or
raise.  Launches are counted on ``forces_fast.launches``, one an
evaluation.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .forces_tiled_tc import bf16_split, position_pack, tile_result

# j-tile width: one centroid and one correction a tile (FAST_TILE_J in
# csrc/forces_fast.cu).
FAST_TILE_J = 128
# i-rows of one block of the kernel (FAST_ROWS in csrc/forces_fast.cu).
FAST_ROWS = 256
# Blocks the kernel aims for when it splits the j range: two blocks of
# FAST_ROWS rows on each of an H100's 132 SMs.
FAST_TARGET_BLOCKS = 264
# A pair whose centred d2 is below this fraction of |u|^2 + eps2 + |v|^2
# (where the centred value has lost ~10 of its bits) takes the direct
# d2 = |x_j - x_i|^2 + eps2 (CLOSE_PAIR_SCALE in the kernel).
CLOSE_PAIR_SCALE = 2.0 ** -11

_c_ll, _c_ptr, _c_int = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("forces_fast")
    fn = lib.nbt_forces_fast
    if fn.argtypes is None:
        fn.argtypes = [_c_ptr, _c_ll, _c_ptr, _c_ptr, _c_ll, ctypes.c_float,
                       _c_int, _c_ll, _c_ll, _c_ptr, _c_ptr, _c_ptr, _c_ptr]
        fn.restype = _c_int
        for name in ("nbt_fast_tile", "nbt_fast_rows", "nbt_fast_tile_bytes"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _c_int
        if (_build.query(None, lib.nbt_fast_tile),
                _build.query(None, lib.nbt_fast_rows)) != (FAST_TILE_J,
                                                           FAST_ROWS):
            raise RuntimeError("FAST_TILE_J or FAST_ROWS differs between "
                               "forces_fast.py and csrc/forces_fast.cu")
    return lib


def j_splits(ni: int, nj: int) -> "tuple[int, int]":
    """(ranges, j-tiles a range): how the kernel and its twin cut the
    j-tiles of an (Ni, Nj) evaluation, from the shapes alone.  One range
    when the row blocks fill ``FAST_TARGET_BLOCKS``; otherwise enough
    ranges of whole tiles to come close, each range's partial sums added
    in range order."""
    n_tiles = max(1, -(-nj // FAST_TILE_J))
    row_blocks = max(1, -(-ni // FAST_ROWS))
    want = min(n_tiles, -(-FAST_TARGET_BLOCKS // row_blocks))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def bf16_split3(x: torch.Tensor):
    """hi + mid + lo bf16 limbs of x (~24 bits), as float32 tensors."""
    hi = x.to(torch.bfloat16).float()
    r1 = x - hi
    mid = r1.to(torch.bfloat16).float()
    return hi, mid, (r1 - mid).to(torch.bfloat16).float()


def pack_u18(u: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 18): [uh um ul uh uh um], ``_pack_u18``."""
    uh, um, ul = bf16_split3(u)
    return torch.cat([uh, um, ul, uh, uh, um], -1)


def pack_v18(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 18): [vh vh vh vm vl vm], ``_pack_v18``."""
    vh, vm, vl = bf16_split3(v)
    return torch.cat([vh, vh, vh, vm, vl, vm], -1)


def _j_tiles(pos_j: torch.Tensor, mass_j: torch.Tensor):
    """(start, positions, masses) of each j-tile of ``FAST_TILE_J``
    bodies, the last padded with zero-mass bodies at the origin."""
    tile = FAST_TILE_J
    nj = pos_j.shape[0]
    nj_pad = -(-nj // tile) * tile
    pos_j = torch.cat([pos_j, pos_j.new_zeros(nj_pad - nj, 3)])
    mass_j = torch.cat([mass_j, mass_j.new_zeros(nj_pad - nj)])
    for s in range(0, nj_pad, tile):
        yield s, pos_j[s:s + tile], mass_j[s:s + tile]


def _tile_d2(pos_i: torch.Tensor, xj: torch.Tensor, eps2: float):
    """(d2, close) of rows ``pos_i`` against one j-tile: the centred d2
    from the K=18 cross product, with the direct |x_j - x_i|^2 + eps2
    where it falls below the close-pair test (``close``), unclamped.  The
    test adds the row's threshold ``CLOSE_PAIR_SCALE (|u|^2 + eps2)`` to
    the column's ``CLOSE_PAIR_SCALE |v|^2``: a power of two apart from
    their sum, so it is ``CLOSE_PAIR_SCALE (|u|^2 + eps2 + |v|^2)`` to
    the bit."""
    c = xj.mean(0)
    u, v = pos_i - c, xj - c
    un2 = u[:, 0] * u[:, 0] + u[:, 1] * u[:, 1] + u[:, 2] * u[:, 2]
    vn2 = v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1] + v[:, 2] * v[:, 2]
    cross = pack_u18(u) @ pack_v18(v).T                      # (Ni, T)
    un2e = un2[:, None] + eps2
    d2 = un2e - (cross + cross) + vn2[None, :]
    r = xj[None, :, :] - pos_i[:, None, :]
    direct = (r * r).sum(-1) + eps2
    close = d2 < un2e * CLOSE_PAIR_SCALE + vn2[None, :] * CLOSE_PAIR_SCALE
    return torch.where(close, direct, d2), close


def rect_forces_fast_plain(pos_i: torch.Tensor, pos_j: torch.Tensor,
                           mass_j: torch.Tensor, eps2: float,
                           self_tile: bool) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: j-tiles of ``FAST_TILE_J`` bodies
    (the last padded with zero-mass bodies at the origin), the centred
    K=18 cross product, the direct d2 for close pairs, d2 clamped at eps2,
    the self-pair masked by index when ``self_tile`` (on the tiles that
    overlap the i-set, the only ones that hold one), the hi/lo weights
    times the tile's position pack and the correction per tile, summed
    tile by tile within each of the ``j_splits`` ranges and then range by
    range."""
    ni = pos_i.shape[0]
    rows = torch.arange(ni, device=pos_i.device)[:, None]
    per = j_splits(ni, pos_j.shape[0])[1]
    acc = part = None
    for s, xj, mj in _j_tiles(pos_j, mass_j):
        d2 = torch.clamp(_tile_d2(pos_i, xj, eps2)[0], min=eps2)
        f = mj[None, :] * torch.rsqrt(d2 * d2 * d2)
        if self_tile and s < ni:
            cols = torch.arange(s, s + FAST_TILE_J,
                                device=pos_i.device)[None, :]
            f = torch.where(rows == cols, torch.zeros_like(f), f)
        pack = position_pack(xj)
        hi, lo = bf16_split(f)
        r = tile_result(hi @ pack + lo @ pack, pos_i)
        part = r if part is None else part + r
        if (s // FAST_TILE_J + 1) % per == 0:
            acc = part if acc is None else acc + part
            part = None
    if part is not None:
        acc = part if acc is None else acc + part
    return acc if acc is not None else torch.zeros_like(pos_i)


def close_pairs(pos_i: torch.Tensor, pos_j: torch.Tensor,
                mass_j: torch.Tensor, eps2: float) -> torch.Tensor:
    """(Ni, Nj) bool: the pairs whose centred d2 falls below the close-pair
    test, so that kernel and twin take the direct distance for them (the
    self-pairs of a square form among them; their force is masked)."""
    return torch.cat([_tile_d2(pos_i, xj, eps2)[1]
                      for _, xj, _ in _j_tiles(pos_j, mass_j)],
                     1)[:, :pos_j.shape[0]]


def _launch(pos_i, pos_j, mass_j, eps2, self_tile):
    _build.check_rect("forces_fast", pos_i, pos_j, mass_j, self_tile)
    if pos_i.device.type == "cpu":
        return rect_forces_fast_plain(pos_i, pos_j, mass_j, eps2, self_tile)
    lib = _lib()
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    splits, per = j_splits(ni, nj)
    n_tiles = max(1, -(-nj // FAST_TILE_J))
    tiles = torch.empty(n_tiles * _build.query(None, lib.nbt_fast_tile_bytes),
                        dtype=torch.uint8, device=pos_i.device)
    part = pos_i.new_empty(splits * ni * 3) if splits > 1 else None
    acc = torch.empty_like(pos_i)
    forces_fast.launches += 1
    _build.launch("forces_fast", acc, lib.nbt_forces_fast, pos_i.data_ptr(),
                  ni, pos_j.data_ptr(), mass_j.data_ptr(), nj, float(eps2),
                  int(self_tile), splits, per, tiles.data_ptr(),
                  part.data_ptr() if part is not None else None,
                  acc.data_ptr())
    return acc


def forces_fast(pos: torch.Tensor, mass: torch.Tensor,
                eps2: float) -> torch.Tensor:
    """Softened all-pairs accelerations (N,3),(N,) -> (N,3) through K12
    (``impl="pallas_fast"``), the self-pair masked.  Sort the bodies in
    Morton order first for the tier's accuracy."""
    return _launch(pos, pos, mass, eps2, True)


def rect_forces_fast(pos_i: torch.Tensor, pos_j: torch.Tensor,
                     mass_j: torch.Tensor, eps2: float,
                     self_tile: bool = False) -> torch.Tensor:
    """Forces of body set j on body set i through K12:
    (Ni,3),(Nj,3),(Nj,) -> (Ni,3).  ``self_tile`` says that i is a prefix
    of j (index equality means the same body, whose pair is masked); with
    ``self_tile=False`` the sets are disjoint and nothing is masked, as in
    ``rect_forces_pallas``."""
    return _launch(pos_i, pos_j, mass_j, eps2, self_tile)


# Kernel launches of K12, through either entry point.
forces_fast.launches = 0
