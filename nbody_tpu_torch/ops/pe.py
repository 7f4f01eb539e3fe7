"""K8: the pair potential, hand-written in CUDA.

The counterpart of ``nbody_tpu/ops/pe_pallas.py`` (``_pe_kernel``,
``pe_rows_pallas``): for each given row i,
``m_i * sum_j m_j (|x_j - x_i|^2 + eps2)^(-1/2)`` over all bodies j, with
no mask, so each row's self term ``m_i^2 / sqrt(eps2)`` is included and
the caller subtracts it in float64.  The kernels are in ``csrc/pe.cu``:

- ``pe_rows`` (a row subset against all bodies; on the main path a
  shard's row chunk against a visiting shard, ``parallel/energy.py``,
  the mesh's energy past the host wall): K1's (row block, j
  slice) work items (``ops/forces_tiled.py``: ``slice_plan``) with
  ``pe_total``'s pair; the j-set in tiles of ``PE_TILE`` bodies
  (zero-mass ghosts at the ragged edge), each row's tile summed in a
  float32 partial, the partials added in float64 into the row's slice
  sum; the slices' sums added in slice order and scaled by m_i in
  float64 (``rows_slices`` picks the slices; one slice writes the result
  directly), so the row sums are bit-reproducible;
- ``pe_total`` (the whole set against itself, summed: the scalar that
  ``pe_rows_pallas(pos, mass, pos, mass, eps2)`` returns and
  ``total_energy_bounded`` takes): each unordered tile pair once, on K2's
  circular offsets (``ops/forces_sym.py``: ``offset_rows``), the d = 0
  tiles whole with weight 1 and the others with weight 2, the same
  float32 partials of at most ``PE_TILE`` terms a row, added in float64
  and scaled by m_i in float64; the blocks' partials added in a fixed
  order, so the total is bit-reproducible.

Not ported: the row-chunked programs of ``total_energy_bounded`` (the
relay's program kill) and the flat-state panel pairs; on the card one
launch covers every row.  The mesh's energy keeps its row chunks as a
heartbeat granularity (``parallel/energy.py``).

The wrappers take the plain PyTorch versions (``pe_rows_plain``,
``pe_total_plain``: the same tiles, slices, offsets, weights and float32 /
float64 split) only for CPU tensors.  For a CUDA tensor they launch the
kernels or raise.  Launches are counted on ``pe_rows.launches`` and
``pe_total.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .forces_sym import offset_rows
from .forces_tiled import slice_plan

# The body tile of both kernels (PE_TILE in csrc/pe.cu) and pe_rows's rows
# a block (PR_BLOCK_ROWS there).
PE_TILE = 256
PE_BLOCK_ROWS = 512
# pe_rows's work items wanted a launch (row blocks x slices): about
# fourteen waves of the nine 128-thread blocks an SM that an H100's 132 SMs
# hold at once, so that the last wave's tail is short (8192 lost 1.0% at
# 1M x 1M and at 262,144 x 262,144, 4096 3.1%; tools/pe_variants.py).
PE_ITEMS = 16384
# pe_total's grid: a block takes one row tile and a run of offsets, the
# runs cut so that the grid has about this many blocks.
PE_TOTAL_BLOCKS = 65536

_c_ll, _c_ptr = ctypes.c_longlong, ctypes.c_void_p


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument types on a build of pe.cu (the
    package's, or a copy that tools/pe_variants.py edits)."""
    if lib.nbt_pe_rows.argtypes is None:
        lib.nbt_pe_rows.argtypes = [_c_ptr, _c_ptr, _c_ll, _c_ptr, _c_ptr,
                                    _c_ll, _c_ll, ctypes.c_int,
                                    ctypes.c_float, _c_ptr, _c_ptr, _c_ptr]
        lib.nbt_pe_total.argtypes = [_c_ptr, _c_ptr, _c_ll, _c_ll,
                                     ctypes.c_float, _c_ptr, _c_ptr, _c_ptr]
        lib.nbt_pe_geometry.argtypes = [ctypes.c_int]
        for fn in (lib.nbt_pe_rows, lib.nbt_pe_total, lib.nbt_pe_geometry):
            fn.restype = ctypes.c_int
        if _build.query(None, lib.nbt_pe_geometry, 0) != PE_TILE:
            raise RuntimeError("PE_TILE differs between pe.py and csrc/pe.cu")
    return lib


def _lib():
    lib = bind(_build.load("pe"))
    if _build.query(None, lib.nbt_pe_geometry, 1) != PE_BLOCK_ROWS:
        raise RuntimeError("PE_BLOCK_ROWS differs between pe.py and "
                           "csrc/pe.cu")
    return lib


def rows_slices(nr: int, n: int) -> "tuple[int, int]":
    """(slices, tiles a slice) of pe_rows's j-set for ``nr`` rows against
    ``n`` bodies (``slice_plan`` at ``PE_BLOCK_ROWS`` rows a block,
    ``PE_ITEMS`` items, 8 slot bytes a row and slice)."""
    return slice_plan(nr, n, PE_TILE, PE_BLOCK_ROWS, PE_ITEMS, 8)


def pe_rows_plain(pos_rows, mass_rows, pos_all, mass_all,
                  eps2: float) -> torch.Tensor:
    """Plain twin of the kernel: the j-set in tiles of ``PE_TILE`` bodies,
    in the slices of ``rows_slices``; each row's tile summed in float32
    and added in float64 into its slice sum, the slice sums added in slice
    order and scaled by m_i in float64.  A d2 below the smallest normal
    float32 (only with eps2 = 0) is taken as 0, as the kernels' MUFU rsqrt
    flushes it.  Returns (nr,) float64."""
    n = pos_all.shape[0]
    n_slices, tps = rows_slices(pos_rows.shape[0], n)
    row = None
    for k in range(n_slices):
        s = torch.zeros(pos_rows.shape[0], dtype=torch.float64,
                        device=pos_rows.device)
        for j0 in range(k * tps * PE_TILE, min((k + 1) * tps * PE_TILE, n),
                        PE_TILE):
            r = pos_all[None, j0:j0 + PE_TILE, :] - pos_rows[:, None, :]
            d2 = (r * r).sum(-1) + eps2
            d2 = torch.where(d2 < torch.finfo(torch.float32).tiny, 0.0, d2)
            part = (mass_all[None, j0:j0 + PE_TILE] * torch.rsqrt(d2)).sum(1)
            s = s + part.double()
        row = s if row is None else row + s
    return mass_rows.double() * row


def rows_sweep(lib, pos_rows, mass_rows, pos_all, mass_all,
               eps2: float) -> torch.Tensor:
    """One launch of pe_rows through ``lib`` (the package's build of pe.cu,
    or another's: ``bind``) in the slices of ``rows_slices``, without the
    wrapper's checks and counter; raises if the launch fails."""
    nr, n = pos_rows.shape[0], pos_all.shape[0]
    out = torch.empty(nr, dtype=torch.float64, device=pos_rows.device)
    n_slices, tps = rows_slices(nr, n)
    slots = (torch.empty(n_slices * nr, dtype=torch.float64,
                         device=pos_rows.device) if n_slices > 1 else None)
    _build.launch("pe_rows (K8)", out, lib.nbt_pe_rows, pos_rows.data_ptr(),
                  mass_rows.data_ptr(), nr, pos_all.data_ptr(),
                  mass_all.data_ptr(), n, tps, n_slices, float(eps2),
                  slots.data_ptr() if slots is not None else None,
                  out.data_ptr())
    return out


def pe_rows(pos_rows, mass_rows, pos_all, mass_all,
            eps2: float) -> torch.Tensor:
    """Per-row pair potential ``m_i sum_j m_j (|r|^2+eps2)^(-1/2)`` of the
    rows (nr,3),(nr,) against all bodies (n,3),(n,), self pairs included,
    through K8.  Returns (nr,) float64."""
    _build.check_bodies("pe_rows", pos_all, mass_all)
    _build.check_bodies("pe_rows", pos_rows, mass_rows)
    if pos_rows.device != pos_all.device:
        raise ValueError(f"pe_rows: rows on {pos_rows.device}, bodies on "
                         f"{pos_all.device}")
    if pos_rows.device.type == "cpu":
        return pe_rows_plain(pos_rows, mass_rows, pos_all, mass_all, eps2)
    lib = _lib()
    pe_rows.launches += 1
    return rows_sweep(lib, pos_rows, mass_rows, pos_all, mass_all, eps2)


# K8 launches made through the wrapper.
pe_rows.launches = 0


def total_chunk(n: int) -> int:
    """Offsets a block of pe_total's kernel takes, for ``n`` bodies."""
    nb = -(-n // PE_TILE)
    n_off = nb // 2 + 1
    runs = min(n_off, max(1, PE_TOTAL_BLOCKS // nb))
    return -(-n_off // runs)


def pe_total_plain(pos, mass, eps2: float) -> torch.Tensor:
    """Plain twin of pe_total's kernel: the tiles of ``PE_TILE`` bodies
    (zero-mass ghosts past N), row tile I against (I + d) mod nb for
    d = 0 .. nb//2 (``offset_rows``), each tile pair's row sums from
    ``pe_rows_plain`` (float32 over the tile, times m_i in float64), ghost
    rows left out, weight 1 at d = 0 and 2 elsewhere.  Returns a float64
    scalar."""
    n = pos.shape[0]
    nb = -(-n // PE_TILE)
    n_pad = nb * PE_TILE
    pt = torch.cat([pos, pos.new_zeros(n_pad - n, 3)]).view(nb, PE_TILE, 3)
    mt = torch.cat([mass, mass.new_zeros(n_pad - n)]).view(nb, PE_TILE)
    real = (torch.arange(n_pad, device=pos.device) < n).view(nb, PE_TILE)
    total = torch.zeros((), dtype=torch.float64, device=pos.device)
    for d in range(nb // 2 + 1):
        for i in range(offset_rows(nb, d)):
            j = (i + d) % nb
            tile = torch.where(real[i], pe_rows_plain(pt[i], mt[i], pt[j],
                                                      mt[j], eps2), 0.0).sum()
            total = total + (tile if d == 0 else 2.0 * tile)
    return total


def pe_total(pos, mass, eps2: float) -> torch.Tensor:
    """The whole set's pair potential ``sum_i m_i sum_j m_j
    (|r|^2+eps2)^(-1/2)``, self pairs included, through K8's symmetric
    sweep: (n,3),(n,) -> float64 scalar, ``sum(pe_rows(pos, mass, pos,
    mass, eps2))`` with each unordered pair computed once."""
    _build.check_bodies("pe_total", pos, mass)
    if pos.device.type == "cpu":
        return pe_total_plain(pos, mass, eps2)
    out = torch.zeros((), dtype=torch.float64, device=pos.device)
    n = pos.shape[0]
    if n == 0:
        return out
    lib = _lib()
    nb = -(-n // PE_TILE)
    chunk = total_chunk(n)
    partials = torch.empty(nb * -(-(nb // 2 + 1) // chunk),
                           dtype=torch.float64, device=pos.device)
    pe_total.launches += 1
    _build.launch("pe_total (K8)", out, lib.nbt_pe_total, pos.data_ptr(),
                  mass.data_ptr(), n, chunk, float(eps2), partials.data_ptr(),
                  out.data_ptr())
    return out


# K8 symmetric totals launched through the wrapper.
pe_total.launches = 0
