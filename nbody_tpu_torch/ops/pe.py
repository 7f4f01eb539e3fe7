"""K8: the pair potential, hand-written in CUDA.

The counterpart of ``nbody_tpu/ops/pe_pallas.py`` (``_pe_kernel``,
``pe_rows_pallas``): for each given row i,
``m_i * sum_j m_j (|x_j - x_i|^2 + eps2)^(-1/2)`` over all bodies j, with
no mask, so each row's self term ``m_i^2 / sqrt(eps2)`` is included and
the caller subtracts it in float64.  The kernels are in ``csrc/pe.cu``:

- ``pe_rows`` (a row subset against all bodies): K1's shape (one thread
  per row, j-tiles of ``PE_TILE`` bodies in shared memory, zero-mass
  ghosts at the ragged edge), each tile summed in a float32 partial and
  the partials added in float64;
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
launch covers every row.

The wrappers take the plain PyTorch versions (``pe_rows_plain``,
``pe_total_plain``: the same tiles, offsets, weights and float32 / float64
split) only for CPU tensors.  For a CUDA tensor they launch the kernels or
raise.  Launches are counted on ``pe_rows.launches`` and
``pe_total.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .forces_sym import offset_rows

# Threads per block = j-tile width (PE_THREADS in csrc/pe.cu), and
# pe_total's tile (PE_TILE there).
PE_TILE = 256
# pe_total's grid: a block takes one row tile and a run of offsets, the
# runs cut so that the grid has about this many blocks.
PE_TOTAL_BLOCKS = 65536

_c_ll, _c_ptr = ctypes.c_longlong, ctypes.c_void_p


def _lib():
    lib = _build.load("pe")
    if lib.nbt_pe_rows.argtypes is None:
        lib.nbt_pe_rows.argtypes = [_c_ptr, _c_ptr, _c_ll, _c_ptr, _c_ptr,
                                    _c_ll, ctypes.c_float, _c_ptr, _c_ptr]
        lib.nbt_pe_rows.restype = ctypes.c_int
        lib.nbt_pe_tile.argtypes = []
        lib.nbt_pe_tile.restype = ctypes.c_int
        lib.nbt_pe_total.argtypes = [_c_ptr, _c_ptr, _c_ll, _c_ll,
                                     ctypes.c_float, _c_ptr, _c_ptr, _c_ptr]
        lib.nbt_pe_total.restype = ctypes.c_int
        lib.nbt_pe_total_tile.argtypes = []
        lib.nbt_pe_total_tile.restype = ctypes.c_int
        if lib.nbt_pe_tile() != PE_TILE or lib.nbt_pe_total_tile() != PE_TILE:
            raise RuntimeError("PE_TILE differs between pe.py and csrc/pe.cu")
    return lib


def pe_rows_plain(pos_rows, mass_rows, pos_all, mass_all,
                  eps2: float) -> torch.Tensor:
    """Plain twin of the kernel: float32 sums over j-tiles of ``PE_TILE``
    bodies, added in float64 and scaled by m_i.  Returns (nr,) float64."""
    row = torch.zeros(pos_rows.shape[0], dtype=torch.float64,
                      device=pos_rows.device)
    for s in range(0, pos_all.shape[0], PE_TILE):
        r = pos_all[None, s:s + PE_TILE, :] - pos_rows[:, None, :]
        d2 = (r * r).sum(-1) + eps2
        part = (mass_all[None, s:s + PE_TILE] * torch.rsqrt(d2)).sum(1)
        row = row + part.double()
    return mass_rows.double() * row


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
    out = torch.empty(pos_rows.shape[0], dtype=torch.float64,
                      device=pos_rows.device)
    pe_rows.launches += 1
    _build.check_launch("pe_rows (K8)", lib.nbt_pe_rows(
        pos_rows.data_ptr(), mass_rows.data_ptr(), pos_rows.shape[0],
        pos_all.data_ptr(), mass_all.data_ptr(), pos_all.shape[0],
        float(eps2), out.data_ptr(), _build.stream_handle(out)))
    return out


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
    _build.check_launch("pe_total (K8)", lib.nbt_pe_total(
        pos.data_ptr(), mass.data_ptr(), n, chunk, float(eps2),
        partials.data_ptr(), out.data_ptr(), _build.stream_handle(out)))
    return out


# K8 symmetric totals launched through the wrapper.
pe_total.launches = 0
