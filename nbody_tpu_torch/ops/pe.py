"""K8: pair-potential row sums, hand-written in CUDA.

The counterpart of ``nbody_tpu/ops/pe_pallas.py`` (``_pe_kernel``,
``pe_rows_pallas``): for each given row i,
``m_i * sum_j m_j (|x_j - x_i|^2 + eps2)^(-1/2)`` over all bodies j, with
no mask, so each row's self term ``m_i^2 / sqrt(eps2)`` is included and
the caller subtracts it in float64.  The kernel is ``csrc/pe.cu``: K1's
shape (one thread per row, j-tiles of ``PE_TILE`` bodies in shared
memory, zero-mass ghosts at the ragged edge), each tile summed in a
float32 partial and the partials added in float64.

Not ported: the row-chunked programs of ``total_energy_bounded`` (the
relay's program kill) and the flat-state panel pairs; on the card one
launch covers every row.

The wrapper takes the plain PyTorch version (``pe_rows_plain``, the same
tiles and the same float32 / float64 split) only for CPU tensors.  For a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Threads per block = j-tile width (PE_THREADS in csrc/pe.cu).
PE_TILE = 256

_c_ll, _c_ptr = ctypes.c_longlong, ctypes.c_void_p


def _lib():
    lib = _build.load("pe")
    if lib.nbt_pe_rows.argtypes is None:
        lib.nbt_pe_rows.argtypes = [_c_ptr, _c_ptr, _c_ll, _c_ptr, _c_ptr,
                                    _c_ll, ctypes.c_float, _c_ptr, _c_ptr]
        lib.nbt_pe_rows.restype = ctypes.c_int
        lib.nbt_pe_tile.argtypes = []
        lib.nbt_pe_tile.restype = ctypes.c_int
        if lib.nbt_pe_tile() != PE_TILE:
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
