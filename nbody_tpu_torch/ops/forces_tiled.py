"""K1: the one-sided exact force tile, hand-written in CUDA for Hopper.

The counterpart of ``nbody_tpu/ops/forces_pallas.py`` variant ``vpu``
(``_force_kernel_vpu``): ``acc_i = sum_j m_j r_ij rsqrt((|r_ij|^2+eps2)^3)``
with no i != j guard (the self-pair vanishes by r = 0).  The kernel is
``csrc/forces_tiled.cu``: one thread per i-body, j-tiles of
``K1_TILE`` bodies staged through shared memory, the ragged edge masked
as zero-mass bodies.

The wrapper takes the plain PyTorch version (``rect_forces_tiled_plain``,
the same j-tile decomposition) only for tensors on the CPU.  For a CUDA
tensor it launches the kernel or raises.  The other Pallas variants
(``vpu_kahan``, ``mxu``, ``fast``, ``turbo``) are not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Threads per block = j-tile width (K1_THREADS in csrc/forces_tiled.cu).
K1_TILE = 128

_c_ll, _c_ptr = ctypes.c_longlong, ctypes.c_void_p


def _lib():
    lib = _build.load("forces_tiled")
    fn = lib.nbt_forces_tiled
    if fn.argtypes is None:
        fn.argtypes = [_c_ptr, _c_ll, _c_ptr, _c_ptr, _c_ll, ctypes.c_float,
                       _c_ptr, _c_ptr]
        fn.restype = ctypes.c_int
    return lib


def rect_forces_tiled_plain(pos_i: torch.Tensor, pos_j: torch.Tensor,
                            mass_j: torch.Tensor, eps2: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the j-set swept in tiles of
    ``K1_TILE`` bodies, the last tile padded with zero-mass bodies at the
    origin, each tile's contribution added to the running (Ni,3) sum."""
    tile = K1_TILE
    nj = pos_j.shape[0]
    nj_pad = -(-nj // tile) * tile
    pos_j = torch.cat([pos_j, pos_j.new_zeros(nj_pad - nj, 3)])
    mass_j = torch.cat([mass_j, mass_j.new_zeros(nj_pad - nj)])
    acc = torch.zeros_like(pos_i)
    for s in range(0, nj_pad, tile):
        r = pos_j[None, s:s + tile, :] - pos_i[:, None, :]   # (Ni, T, 3)
        d2 = (r * r).sum(-1) + eps2
        f = mass_j[None, s:s + tile] * torch.rsqrt(d2 * d2 * d2)
        acc = acc + (f[:, :, None] * r).sum(1)
    return acc


def _launch(pos_i, pos_j, mass_j, eps2):
    _build.check_bodies("forces_tiled", pos_j, mass_j)
    if (pos_i.dtype != torch.float32 or pos_i.dim() != 2
            or pos_i.shape[1] != 3 or not pos_i.is_contiguous()
            or pos_i.device != pos_j.device):
        raise ValueError("forces_tiled: pos_i must be a contiguous float32 "
                         f"(Ni, 3) tensor on {pos_j.device}")
    if pos_i.device.type == "cpu":
        return rect_forces_tiled_plain(pos_i, pos_j, mass_j, eps2)
    fn = _lib().nbt_forces_tiled
    acc = torch.empty_like(pos_i)
    forces_tiled.launches += 1
    _build.check_launch("forces_tiled", fn(
        pos_i.data_ptr(), pos_i.shape[0], pos_j.data_ptr(),
        mass_j.data_ptr(), pos_j.shape[0], float(eps2), acc.data_ptr(),
        _build.stream_handle(acc)))
    return acc


def forces_tiled(pos: torch.Tensor, mass: torch.Tensor,
                 eps2: float) -> torch.Tensor:
    """Softened all-pairs accelerations (N,3),(N,) -> (N,3) through K1."""
    return _launch(pos, pos, mass, eps2)


# Kernel launches made through this wrapper (both entry points).
forces_tiled.launches = 0


def rect_forces_tiled(pos_i: torch.Tensor, pos_j: torch.Tensor,
                      mass_j: torch.Tensor, eps2: float) -> torch.Tensor:
    """Forces of body set j on body set i through K1:
    (Ni,3),(Nj,3),(Nj,) -> (Ni,3).  No self-pair mask is needed: a body
    present in both sets meets itself at r = 0."""
    return _launch(pos_i, pos_j, mass_j, eps2)
