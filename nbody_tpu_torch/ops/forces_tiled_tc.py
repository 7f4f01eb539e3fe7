"""K9 / K10: the one-sided tensor-core tiers ``turbo`` and ``mxu``,
hand-written in CUDA for Hopper.

The counterparts of ``nbody_tpu/ops/forces_pallas.py`` variants ``turbo``
(``_force_kernel_turbo``) and ``mxu`` (``_force_kernel_mxu``): exact float32
pair weights ``f = m_j rsqrt((|r|^2 + eps2)^3)``, rounded to bf16 (turbo) or
split into bf16 hi/lo limbs (mxu), multiplied on the tensor cores with the
j-tile's pack ``[x_hi|x_lo|1|0]``, and turned into accelerations by the
correction ``sum f x_j - x_i sum f`` once per j-tile of ``TC_TILE_J``
bodies.  The self-pair is masked by index equality before the product.
The kernel is ``csrc/forces_tiled_tc.cu``; the packs, the mma and the
correction are in ``csrc/tc_common.cuh``.

The packs interleave the hi and lo columns (``[x_hi x_lo y_hi y_lo z_hi
z_lo 1 0]``); the plain versions here do the same, so that the two add
hi + lo in the same place.  Accuracy classes against the float64 oracle:
turbo p99 ~3e-2 on unsorted bodies, mxu ~3e-4 (``PERF.md``).

The wrappers take the plain PyTorch versions only for CPU tensors.  For a
CUDA tensor they launch the kernel or raise.  Each kernel counts its
launches on its own wrapper: ``forces_tiled_turbo.launches`` (K9) and
``forces_tiled_mxu.launches`` (K10).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# j-tile width: the correction is applied once per tile (TC_TILE_J in
# csrc/forces_tiled_tc.cu).
TC_TILE_J = 128
VARIANTS = ("turbo", "mxu")

_c_ll, _c_ptr, _c_int = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("forces_tiled_tc")
    fn = lib.nbt_forces_tiled_tc
    if fn.argtypes is None:
        fn.argtypes = [_c_ptr, _c_ll, _c_ptr, _c_ptr, _c_ll, ctypes.c_float,
                       _c_int, _c_int, _c_ptr, _c_ptr]
        fn.restype = _c_int
        lib.nbt_tiled_tc_tile.argtypes = []
        lib.nbt_tiled_tc_tile.restype = _c_int
        if lib.nbt_tiled_tc_tile() != TC_TILE_J:
            raise RuntimeError("TC_TILE_J differs between forces_tiled_tc.py "
                               "and csrc/forces_tiled_tc.cu")
    return lib


# -- the arithmetic shared with the pair-symmetric tiers (ops/forces_sym_tc)

def bf16_split(x: torch.Tensor):
    """hi = bf16(x), lo = bf16(x - hi), as float32 tensors."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _interleave(x: torch.Tensor) -> torch.Tensor:
    hi, lo = bf16_split(x)
    return torch.stack([hi, lo], -1).flatten(-2)


def position_pack(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 8): [x_hi x_lo y_hi y_lo z_hi z_lo 1 0]."""
    one = torch.ones_like(x[..., :1])
    return torch.cat([_interleave(x), one, torch.zeros_like(one)], -1)


def mass_folded_pack(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., 3), (...) -> (..., 8): [Px_hi Px_lo .. Pz_lo m_hi m_lo] with
    P = m x."""
    return torch.cat([_interleave(m[..., None] * x),
                      _interleave(m[..., None])], -1)


def pair_inv(xi: torch.Tensor, xj: torch.Tensor, eps2: float) -> torch.Tensor:
    """(..., Ti, 3), (..., Tj, 3) -> (..., Ti, Tj) rsqrt((|x_j - x_i|^2 +
    eps2)^3), rounded operation by operation as the kernels round it."""
    dx = xj[..., None, :, 0] - xi[..., :, None, 0]
    dy = xj[..., None, :, 1] - xi[..., :, None, 1]
    dz = xj[..., None, :, 2] - xi[..., :, None, 2]
    d2 = dx * dx + dy * dy + dz * dz + eps2
    return torch.rsqrt(d2 * d2 * d2)


def tile_result(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 8) product with a pack, (..., 3) positions -> (..., 3):
    (hi + lo) - x * (weight column sum), the per-tile correction."""
    s = out[..., 0::2] + out[..., 1::2]
    return s[..., :3] - x * s[..., 3:4]


def weight_limbs(f: torch.Tensor, variant: str):
    """The bf16 limbs the tensor cores multiply: bf16(f) for turbo, its
    hi/lo split for mxu."""
    return bf16_split(f) if variant == "mxu" else (
        f.to(torch.bfloat16).float(),)


# -- K9 / K10

def rect_forces_tiled_tc_plain(pos_i: torch.Tensor, pos_j: torch.Tensor,
                               mass_j: torch.Tensor, eps2: float,
                               variant: str,
                               self_tile: bool) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: j-tiles of ``TC_TILE_J`` bodies
    (the last padded with zero-mass bodies at the origin), the self-pair
    masked by index equality when ``self_tile``, the bf16 weight limbs
    times the tile's pack summed in float32, the correction per tile."""
    tile = TC_TILE_J
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    nj_pad = -(-nj // tile) * tile
    pos_j = torch.cat([pos_j, pos_j.new_zeros(nj_pad - nj, 3)])
    mass_j = torch.cat([mass_j, mass_j.new_zeros(nj_pad - nj)])
    rows = torch.arange(ni, device=pos_i.device)[:, None]
    acc = torch.zeros_like(pos_i)
    for s in range(0, nj_pad, tile):
        xj = pos_j[s:s + tile]
        f = mass_j[None, s:s + tile] * pair_inv(pos_i, xj, eps2)
        if self_tile:
            cols = torch.arange(s, s + tile, device=pos_i.device)[None, :]
            f = torch.where(rows == cols, torch.zeros_like(f), f)
        pack = position_pack(xj)
        out = sum(w @ pack for w in weight_limbs(f, variant))
        acc = acc + tile_result(out, pos_i)
    return acc


def _launch(pos_i, pos_j, mass_j, eps2, variant, self_tile):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    _build.check_rect(f"forces_tiled_{variant}", pos_i, pos_j, mass_j,
                      self_tile)
    if pos_i.device.type == "cpu":
        return rect_forces_tiled_tc_plain(pos_i, pos_j, mass_j, eps2,
                                          variant, self_tile)
    fn = _lib().nbt_forces_tiled_tc
    acc = torch.empty_like(pos_i)
    _COUNTERS[variant].launches += 1
    _build.check_launch(f"forces_tiled_{variant}", fn(
        pos_i.data_ptr(), pos_i.shape[0], pos_j.data_ptr(),
        mass_j.data_ptr(), pos_j.shape[0], float(eps2),
        int(variant == "mxu"), int(self_tile), acc.data_ptr(),
        _build.stream_handle(acc)))
    return acc


def forces_tiled_tc(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                    variant: str) -> torch.Tensor:
    """Softened all-pairs accelerations (N,3),(N,) -> (N,3) through K9
    (``variant="turbo"``) or K10 (``"mxu"``), the self-pair masked."""
    return _launch(pos, pos, mass, eps2, variant, True)


def rect_forces_tiled_tc(pos_i: torch.Tensor, pos_j: torch.Tensor,
                         mass_j: torch.Tensor, eps2: float, variant: str,
                         self_tile: bool = False) -> torch.Tensor:
    """Forces of body set j on body set i through K9 / K10:
    (Ni,3),(Nj,3),(Nj,) -> (Ni,3).  ``self_tile`` says that i is a prefix
    of j (index equality means the same body, whose pair is masked); with
    ``self_tile=False`` the sets are disjoint and nothing is masked, as in
    ``rect_forces_pallas``."""
    return _launch(pos_i, pos_j, mass_j, eps2, variant, self_tile)


def forces_tiled_turbo(pos: torch.Tensor, mass: torch.Tensor,
                       eps2: float) -> torch.Tensor:
    """K9 (``impl="pallas_turbo"``)."""
    return forces_tiled_tc(pos, mass, eps2, "turbo")


def forces_tiled_mxu(pos: torch.Tensor, mass: torch.Tensor,
                     eps2: float) -> torch.Tensor:
    """K10 (``impl="pallas_mxu"``)."""
    return forces_tiled_tc(pos, mass, eps2, "mxu")


# Kernel launches of K9 and K10, through any entry point.
forces_tiled_turbo.launches = 0
forces_tiled_mxu.launches = 0
_COUNTERS = {"turbo": forces_tiled_turbo, "mxu": forces_tiled_mxu}
