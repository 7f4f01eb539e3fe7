"""K9 / K10: the one-sided tensor-core tiers ``turbo`` and ``mxu``,
hand-written in CUDA for Hopper.

The counterparts of ``nbody_tpu/ops/forces_pallas.py`` variants ``turbo``
(``_force_kernel_turbo``) and ``mxu`` (``_force_kernel_mxu``): float32
pair weights ``f = m_j rsqrt((|r|^2 + eps2)^3)``, rounded to bf16 (turbo) or
split into bf16 hi/lo limbs (mxu), multiplied on the tensor cores with the
j-tile's pack ``[x_hi|x_lo|1|0]``, and turned into accelerations by the
correction ``sum f x_j - x_i sum f`` once per j-tile of ``TC_TILE_J``
bodies.  The self-pair is masked by index equality before the product,
on the tiles whose j range meets the rows only.  The kernel is
``csrc/forces_tiled_tc.cu``; the packs, the mma and the correction are in
``csrc/tc_common.cuh``.

The geometry is trimmed (``pair_inv_fma``: d2 as three fused multiply-adds
with eps2 folded in, the rsqrt without rsqrtf's subnormal fix-up), as for
K5, K6 and K14a; the twin rounds each fused multiply-add once, so it gives
the kernel's float32 weights and bf16 roundings but for rare
double-rounding ties.  The kernel runs K1's (row block, j slice) work
items: row blocks of ``TC_BLOCK_ROWS`` rows (two 16-row mma blocks a
warp), j slices of whole tiles (``tc_slices``), each tile's result added
to its slice's sum, the slices' sums added in slice order by a second
launch.  The twin takes the same tiles, slices and order.  On an H100
80GB HBM3 at 700 W an evaluation at N = 1,048,576 takes 523.97 ms (K9) and
621.82 ms (K10), and 0.0412 / 0.0473 ms of the card's time at 8192,
against 755.72 / 1000.60 and 0.1005 / 0.1160 on the design before it (one
16-row block a warp, ``pair_inv``, the mask tested on every pair).

The packs interleave the hi and lo columns (``[x_hi x_lo y_hi y_lo z_hi
z_lo 1 0]``); the plain versions here do the same, so that the two add
hi + lo in the same place.  Accuracy classes against the float64 oracle:
turbo p99 ~3e-2 on unsorted bodies, mxu ~3e-4 (``PERF.md``).

The wrappers take the plain PyTorch versions only for CPU tensors.  For a
CUDA tensor they launch the kernel or raise.  Each kernel counts its
force evaluations on its own wrapper: ``forces_tiled_turbo.launches`` (K9)
and ``forces_tiled_mxu.launches`` (K10); the slot reduce is a second
launch of the same evaluation.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .forces_tiled import slice_plan

# j-tile width: the correction is applied once per tile (TC_TILE_J in
# csrc/forces_tiled_tc.cu); rows a block (TC_BLOCK_ROWS).
TC_TILE_J = 128
TC_BLOCK_ROWS = 128
# Work items wanted an evaluation (row blocks x slices): 1024 and 4096
# were no faster at N = 8192 (tools/tc_onesided_variants.py).
TC_ITEMS = 2048
VARIANTS = ("turbo", "mxu")

_c_ll, _c_ptr, _c_int = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C entries' argument types on a build of forces_tiled_tc.cu
    (the package's, or a copy that tools/tc_onesided_variants.py edits)."""
    fn = lib.nbt_forces_tiled_tc
    if fn.argtypes is None:
        fn.argtypes = [_c_ptr, _c_ll, _c_ptr, _c_ptr, _c_ll, _c_ll, _c_int,
                       ctypes.c_float, _c_int, _c_int, _c_ptr, _c_ptr,
                       _c_ptr]
        fn.restype = _c_int
        lib.nbt_tiled_tc_geometry.argtypes = [_c_int]
        lib.nbt_tiled_tc_geometry.restype = _c_int
    return lib


def _lib():
    lib = bind(_build.load("forces_tiled_tc"))
    if (_build.query(None, lib.nbt_tiled_tc_geometry, 0),
            _build.query(None, lib.nbt_tiled_tc_geometry, 1)) != (
                TC_TILE_J, TC_BLOCK_ROWS):
        raise RuntimeError("TC_TILE_J / TC_BLOCK_ROWS differ between "
                           "forces_tiled_tc.py and csrc/forces_tiled_tc.cu")
    return lib


def tc_slices(ni: int, nj: int,
              slices: "int | None" = None) -> "tuple[int, int]":
    """(slices, tiles a slice) of K9's / K10's j-set: ``slices`` if given,
    else as many as bring the work items to ``TC_ITEMS`` (``slice_plan``,
    K1's rule)."""
    return slice_plan(ni, nj, TC_TILE_J, TC_BLOCK_ROWS, TC_ITEMS, 12, slices)


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


def pair_inv_fma(xi: torch.Tensor, xj: torch.Tensor,
                 eps2: float) -> torch.Tensor:
    """(..., Ti, 3), (..., Tj, 3) -> (..., Ti, Tj) rsqrt((|x_j - x_i|^2 +
    eps2)^3) as the trimmed geometry of K5, K6, K14a, K9 and K10 rounds it:
    d2 = fma(dz, dz, fma(dy, dy, fma(dx, dx, eps2))), each fused
    multiply-add rounded once to float32 from its float64 value (a float32
    square is exact in float64; the sum then rounds twice, which differs
    from one rounding only at rare ties)."""
    d2 = torch.full((), torch.tensor(eps2, dtype=torch.float32).item(),
                    dtype=torch.float64, device=xi.device)
    for e in range(3):
        de = (xj[..., None, :, e] - xi[..., :, None, e]).double()
        d2 = (de * de + d2).float().double()
    d2 = d2.float()
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
                               variant: str, self_tile: bool,
                               slices: "int | None" = None) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: j-tiles of ``TC_TILE_J`` bodies
    (the last padded with zero-mass bodies at the origin) in slices of
    whole tiles (``tc_slices``; ``slices`` overrides the count), the
    weights from ``pair_inv_fma``, the self-pairs zeroed when
    ``self_tile`` (on the tiles whose j range meets the rows), the bf16
    weight limbs times the tile's pack summed in float32, the correction
    per tile; each tile's result added to its slice's sum, the slices'
    sums added in slice order."""
    tile = TC_TILE_J
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    nj_pad = -(-nj // tile) * tile
    pos_j = torch.cat([pos_j, pos_j.new_zeros(nj_pad - nj, 3)])
    mass_j = torch.cat([mass_j, mass_j.new_zeros(nj_pad - nj)])

    def contrib(s):
        xj = pos_j[s:s + tile]
        f = mass_j[None, s:s + tile] * pair_inv_fma(pos_i, xj, eps2)
        if self_tile and s < ni:
            rows = torch.arange(s, min(s + tile, ni), device=f.device)
            f[rows, rows - s] = 0.0
        pack = position_pack(xj)
        return tile_result(sum(w @ pack for w in weight_limbs(f, variant)),
                           pos_i)

    n_slices, tps = tc_slices(ni, nj, slices)
    acc = None
    for k in range(n_slices):
        part = torch.zeros_like(pos_i)
        for s in range(k * tps * tile, min((k + 1) * tps * tile, nj_pad),
                       tile):
            part = part + contrib(s)
        acc = part if acc is None else acc + part
    return acc


def sweep(lib, pos_i: torch.Tensor, pos_j: torch.Tensor,
          mass_j: torch.Tensor, eps2: float, variant: str,
          self_tile: bool) -> torch.Tensor:
    """One evaluation of K9 or K10 through ``lib`` (the package's build of
    forces_tiled_tc.cu, or another's: ``bind``), without the wrappers'
    checks and counters; raises if the launch fails."""
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    acc = torch.empty_like(pos_i)
    slices, tps = tc_slices(ni, nj)
    slots = pos_i.new_empty(slices * ni * 3) if slices > 1 else None
    _build.launch(f"forces_tiled_{variant}", acc, lib.nbt_forces_tiled_tc,
                  pos_i.data_ptr(), ni, pos_j.data_ptr(), mass_j.data_ptr(),
                  nj, tps, slices, float(eps2), int(variant == "mxu"),
                  int(self_tile),
                  slots.data_ptr() if slots is not None else None,
                  acc.data_ptr())
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
    lib = _lib()
    _COUNTERS[variant].launches += 1
    return sweep(lib, pos_i, pos_j, mass_j, eps2, variant, self_tile)


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


# Force evaluations launched through the wrappers (any entry point): K9,
# K10.
forces_tiled_turbo.launches = 0
forces_tiled_mxu.launches = 0
_COUNTERS = {"turbo": forces_tiled_turbo, "mxu": forces_tiled_mxu}
