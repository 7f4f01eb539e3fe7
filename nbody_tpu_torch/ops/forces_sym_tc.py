"""K5 / K6 / K14a-c: the pair-symmetric tensor-core tiers ``turbo``,
``mxu``, ``turbo2``, ``turbof`` and ``turbop``, hand-written in CUDA for
Hopper.

The counterparts of ``nbody_tpu/ops/forces_pallas_sym.py`` variants
``turbo`` (``_accum_i_turbo`` / ``_accum_j_turbo``), ``mxu``
(``_accum_both_mxu``), ``turbo2`` (``_accum_i_turbo2`` /
``_accum_j_turbo2``) and ``turbof`` (``_accum_both_turbof``) of
``_make_sym_kernel``, and of ``_make_sym_kernel_turbop``, with the exact
diagonal pass ``_diag_kernel_vpu``, as ``_forces_sym_padded`` composes
them.  Each off-diagonal pair's ``inv = rsqrt((|r|^2 + eps2)^3)`` is
computed once and feeds both bodies through bf16 products on the tensor
cores:

- turbo: ``bf16(m_j inv)`` against J's position pack ``[x_hi|x_lo|1|0]``
  for the force on i, ``bf16(m_i inv)`` transposed against I's pack for
  the force on j;
- mxu: the hi/lo limbs of ``inv`` against the mass-folded packs
  ``[P_hi|P_lo|m_hi|m_lo]`` (P = m x) of J and of I, four products a tile;
- turbo2 (``impl="pallas_sym_turbo2"``): mxu with the lo limb dropped,
  one ``bf16(inv)`` against both mass-folded packs, two products a tile;
- turbof: one symmetric ``bf16(m_i m_j inv)`` against both position
  packs; its sums are mass-scaled, so its reduce divides by m, as K2's
  does, and recomputes the row of a real massless body one-sided (JAX
  maps 1/0 to 0 there and leaves such a body with its diagonal terms);
- turbop: turbo with each block's j-side product issued after the next
  block's geometry; the same values in the same order, so bit-equal to
  turbo, and its twin is turbo's.

K5's geometry is trimmed (``csrc/tc_common.cuh``: ``pair_inv_fma``): d2
as three fused multiply-adds with eps2 folded in, and the rsqrt of d2^3
without rsqrtf's subnormal fix-up.  turbop and K15's tmm_full /
tmm_noscat controls, defined as K5's values, take it too; the other
variants and K13 keep the unfused ``pair_inv``.  The twin rounds each
fused multiply-add once (``pair_inv_fma``), so it gives the kernel's
float32 weights and bf16 roundings but for rare double-rounding ties.

Each side's tile result is ``sum w x - x sum w`` (the correction of the
Pallas kernels) once per 256 x 256 tile.  turbo, mxu, turbo2 and turbop
give accelerations: no 1/m descale, and a real body of mass 0 is right
from its slots without K2's one-sided recompute.

The schedule is K2's (``ops/forces_sym.py``): 256-wide tiles, the circular
offsets of ``tile_pairs``, one writer per slot, the fixed-order reduce
pass, offsets in chunks of ``offset_chunks``.  The JAX package partitions
the pairs the same way at ``block_u=256`` (its diagonal superblocks are
the exact pass), so that is where the two are compared.

The wrappers take the plain PyTorch versions (``forces_sym_tc_plain``: the
same tiles, enumeration, slot layout and reduction order) only for CPU
tensors.  For a CUDA tensor they launch the kernels or raise.  Each kernel
counts its launches on its own wrapper: ``forces_sym_turbo.launches``
(K5), ``forces_sym_mxu.launches`` (K6), ``forces_sym_turbo2.launches``,
``forces_sym_turbof.launches`` and ``forces_sym_turbop.launches`` (K14a,
K14b, K14c).

K2-rect on the tensor cores (``rect_forces_sym_tc``; ``_make_rect_kernel``
variants turbo, mxu, turbo2, turbof and ``_make_rect_kernel_turbop``)
runs the same tile between two disjoint body sets over the rect sweep of
``ops/forces_sym.py`` (``rect_sweep``), one wrapper and launch counter a
variant (``rect_forces_sym_turbo.launches`` ...); turbof's sums are
descaled as in the square sweep, and turbop stays bit-equal to turbo.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .forces_sym import (RECT_PAIRS_ARGTYPES, RECT_REDUCE_ARGTYPES,
                         SLOT_BUDGET_BYTES, SYM_TILE, check_rect_sets,
                         descale_plain, diag_plain, rect_descale_plain,
                         rect_sweep, rect_sweep_plain, sweep, sweep_plain)
from .forces_tiled_tc import (bf16_split, mass_folded_pack, pair_inv,
                              position_pack, tile_result)

VARIANTS = ("turbo", "mxu", "turbo2", "turbof", "turbop")
# Variants whose kernels take the trimmed geometry (pair_inv_fma).
_TRIMMED = ("turbo", "turbop")
# Variants whose slot sums carry the receiving body's mass.
_MASS_SCALED = ("turbof",)

_c_ll, _c_ptr, _c_int = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = _build.load("forces_sym_tc")
    if lib.nbt_sym_tc_reduce.argtypes is None:
        for variant in VARIANTS:
            fn = getattr(lib, f"nbt_sym_{variant}_pairs")
            fn.argtypes = [_c_ptr, _c_ptr, _c_ll, _c_ll, _c_ll, _c_ll,
                           ctypes.c_float, _c_ptr, _c_ptr, _c_ptr]
            fn.restype = _c_int
        for fn in (lib.nbt_sym_tc_reduce, lib.nbt_sym_tc_descale_reduce):
            fn.argtypes = [_c_ptr, _c_ptr, _c_ll, _c_ll, _c_ll, _c_ll,
                           _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
                           ctypes.c_float, _c_ptr, _c_ptr]
            fn.restype = _c_int
        for variant in VARIANTS:
            fn = getattr(lib, f"nbt_rect_{variant}_pairs")
            fn.argtypes = RECT_PAIRS_ARGTYPES
            fn.restype = _c_int
        lib.nbt_rect_tc_reduce.argtypes = RECT_REDUCE_ARGTYPES
        lib.nbt_rect_tc_reduce.restype = _c_int
        lib.nbt_sym_tc_tile.argtypes = []
        lib.nbt_sym_tc_tile.restype = _c_int
        if lib.nbt_sym_tc_tile() != SYM_TILE:
            raise RuntimeError("SYM_TILE differs between forces_sym.py and "
                               "csrc/forces_sym_tc.cu")
    return lib


def pair_inv_fma(xi: torch.Tensor, xj: torch.Tensor,
                 eps2: float) -> torch.Tensor:
    """(..., Ti, 3), (..., Tj, 3) -> (..., Ti, Tj) rsqrt((|x_j - x_i|^2 +
    eps2)^3) as K5's trimmed geometry rounds it: d2 = fma(dz, dz, fma(dy,
    dy, fma(dx, dx, eps2))), each fused multiply-add rounded once to
    float32 from its float64 value (a float32 square is exact in float64;
    the sum then rounds twice, which differs from one rounding only at
    rare ties)."""
    d2 = torch.full((), torch.tensor(eps2, dtype=torch.float32).item(),
                    dtype=torch.float64, device=xi.device)
    for e in range(3):
        de = (xj[..., None, :, e] - xi[..., :, None, e]).double()
        d2 = (de * de + d2).float().double()
    d2 = d2.float()
    return torch.rsqrt(d2 * d2 * d2)


def _pair_tiles(xi, mi, xj, mj, eps2, variant, trimmed=True):
    """Row sums (force on i) and column sums (force on j) of the pair tiles
    (k, T, 3) x (k, T, 3) -> (k, T, 3), (k, T, 3), accelerations.
    ``trimmed``: the trimmed geometry for the variants whose square and
    rect kernels take it (``_TRIMMED``); K13's tiles keep ``pair_inv``."""
    inv = (pair_inv_fma if trimmed and variant in _TRIMMED
           else pair_inv)(xi, xj, eps2)                # (k, Ti, Tj)
    if variant in ("turbo", "turbop"):
        wi = (mj[:, None, :] * inv).to(torch.bfloat16).float()
        wj = (mi[:, :, None] * inv).to(torch.bfloat16).float()
        out_i = wi @ position_pack(xj)
        out_j = wj.transpose(1, 2) @ position_pack(xi)
    elif variant in ("turbo2", "turbof"):
        # One weight matrix for both sides.
        if variant == "turbo2":
            w = inv.to(torch.bfloat16).float()
            pj, pi = mass_folded_pack(xj, mj), mass_folded_pack(xi, mi)
        else:
            w = ((mi[:, :, None] * mj[:, None, :]) * inv).to(
                torch.bfloat16).float()
            pj, pi = position_pack(xj), position_pack(xi)
        out_i = w @ pj
        out_j = w.transpose(1, 2) @ pi
    else:
        hi, lo = bf16_split(inv)
        pj, pi = mass_folded_pack(xj, mj), mass_folded_pack(xi, mi)
        out_i = hi @ pj + lo @ pj
        out_j = hi.transpose(1, 2) @ pi + lo.transpose(1, 2) @ pi
    return tile_result(out_i, xi), tile_result(out_j, xj)


def forces_sym_tc_plain(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                        variant: str,
                        slot_budget: int = SLOT_BUDGET_BYTES) -> torch.Tensor:
    """Plain PyTorch twin of the kernels, with their tiles, enumeration,
    slot layout and reduction order (summation within a tile differs): the
    slot sums plus the exact diagonal tiles, descaled by 1/m for turbof."""
    pt, mt, raw = sweep_plain(
        pos, mass, slot_budget,
        lambda xi, mi, xj, mj: _pair_tiles(xi, mi, xj, mj, eps2, variant))
    if variant in _MASS_SCALED:
        return descale_plain(pt, mt, raw, pos, mass, eps2)
    return (diag_plain(pt, mt, eps2) + raw)[:pos.shape[0]]


def forces_sym_tc(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                  variant: str,
                  slot_budget: int = SLOT_BUDGET_BYTES) -> torch.Tensor:
    """Softened all-pairs accelerations (N,3),(N,) -> (N,3) through K5
    (``variant="turbo"``), K6 (``"mxu"``) or K14a-c (``"turbo2"``,
    ``"turbof"``, ``"turbop"``), each pair computed once."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    _build.check_bodies(f"forces_sym_{variant}", pos, mass)
    if pos.device.type == "cpu":
        return forces_sym_tc_plain(pos, mass, eps2, variant, slot_budget)
    lib = _lib()
    _COUNTERS[variant].launches += 1
    return sweep(f"forces_sym_{variant}", pos, mass, eps2, slot_budget,
                 getattr(lib, f"nbt_sym_{variant}_pairs"),
                 lib.nbt_sym_tc_descale_reduce if variant in _MASS_SCALED
                 else lib.nbt_sym_tc_reduce)


def forces_sym_turbo(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                     slot_budget: int = SLOT_BUDGET_BYTES) -> torch.Tensor:
    """K5 (``impl="pallas_sym_turbo"``)."""
    return forces_sym_tc(pos, mass, eps2, "turbo", slot_budget)


def forces_sym_mxu(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                   slot_budget: int = SLOT_BUDGET_BYTES) -> torch.Tensor:
    """K6 (``impl="pallas_sym_mxu"``)."""
    return forces_sym_tc(pos, mass, eps2, "mxu", slot_budget)


def forces_sym_turbo2(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                      slot_budget: int = SLOT_BUDGET_BYTES) -> torch.Tensor:
    """K14a (``impl="pallas_sym_turbo2"``)."""
    return forces_sym_tc(pos, mass, eps2, "turbo2", slot_budget)


def forces_sym_turbof(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                      slot_budget: int = SLOT_BUDGET_BYTES) -> torch.Tensor:
    """K14b (``variant="turbof"``)."""
    return forces_sym_tc(pos, mass, eps2, "turbof", slot_budget)


def forces_sym_turbop(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                      slot_budget: int = SLOT_BUDGET_BYTES) -> torch.Tensor:
    """K14c (``variant="turbop"``)."""
    return forces_sym_tc(pos, mass, eps2, "turbop", slot_budget)


# Force evaluations that launched K5, K6 and K14a-c, through any entry
# point.
forces_sym_turbo.launches = 0
forces_sym_mxu.launches = 0
forces_sym_turbo2.launches = 0
forces_sym_turbof.launches = 0
forces_sym_turbop.launches = 0
_COUNTERS = {"turbo": forces_sym_turbo, "mxu": forces_sym_mxu,
             "turbo2": forces_sym_turbo2, "turbof": forces_sym_turbof,
             "turbop": forces_sym_turbop}


# -- K2-rect on the tensor cores

def rect_forces_sym_tc_plain(pos_a, mass_a, pos_b, mass_b, eps2: float,
                             variant: str,
                             slot_budget: int = SLOT_BUDGET_BYTES):
    """Plain PyTorch twin of K2-rect for ``variant``: the square twin's
    pair tiles over the rect sweep's 256-wide tiles, enumeration, slots
    and reduction order, descaled by 1/m for turbof.  Returns (acc_a,
    acc_b)."""
    raw_a, raw_b = rect_sweep_plain(
        pos_a, mass_a, pos_b, mass_b, slot_budget,
        lambda xi, mi, xj, mj: _pair_tiles(xi, mi, xj, mj, eps2, variant))
    if variant not in _MASS_SCALED:
        return raw_a, raw_b
    return (rect_descale_plain(raw_a, pos_a, mass_a, pos_b, mass_b, eps2),
            rect_descale_plain(raw_b, pos_b, mass_b, pos_a, mass_a, eps2))


def rect_forces_sym_tc(pos_a, mass_a, pos_b, mass_b, eps2: float,
                       variant: str, slot_budget: int = SLOT_BUDGET_BYTES):
    """Cross accelerations of two disjoint body sets through K2-rect on
    the tensor cores (``variant`` turbo, mxu, turbo2, turbof or turbop):
    (na,3),(na,),(nb,3),(nb,) -> (acc_a, acc_b), each A x B pair computed
    once."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    counter = _RECT_COUNTERS[variant]
    check_rect_sets(counter.__name__, pos_a, mass_a, pos_b, mass_b)
    if pos_a.device.type == "cpu":
        return rect_forces_sym_tc_plain(pos_a, mass_a, pos_b, mass_b, eps2,
                                        variant, slot_budget)
    lib = _lib()
    counter.launches += 1
    return rect_sweep(counter.__name__, pos_a, mass_a, pos_b, mass_b, eps2,
                      slot_budget, getattr(lib, f"nbt_rect_{variant}_pairs"),
                      lib.nbt_rect_tc_reduce, variant in _MASS_SCALED)


def _rect_wrapper(variant):
    def wrapper(pos_a, mass_a, pos_b, mass_b, eps2: float,
                slot_budget: int = SLOT_BUDGET_BYTES):
        return rect_forces_sym_tc(pos_a, mass_a, pos_b, mass_b, eps2,
                                  variant, slot_budget)
    wrapper.__name__ = wrapper.__qualname__ = f"rect_forces_sym_{variant}"
    wrapper.__doc__ = f"K2-rect, variant {variant}."
    wrapper.launches = 0
    return wrapper


# Rect sweeps that launched K2-rect, by variant.
rect_forces_sym_turbo = _rect_wrapper("turbo")
rect_forces_sym_mxu = _rect_wrapper("mxu")
rect_forces_sym_turbo2 = _rect_wrapper("turbo2")
rect_forces_sym_turbof = _rect_wrapper("turbof")
rect_forces_sym_turbop = _rect_wrapper("turbop")
_RECT_COUNTERS = {"turbo": rect_forces_sym_turbo,
                  "mxu": rect_forces_sym_mxu,
                  "turbo2": rect_forces_sym_turbo2,
                  "turbof": rect_forces_sym_turbof,
                  "turbop": rect_forces_sym_turbop}
