"""The pair-symmetric force tiers by variant and grid schedule: the
counterpart of ``nbody_tpu/ops/forces_pallas_sym.py::forces_pallas_sym``
(``variant=``, ``schedule=``).

Every variant of the JAX vocabulary runs on a hand-written kernel here:

========  ==========  ==============================================
variant   classic     fold
========  ==========  ==============================================
vpu2      K2          K14d with K2's math (``forces_sym_fold``)
vpu       K7          K14d with K7's math (``forces_sym_vpu_fold``)
turbo     K5          refused
mxu       K6          refused
turbo2    K14a        refused
turbof    K14b        refused
turbop    K14c        refused
========  ==========  ==============================================

The classic schedule's tiles are fixed at 256 bodies (``SYM_TILE``); the
fold schedule's superblock is ``block_u`` bodies (default
``FOLD_BLOCK_U``), JAX's ``block_u`` at the port's 256-body ``block_i``.
The pair-symmetric impls are variants on the classic schedule
(``SYM_IMPL_VARIANTS``), as in the JAX package; ``ops/forces.py`` takes
their kernels from ``CLASSIC``, so a variant's kernel is named once.
"""

from __future__ import annotations

from typing import Optional

import torch

from .forces_sym import (FOLD_BLOCK_U, SLOT_BUDGET_BYTES, SYM_TILE,
                         forces_sym, forces_sym_fold, forces_sym_vpu,
                         forces_sym_vpu_fold)
from .forces_sym_tc import (forces_sym_mxu, forces_sym_turbo,
                            forces_sym_turbo2, forces_sym_turbof,
                            forces_sym_turbop)

SYM_VARIANTS = ("vpu", "vpu2", "turbo", "turbof", "turbo2", "mxu",
                "turbop")
SYM_SCHEDULES = ("classic", "fold")
_FOLD_VARIANTS = ("vpu", "vpu2")

CLASSIC = {"vpu2": forces_sym, "vpu": forces_sym_vpu,
           "turbo": forces_sym_turbo, "mxu": forces_sym_mxu,
           "turbo2": forces_sym_turbo2, "turbof": forces_sym_turbof,
           "turbop": forces_sym_turbop}
# impl -> its variant (K2, K7, K5, K6, K14a).
SYM_IMPL_VARIANTS = {"pallas_sym2": "vpu2", "pallas_sym": "vpu",
                     "pallas_sym_turbo": "turbo", "pallas_sym_mxu": "mxu",
                     "pallas_sym_turbo2": "turbo2"}
_FOLD = {"vpu2": forces_sym_fold, "vpu": forces_sym_vpu_fold}


def resolve_schedule(schedule: Optional[str], variant: str) -> str:
    """``None`` -> ``"classic"`` for every variant; ``"fold"`` only for the
    exact tiers vpu and vpu2."""
    if schedule is None:
        return "classic"
    if schedule not in SYM_SCHEDULES:
        raise ValueError(
            f"schedule must be one of {SYM_SCHEDULES} or None, "
            f"got {schedule!r}")
    if schedule == "fold" and variant not in _FOLD_VARIANTS:
        raise ValueError(
            f"schedule='fold' applies to the exact tiers {_FOLD_VARIANTS}, "
            f"not {variant!r}")
    return schedule


def forces_pallas_sym(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                      variant: str = "vpu", schedule: Optional[str] = None,
                      block_u: Optional[int] = None,
                      slot_budget: int = SLOT_BUDGET_BYTES) -> torch.Tensor:
    """Softened all-pairs accelerations (N,3),(N,) -> (N,3), each pair
    computed once, through the kernel of ``variant`` on ``schedule``."""
    if variant not in SYM_VARIANTS:
        raise ValueError(
            f"variant must be one of {SYM_VARIANTS}, got {variant!r}")
    if resolve_schedule(schedule, variant) == "fold":
        return _FOLD[variant](pos, mass, eps2, block_u or FOLD_BLOCK_U,
                              slot_budget)
    if block_u not in (None, SYM_TILE):
        raise ValueError(f"the classic schedule's tiles are {SYM_TILE} "
                         f"bodies wide, got block_u={block_u}")
    return CLASSIC[variant](pos, mass, eps2, slot_budget)
