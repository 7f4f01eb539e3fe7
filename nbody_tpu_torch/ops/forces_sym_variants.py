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

``rect_forces_sym`` is the same table for two disjoint body sets (K2-rect,
``nbody_tpu/ops/forces_pallas_sym.py:1240``): every variant on the
classic schedule, vpu and vpu2 also on the fold schedule, each A x B pair
once, the acceleration of A from B and of B from A.  It is the cross
rotation of the Newton's-third-law ring (``parallel/ring.py``).

K15, the bench-only ablations of K7's pair tile and K5's tile
(``ops/ablation_sym.py``), are not in these tables:
``ablation_sym.enable()`` registers them in ``ABLATION_SYM_KERNELS`` and
``ABLATION_RECT_KERNELS`` and adds their names to ``SYM_VARIANTS``, and
both entry points check the registries before ``CLASSIC`` and
``RECT_CLASSIC``.  They run on the classic schedule only; no impl,
``auto``, ``SimConfig`` or CLI verb reaches them, as in the JAX package.

The classic schedule's tiles are fixed at 256 bodies (``SYM_TILE``); the
fold schedule's superblock is ``block_u`` bodies (default
``FOLD_BLOCK_U``), JAX's ``block_u`` at the port's 256-body ``block_i``.
The pair-symmetric impls are variants on the classic schedule
(``SYM_IMPL_VARIANTS``), as in the JAX package; ``ops/forces.py`` takes
their kernels from ``CLASSIC``, so a variant's kernel is named once.

``forces_pallas_sym_chunked`` and ``forces_pallas_sym_chunked_flat`` are
the bounded dispatch (JAX's ``forces_pallas_sym_chunked*``): the same
sweep with its offset chunks grouped into programs of at most
``max_prog_interactions`` interactions (``DEFAULT_PROG_CAP``, as in the
JAX package) and ``progress(done, total, out)`` after each program;
bit-equal to ``forces_pallas_sym``.  Both entry points also take
``progress`` and ``max_prog_interactions`` themselves, which the bounded
mesh (``parallel/multiprog.py``) passes through the ring.
"""

from __future__ import annotations

from typing import Optional

import torch

from .forces_sym import (FOLD_BLOCK_U, SLOT_BUDGET_BYTES, SYM_TILE,
                         forces_sym, forces_sym_fold, forces_sym_vpu,
                         forces_sym_vpu_fold, rect_forces_sym_fold,
                         rect_forces_sym_vpu, rect_forces_sym_vpu2,
                         rect_forces_sym_vpu_fold)
from .forces_sym_tc import (forces_sym_mxu, forces_sym_turbo,
                            forces_sym_turbo2, forces_sym_turbof,
                            forces_sym_turbop, rect_forces_sym_mxu,
                            rect_forces_sym_turbo, rect_forces_sym_turbo2,
                            rect_forces_sym_turbof, rect_forces_sym_turbop)

SYM_VARIANTS = ("vpu", "vpu2", "turbo", "turbof", "turbo2", "mxu",
                "turbop")
# Interactions a program of the bounded dispatch when the config names no
# cap (``nbody_tpu/ops/forces_pallas_sym.py``'s value: one evaluation at
# N = 4,194,304 is 1.76e13, two programs).
DEFAULT_PROG_CAP = 1.2e13
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
RECT_CLASSIC = {"vpu2": rect_forces_sym_vpu2, "vpu": rect_forces_sym_vpu,
                "turbo": rect_forces_sym_turbo, "mxu": rect_forces_sym_mxu,
                "turbo2": rect_forces_sym_turbo2,
                "turbof": rect_forces_sym_turbof,
                "turbop": rect_forces_sym_turbop}
_RECT_FOLD = {"vpu2": rect_forces_sym_fold, "vpu": rect_forces_sym_vpu_fold}
# K15's wrappers by name, filled by ops/ablation_sym.py's enable().
ABLATION_SYM_KERNELS: "dict[str, object]" = {}
ABLATION_RECT_KERNELS: "dict[str, object]" = {}


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


def _check_variant(variant: str) -> None:
    if variant not in SYM_VARIANTS:
        raise ValueError(
            f"variant must be one of {SYM_VARIANTS}, got {variant!r}; the "
            f"bench-only ablations register through "
            f"nbody_tpu_torch.ops.ablation_sym.enable()")


def forces_pallas_sym(pos: torch.Tensor, mass: torch.Tensor, eps2: float,
                      variant: str = "vpu", schedule: Optional[str] = None,
                      block_u: Optional[int] = None,
                      slot_budget: int = SLOT_BUDGET_BYTES, progress=None,
                      max_prog_interactions: Optional[float] = None
                      ) -> torch.Tensor:
    """Softened all-pairs accelerations (N,3),(N,) -> (N,3), each pair
    computed once, through the kernel of ``variant`` on ``schedule``
    (``progress``, ``max_prog_interactions``: the bounded dispatch of
    ``ops/forces_sym.py::sweep``)."""
    _check_variant(variant)
    if resolve_schedule(schedule, variant) == "fold":
        return _FOLD[variant](pos, mass, eps2, block_u or FOLD_BLOCK_U,
                              slot_budget, progress, max_prog_interactions)
    if block_u not in (None, SYM_TILE):
        raise ValueError(f"the classic schedule's tiles are {SYM_TILE} "
                         f"bodies wide, got block_u={block_u}")
    kernel = ABLATION_SYM_KERNELS.get(variant) or CLASSIC[variant]
    return kernel(pos, mass, eps2, slot_budget, progress,
                  max_prog_interactions)


def forces_pallas_sym_chunked(pos: torch.Tensor, mass: torch.Tensor,
                              eps2: float, variant: str = "vpu",
                              max_prog_interactions: float = DEFAULT_PROG_CAP,
                              progress=None, schedule: Optional[str] = None,
                              block_u: Optional[int] = None,
                              slot_budget: int = SLOT_BUDGET_BYTES
                              ) -> torch.Tensor:
    """``forces_pallas_sym`` as bounded programs of at most
    ``max_prog_interactions`` interactions (N^2 an evaluation, two a
    pair), ``progress(done, total, out)`` called after each program is
    queued; bit-equal to ``forces_pallas_sym``.  On the card a program
    is a run of launches with no host wait between them: the bound sets
    how often the host hears from a long evaluation, nothing else."""
    return forces_pallas_sym(pos, mass, eps2, variant, schedule, block_u,
                             slot_budget, progress, max_prog_interactions)


def forces_pallas_sym_chunked_flat(
        pos_flat: torch.Tensor, mass: torch.Tensor, eps2: float,
        variant: str = "vpu",
        max_prog_interactions: float = DEFAULT_PROG_CAP, progress=None,
        schedule: Optional[str] = None, block_u: Optional[int] = None,
        slot_budget: int = SLOT_BUDGET_BYTES) -> torch.Tensor:
    """``forces_pallas_sym_chunked`` on flat row-major ``(3N,)`` positions:
    runs on the ``(N, 3)`` view and returns the ``(3N,)`` view of the
    accelerations."""
    n = mass.shape[0]
    if pos_flat.shape != (3 * n,):
        raise ValueError(f"pos_flat must be row-major (3N,) = ({3 * n},), "
                         f"got {tuple(pos_flat.shape)}")
    return forces_pallas_sym_chunked(
        pos_flat.view(n, 3), mass, eps2, variant, max_prog_interactions,
        progress, schedule, block_u, slot_budget).view(-1)


def rect_forces_sym(pos_a: torch.Tensor, mass_a: torch.Tensor,
                    pos_b: torch.Tensor, mass_b: torch.Tensor, eps2: float,
                    block_i: Optional[int] = None,
                    block_u: Optional[int] = None,
                    panel_nb: Optional[int] = None, variant: str = "vpu",
                    schedule: Optional[str] = None,
                    slot_budget: int = SLOT_BUDGET_BYTES, progress=None,
                    max_prog_interactions: Optional[float] = None):
    """Two-sided rect sweep between two disjoint body sets (K2-rect):
    every (a, b) pair computed once; returns ``(acc_a, acc_b)``, the
    accelerations of the a-bodies from the b-bodies and of the b-bodies
    from the a-bodies, (na,3) and (nb,3).

    The kernels mask the ragged tails of both sets at load time, so
    nothing is padded.  ``block_i`` and ``panel_nb`` are the JAX
    signature's VMEM knobs and are ignored: ``panel_nb`` cuts B into panels
    whose resident scatter buffer fits a core's VMEM, where the card's
    slots live in device memory, chunked to ``slot_budget`` bytes.
    ``block_u`` is the fold schedule's superblock (default
    ``FOLD_BLOCK_U``); the classic schedule's tiles are 256 bodies.  As in
    the JAX package, the fold schedule needs A in whole superblocks and
    takes the classic sweep otherwise (the same accelerations up to
    summation order)."""
    del block_i, panel_nb
    _check_variant(variant)
    if resolve_schedule(schedule, variant) == "fold":
        block_u = block_u or FOLD_BLOCK_U
        if pos_a.shape[0] % block_u == 0:
            return _RECT_FOLD[variant](pos_a, mass_a, pos_b, mass_b, eps2,
                                       block_u, slot_budget, progress,
                                       max_prog_interactions)
    elif block_u not in (None, SYM_TILE):
        raise ValueError(f"the classic schedule's tiles are {SYM_TILE} "
                         f"bodies wide, got block_u={block_u}")
    kernel = ABLATION_RECT_KERNELS.get(variant) or RECT_CLASSIC[variant]
    return kernel(pos_a, mass_a, pos_b, mass_b, eps2, slot_budget, progress,
                  max_prog_interactions)
