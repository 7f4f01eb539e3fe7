"""K3 and K4: the resident multi-step kernels, hand-written in CUDA.

The counterpart of ``nbody_tpu/ops/resident.py``: ``n_steps`` whole steps
in one launch, with no host round trip between them.  K3
(``_make_resident_kernel``) runs the reference scheme, K4
(``_make_resident_kernel_kdk``) the KDK-composed schemes (``kdk``,
``yoshida4``; like ``run_steps`` they consume ``state.acc`` as the seeded
a(x_0), see ``prime_kdk``).  The kernels are in ``csrc/resident.cu``: one
cooperative launch whose grid the card holds at once, the state in device
memory, and a dataflow schedule with no grid-wide barrier between steps:
K2's diagonal and pair tiles as work items (``work_items``, each block
taking every ``grid``-th: ``block_items``), each row tile finished (K2's
fixed-order slot sum, the descale and the integrator, into the next of
two position buffers) in groups of 32 bodies, one warp each, spread over
the grid (``finish_groups``), once its count of contributions holds the
step's ``nb``, and each item waiting for its tiles' previous step.  The pair, slot and
diagonal code is K2's own (``csrc/sym_common.cuh``), the slots are added
in K2's order, and the integrator rounds as PyTorch's separate multiply
and add kernels do, so K3 over k steps is bit-equal to k steps of
``run_steps(..., impl="pallas_sym2")``.

Not ported, because they exist only for the TPU: the VMEM layout search
(``resident_layout``, ``_layout_vmem_bytes``, ``_layout_cost``) and the
(3, U)-per-superblock transposed state.  The scope bound that replaces
the layout search is the slot memory: every offset's slots are held at
once, so N is in scope while they fit ``forces_sym.SLOT_BUDGET_BYTES``
(``RESIDENT_MAX_N``); the grid is the card's co-resident limit, which
bounds no N because every block strides over the items.

The wrappers take the plain PyTorch version (``run_steps_resident_plain``:
``forces_sym_plain`` plus the plain integrator, step by step) only for CPU
tensors.  For a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.integrators import (KDK_WEIGHTS, kdk_drift, kdk_kick,
                                  reference_update)
from ..models.state import SimState
from . import _build
from .forces_sym import SLOT_BUDGET_BYTES, SYM_TILE, forces_sym_plain

# Implementations the resident kernels stand in for, as in the JAX
# package: they compute K2's math, and every exact pair-symmetric request
# (K2's pallas_sym2, K7's pallas_sym) routes there alike.
RESIDENT_IMPLS = ("pallas_sym2", "pallas_sym")


def _slot_bytes(n: int) -> int:
    """Bytes of the i- and j-side slots of every offset at once."""
    nb = -(-n // SYM_TILE)
    return 2 * (nb // 2) * nb * SYM_TILE * 3 * 4


# Largest N whose slots fit the budget: 214,016 bodies for 2 GiB.
RESIDENT_MAX_N = max(n for n in range(SYM_TILE, 1 << 19, SYM_TILE)
                     if _slot_bytes(n) <= SLOT_BUDGET_BYTES)

# Auto window on the card, from chip_smoke.py's resident crossover on an
# H100 80GB HBM3 at 700 W (median ms/step of 5 rounds of 1000-step chunks,
# K3 against per-step K2 through run_steps; PERF.md §6, "Crossover"),
# since K3's dataflow schedule: K3 ahead 5.69x at N=1536, 4.40x at
# 4096, 2.07x at 8192, 1.16x at 12288 and 1.12x at 16384, behind 0.98x at
# 20480, 24576 and 32768; yoshida4 (K4, 200-step chunks) 7.68x, 5.64x,
# 2.21x, 1.52x, 1.13x, then 0.98x.  (Before it, the barrier schedule: ahead
# 1.08x at 12288, behind 0.94x at 16384.)  The window starts where auto
# hands the force evaluation to K2 (SYM_CROSSOVER_N); below it auto runs
# K1 per step.
RESIDENT_AUTO_MIN_N = 1536
RESIDENT_AUTO_MAX_N = 16384

_c_ll, _c_ptr, _c_int, _c_f = (ctypes.c_longlong, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_float)


def _lib():
    lib = _build.load("resident")
    if lib.nbt_resident.argtypes is None:
        lib.nbt_resident.argtypes = [
            _c_ptr, _c_ptr, _c_ptr, _c_ll, _c_ll, _c_f, _c_f, _c_f, _c_int,
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
            _c_ptr]
        lib.nbt_resident.restype = _c_int
        lib.nbt_resident_kdk.argtypes = [
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ll, _c_ll, _c_f,
            ctypes.POINTER(_c_f), ctypes.POINTER(_c_f), _c_int, _c_int,
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
            _c_ptr]
        lib.nbt_resident_kdk.restype = _c_int
        lib.nbt_resident_max_blocks.argtypes = [_c_int]
        lib.nbt_resident_max_blocks.restype = _c_int
        lib.nbt_resident_grid.argtypes = [_c_ll, _c_int]
        lib.nbt_resident_grid.restype = _c_int
        lib.nbt_resident_group_warps.argtypes = [_c_ll, _c_ll]
        lib.nbt_resident_group_warps.restype = _c_int
        lib.nbt_resident_tile.argtypes = []
        lib.nbt_resident_tile.restype = _c_int
        if _build.query(None, lib.nbt_resident_tile) != SYM_TILE:
            raise RuntimeError("SYM_TILE differs between forces_sym.py and "
                               "csrc/sym_common.cuh")
    return lib


def max_blocks(kdk: bool = False, device="cuda") -> int:
    """The co-resident grid ``device``'s card holds for K3 (K4 with
    ``kdk``)."""
    return _build.query(device, _lib().nbt_resident_max_blocks, int(kdk))


def launch_grid(nb: int, kdk: bool = False, device="cuda") -> int:
    """The grid the launch of K3 (K4 with ``kdk``) on ``device``'s card
    takes for ``nb`` row tiles: ``resident_grid(nb, max_blocks(kdk))``."""
    return _build.query(device, _lib().nbt_resident_grid, nb, int(kdk))


# -- the kernels' work assignment, mirrored in Python (csrc/resident.cu)

@functools.lru_cache(maxsize=4)
def work_items(nb: int) -> tuple:
    """One step's work items in the kernels' order: ``(I, 0)``, the
    diagonal item of row tile I, for I < nb; then the pair items ``(I,
    d)`` of row tile I and column tile (I + d) mod nb, offset by offset
    for d = 1 .. nb // 2, where an even nb's half offset has its nb // 2
    items with I < nb // 2 (the others would pair the same tiles again).
    nb (nb + 1) // 2 items."""
    items = [(i, 0) for i in range(nb)]
    for p in range(nb * (nb - 1) // 2):
        dk, i = divmod(p, nb)
        items.append((i, 1 + dk))
    return tuple(items)


def resident_grid(nb: int, cap: int) -> int:
    """Blocks of a launch: a step's items, at most the co-resident
    ``cap``."""
    return min(nb * (nb + 1) // 2, cap)


def block_items(nb: int, grid: int, block: int) -> tuple:
    """The items block ``block`` of ``grid`` runs each step: every
    grid-th from its own index."""
    return work_items(nb)[block::grid]


# A tile's finish is cut into groups of 32 bodies, one warp each.
GROUPS_PER_TILE = SYM_TILE // 32


def group_warps(nb: int, grid: int) -> int:
    """Warps of a block that take finish groups: the fewest that cover a
    step's 8 nb groups in one round of the grid, at most all 8."""
    return min(-(-GROUPS_PER_TILE * nb // grid), GROUPS_PER_TILE)


def kernel_group_warps(nb: int, grid: int) -> int:
    """``group_warps`` as the kernels compute it (csrc/resident.cu)."""
    return _build.query(None, _lib().nbt_resident_group_warps, nb, grid)


def finish_groups(nb: int, grid: int) -> dict:
    """{(block, warp): [group, ...]} of a step's tile finishes: group q
    (bodies 32 q .. 32 q + 31, of row tile q // 8) runs on block q % grid,
    warp (q // grid) % group_warps, in round q // (grid * group_warps);
    lane l of that warp takes body 32 q + l."""
    wa = group_warps(nb, grid)
    out = {}
    for q in range(GROUPS_PER_TILE * nb):
        out.setdefault((q % grid, (q // grid) % wa), []).append(q)
    return out


def should_use_resident(cfg, impl: str, sharded: bool = False) -> bool:
    """Decide resident routing for this run, as the JAX package does.

    ``cfg.resident`` wins: False disables; True forces and raises naming
    every reason the run is out of scope (integrator, dtype, impl, N past
    ``RESIDENT_MAX_N``).  None is auto: in scope and N inside the window
    measured on the card.  A ``sharded`` run (on a mesh) never takes the
    resident kernels, which hold one device's whole state in one launch:
    forcing them there raises, after the reasons above."""
    if cfg.resident is False:
        return False
    if sharded:
        if cfg.resident is True:
            should_use_resident(cfg, impl)
            raise ValueError(
                "resident=True but mesh routing (shards) preempts the "
                "resident kernels (they run one device's whole state in one "
                "launch); drop --resident on or --shards")
        return False
    reasons = []
    if cfg.integrator != "reference" and cfg.integrator not in KDK_WEIGHTS:
        reasons.append(f"integrator={cfg.integrator!r} (needs 'reference' "
                       "or a KDK-composed scheme)")
    if cfg.dtype != "float32":
        reasons.append(f"dtype={cfg.dtype!r} (the kernel is float32-only)")
    if impl not in RESIDENT_IMPLS:
        reasons.append(f"impl={impl!r} (the exact pair-symmetric tiers "
                       f"{', '.join(RESIDENT_IMPLS)} only)")
    if cfg.n_bodies > RESIDENT_MAX_N:
        reasons.append(
            f"N={cfg.n_bodies} > {RESIDENT_MAX_N}: the slots of every "
            f"offset would take {_slot_bytes(cfg.n_bodies)} bytes, more than "
            f"the {SLOT_BUDGET_BYTES}-byte budget")
    if reasons:
        if cfg.resident is True:
            raise ValueError("resident=True but the resident kernels are out "
                             "of scope: " + "; ".join(reasons))
        return False
    if cfg.resident is True:
        return True
    return RESIDENT_AUTO_MIN_N <= cfg.n_bodies <= RESIDENT_AUTO_MAX_N


def _check_state(pos, vel, mass, *extra):
    _build.check_bodies("resident", pos, mass)
    for t in (vel, *extra):
        if (t.dtype != torch.float32 or t.shape != pos.shape
                or t.device != pos.device or not t.is_contiguous()):
            raise ValueError("resident: vel and acc must be contiguous "
                             f"float32 {tuple(pos.shape)} tensors on "
                             f"{pos.device}")
    if pos.shape[0] > RESIDENT_MAX_N:
        raise ValueError(f"resident: N={pos.shape[0]} > RESIDENT_MAX_N="
                         f"{RESIDENT_MAX_N} (slot memory)")


def resident_steps_plain(pos, vel, mass, eps2: float, dt: float,
                         n_steps: int):
    """Plain twin of K3: K2's plain version and the reference update,
    step by step.  Returns (pos, vel, acc)."""
    acc = torch.zeros_like(pos)
    for _ in range(n_steps):
        acc = forces_sym_plain(pos, mass, eps2)
        pos, vel = reference_update(pos, vel, acc, dt)
    return pos, vel, acc


def resident_steps_kdk_plain(pos, vel, acc, mass, eps2: float, dt: float,
                             weights, n_steps: int):
    """Plain twin of K4: the KDK sub-steps of ``ops/step.py::step`` on
    K2's plain version.  Returns (pos, vel, acc)."""
    for _ in range(n_steps):
        for w in weights:
            wdt = w * dt
            vel_half = kdk_kick(vel, acc, wdt)
            pos = kdk_drift(pos, vel_half, wdt)
            acc = forces_sym_plain(pos, mass, eps2)
            vel = kdk_kick(vel_half, acc, wdt)
    return pos, vel, acc


def _scratch(pos):
    """nb and the kernels' scratch: the second position buffer, per-body
    diagonal sums, i- and j-side slots of every offset, and the per-tile
    counts of contributions and of finished groups (zero)."""
    n = pos.shape[0]
    nb = -(-n // SYM_TILE)
    slot_len = max(1, (nb // 2) * nb * SYM_TILE * 3)
    return (nb, pos.new_empty(n, 3), pos.new_empty(n, 3),
            pos.new_empty(slot_len), pos.new_empty(slot_len),
            torch.zeros(2 * nb, dtype=torch.int64, device=pos.device))


def resident_steps(pos, vel, mass, eps2: float, dt: float, n_steps: int):
    """``n_steps`` reference-scheme steps through K3 in one launch.
    Returns new (pos, vel, acc); the inputs are not written."""
    _check_state(pos, vel, mass)
    if pos.device.type == "cpu":
        return resident_steps_plain(pos, vel, mass, eps2, dt, n_steps)
    lib = _lib()
    nb, pos_tmp, diag, si, sj, flags = _scratch(pos)
    pos_out, vel_out = torch.empty_like(pos), torch.empty_like(vel)
    acc_out = torch.empty_like(pos)
    resident_steps.launches += 1
    _build.launch("resident (K3)", pos, lib.nbt_resident, pos.data_ptr(),
                  vel.data_ptr(), mass.data_ptr(), pos.shape[0], nb,
                  float(eps2), 0.5 * dt, dt, n_steps, pos_out.data_ptr(),
                  vel_out.data_ptr(), acc_out.data_ptr(), pos_tmp.data_ptr(),
                  diag.data_ptr(), si.data_ptr(), sj.data_ptr(),
                  flags.data_ptr())
    return pos_out, vel_out, acc_out


def resident_steps_kdk(pos, vel, acc, mass, eps2: float, dt: float,
                       weights, n_steps: int):
    """``n_steps`` KDK-composed steps of sub-step ``weights`` through K4 in
    one launch.  Returns new (pos, vel, acc); the inputs are not written."""
    _check_state(pos, vel, mass, acc)
    if pos.device.type == "cpu":
        return resident_steps_kdk_plain(pos, vel, acc, mass, eps2, dt,
                                        weights, n_steps)
    if not 1 <= len(weights) <= 3:
        raise ValueError(f"resident (K4): 1 to 3 sub-step weights, got "
                         f"{len(weights)}")
    lib = _lib()
    nb, pos_tmp, diag, si, sj, flags = _scratch(pos)
    # Rounded to float32 from double, as PyTorch rounds a Python scalar.
    h = (_c_f * 3)(*[0.5 * (w * dt) for w in weights])
    wdt = (_c_f * 3)(*[w * dt for w in weights])
    pos_out, vel_out = torch.empty_like(pos), torch.empty_like(vel)
    acc_out = torch.empty_like(acc)
    resident_steps_kdk.launches += 1
    _build.launch("resident (K4)", pos, lib.nbt_resident_kdk, pos.data_ptr(),
                  vel.data_ptr(), acc.data_ptr(), mass.data_ptr(),
                  pos.shape[0], nb, float(eps2), h, wdt, len(weights),
                  n_steps, pos_out.data_ptr(), vel_out.data_ptr(),
                  acc_out.data_ptr(), pos_tmp.data_ptr(), diag.data_ptr(),
                  si.data_ptr(), sj.data_ptr(), flags.data_ptr())
    return pos_out, vel_out, acc_out


# K3 / K4 launches made through the wrappers.
resident_steps.launches = 0
resident_steps_kdk.launches = 0


def _weights(cfg):
    if cfg.integrator == "reference":
        return None
    weights = KDK_WEIGHTS.get(cfg.integrator)
    if weights is None:
        raise ValueError(
            "resident mode implements the reference integrator and the "
            f"KDK-composed schemes; got {cfg.integrator!r}")
    return weights


def run_steps_resident_plain(state: SimState, cfg, n_steps: int) -> SimState:
    """The plain version of ``run_steps_resident``, on any device."""
    weights = _weights(cfg)
    if n_steps < 1:
        return state
    if weights is None:
        out = resident_steps_plain(state.pos, state.vel, state.mass,
                                   cfg.eps2, cfg.dt, n_steps)
    else:
        out = resident_steps_kdk_plain(state.pos, state.vel, state.acc,
                                       state.mass, cfg.eps2, cfg.dt, weights,
                                       n_steps)
    return SimState(*out, mass=state.mass)


def run_steps_resident(state: SimState, cfg, n_steps: int) -> SimState:
    """Advance ``n_steps`` steps in one launch of K3 (reference scheme) or
    K4 (``kdk``, ``yoshida4``).  Raises ValueError out of scope."""
    weights = _weights(cfg)
    if n_steps < 1:
        return state
    if weights is None:
        out = resident_steps(state.pos, state.vel, state.mass, cfg.eps2,
                             cfg.dt, n_steps)
    else:
        out = resident_steps_kdk(state.pos, state.vel, state.acc, state.mass,
                                 cfg.eps2, cfg.dt, weights, n_steps)
    return SimState(*out, mass=state.mass)
