#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nbody_tpu_torch/csrc`` into a clean
build directory (one ``nvcc`` per source, all at once), holds each kernel
against its plain PyTorch version on the card (K1, K2; the resident
kernels K3 and K4 also bit for bit against the per-step K2 path; K8's row
sums also against a float64 direct sum at N = 1,048,576, its symmetric
total against its twin, a float64 total at N = 65,536 and the row sums'
total at 1M; the tensor-core tiers K9,
K10, K5 and K6 also against their tier gates on a float64 direct sum, K5
at N = 1,048,576 too; the exact tiers K7 and K11 and the centred tier K12,
on Morton-sorted bodies, at their float64 gates; K12 also on unsorted
bodies, with planted close pairs, and on 4096 sorted rows at N = 1M;
K11 also against K1; the K14 variants turbo2 and turbof at turbo's
float64 gate at 8192 and on sampled rows at 1M, turbof with massless
bodies, turbop bit for bit against K5, and the fold schedule at the exact
gate and against classic K2/K7 at 8192 and 1M; K2-rect, every variant
and both schedules, at the shard shapes 2048 x 2048 and 2144 x 1536, at
its float64 gates and with massless bodies on both sides, and at the 1M
ring's 262,144 x 262,144 shard pair on sampled rows against float64;
K15, the seven bench-only ablations in both sweeps, after
``ablation_sym.enable()``, at N = 8192 and 2048 x 6144, vpu_rc and
tmm_full also at their float64 gates and bit for bit against K7 / K5,
then timed at N = 1M in interleaved rounds with K7, K5 and turbop, also
held at their control's CTAs per SM, and checked and timed at the
262,144 x 262,144 shard pair; K13, the fused ring, every variant on 1, 2,
3, 4, 5 and 8 shards at N = 8192, both protocols, bit-reproducible and
chunk-invariant, at its tiers' float64 gates and with real massless
bodies), checks K2 at
N = 1,048,576 against the direct-form ``rect_forces``, times K8 and K5
against their designs before the redesign for this card (the sources
of PARENT_COMMIT, built beside the package's) in alternating rounds at
N = 8192 and 1,048,576, and holds every other kernel's SASS to theirs
(``tools/ptxas_compare.py``, in the background), then drives the
port's main paths through the CLI with the kernels' launch counters reset
just before and read just after: ``validate`` at N = 8192 (exact with K1,
K2, K7 and K11, and each tensor-core tier, ``pallas_sym_turbo2`` among
them), ``validate --shards P`` through the mesh on this card (the N3L
ring with K2-rect on its cross rotations for pallas_sym2, pallas_sym,
pallas_sym_turbo, pallas_sym_mxu and pallas_sym_turbo2; the all-gather;
the fused ring K13 with ``--comm rdma`` and ``rdma_overlap``, one launch a
force evaluation, also with ``--oracle native`` and through ``run``),
the variant / schedule entry points ``forces_pallas_sym`` and
``rect_forces_sym`` for turbof, turbop and the fold schedule, K8's row
sums ``pe_rows`` and, after
``ablation_sym.enable()``, for each K15 ablation, and the
``run`` verb (resident K3 with a
checkpoint, K4 with yoshida4, auto routing, N = 1M with ``--energy``,
N = 1M with ``pallas_sym_turbo`` and with ``pallas_sym_turbo2``, K12 with
``--sort-every`` at N = 8192 and 1M, and a resume that must equal one
uninterrupted run).
Then 200 steps under the momentum and angular-momentum gates, the K1/K2
and resident crossovers that set ``auto``, one 4-shard N3L-ring step and
one 4-shard K13 step at N = 1M against the single-device K2 step (on the
rows where the ring and K2 differ, each of the ring's kernels and K13
against float64; K13's phases by partial launches), and the bench lines.
Any failed check raises and the script exits nonzero; without a CUDA
card it exits 1 before doing anything.

The last three lines of standard output are the kernels' JSON record, the
``nvidia-smi`` name / power-limit line, and
``{"ok": true, "device": {...}}``.
"""

import atexit
import contextlib
import importlib.metadata
import importlib.util
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time

# Same tolerance as the CPU tests: per component, relative 1e-4 with an
# absolute floor of 1e-6 of the largest |a|, and no component outside it.
REL_TOL = 1e-4
ABS_FLOOR = 1e-6

# The tensor-core tiers against their plain twins: per component, relative
# 1e-3 with an absolute floor of 1e-4 of the largest |a|.  Both round the
# same float32 weights to bf16 (the kernels' geometry is rounded step by
# step as the twins round it); what differs is the order of the float32
# sums inside the per-tile correction sum w x_j - x_i sum w, whose terms
# are ~|x| sum w against a net of ~|r| sum w.  The same tolerance as the
# CPU tests hold between the twins and the JAX package.
TC_REL_TOL = 1e-3
TC_ABS_FLOOR = 1e-4
# Tier gates against a float64 direct sum (the JAX package's own tests):
# kernel -> (p99 of the relative error or None, largest fraction of
# components outside the 1% gate with a 1e-4 absolute floor).
TIER_GATES = {"forces_tiled_turbo": (5e-2, 0.1),
              "forces_tiled_mxu": (None, 1e-3),
              "forces_sym_turbo": (5e-2, 0.1),
              "forces_sym_mxu": (5e-3, 5e-3),
              "forces_sym_turbo2": (5e-2, 0.1),
              "forces_sym_turbof": (5e-2, 0.1),
              # The exact tiers at validate's acc allowance; K12 at its JAX
              # test's gate, on Morton-sorted bodies.
              "forces_sym_vpu": (None, 5e-4),
              "forces_tiled_kahan": (None, 5e-4),
              "forces_sym_fold": (None, 5e-4),
              "forces_sym_vpu_fold": (None, 5e-4),
              "forces_fast": (None, 1e-3)}
# K12 against its plain twin, sorted or not: per component, relative 1e-3
# with an absolute floor of 1e-4 of the largest |a|, the tensor-core
# tiers' tolerance.  The two sum the cross product and the accumulate
# products in other orders, and the centred |u|^2 - 2 u.v + |v|^2 cancels
# what they differ by less for Morton-sorted bodies than for unsorted
# ones; at N=8192 the sorted outputs differed by 8.96e-5 of the largest
# |a| on an H100.  Dropping a bf16 limb of f or of the K=18 pack moves a
# pair's force by ~2^-9 or more.
FAST_REL_TOL = 1e-3
# A pair just outside the close-pair test keeps ~10 bits of its centred
# d2 in kernel and twin alike, rounded differently, so its force differs
# between them by a few 2^-10; at N = 1M such a pair can outweigh the rest
# of its row, whose small components then differ by several times that
# of their value (PERF.md, PR 4).  So at
# 1M at most 1e-3 of the components may lie outside FAST_REL_TOL, which
# catches an error every pair makes, and no row may differ by more than
# FAST_ROW_REL_TOL of its |a| (plus the 1e-4 floor of the largest).
FAST_ROW_REL_TOL = 1e-2
# The tiers' impls and the validate allowances no looser than the gates.
TIER_IMPLS = {"forces_tiled_turbo": "pallas_turbo",
              "forces_tiled_mxu": "pallas_mxu",
              "forces_sym_turbo": "pallas_sym_turbo",
              "forces_sym_mxu": "pallas_sym_mxu",
              "forces_sym_turbo2": "pallas_sym_turbo2"}

# Published H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit):
# float32 outside the tensor cores, bf16 on the tensor cores (dense), and
# HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# Flops a kernel needs per interaction, counting an FMA as two: one-sided
# force (3 sub, 6 for d2 + eps2, 2 for the cube, 1 rsqrt, 1 mass, 6 for
# the accumulate), pair-symmetric force for both bodies of a pair (one
# more multiply for m_i m_j, 3 for F r, 6 adds into both sums), and the
# pair potential (3 sub, 6 for d2 + eps2, 1 rsqrt, 2 for the accumulate):
# N^2 interactions for the row sums pe_rows, N(N-1)/2 pairs for the
# symmetric total pe_total (the function's work, as rdma_bound counts
# K13's, whatever the schedule computes).
FLOPS_ONE_SIDED, FLOPS_PAIR, FLOPS_PE = 19, 23, 12
# The tensor-core tiers, (float32 flops, tensor-core flops) per one-sided
# interaction (K9, K10) or per pair (K5, K6).  Float32: 3 sub, 3 mul and 3
# add for d2 + eps2, 2 for the cube, 1 rsqrt, then 1 multiply by m_j (K9),
# that and the hi/lo split's subtract (K10), the two weight multiplies (K5)
# or the split (K6).  Tensor cores: one m16n8k16 product is 4096 flops for
# 256 pairs, 16 a pair and product: K9 1 product, K10 2, K5 2 (i-side and
# j-side), K6 4.  K5/K6 add the exact diagonal tiles at FLOPS_ONE_SIDED an
# interaction.
FLOPS_TC = {"forces_tiled_turbo": (13, 16), "forces_tiled_mxu": (14, 32),
            "forces_sym_turbo": (14, 32), "forces_sym_mxu": (13, 64),
            # K12: float32 3 for d2 from the cross product, 2 for the
            # close-pair test (the row's and the column's thresholds, each
            # a power of two times its sum and computed once a row or a
            # column, added and compared), the clamp, 2 for the cube, 1
            # rsqrt, 1 multiply by m_j, 1 for the split; tensor cores 36 for
            # the K=18 cross product (2 x 18 a pair; the padding to K=24 is
            # not work) and 32 for the hi/lo accumulate products.
            "forces_fast": (11, 68),
            # K14a turbo2: K6's geometry with no weight multiply (12), one
            # bf16 limb on each side (32).  K14b turbof: 12 and m_i m_j
            # times inv (14), one shared weight on both sides (32).  K14c
            # turbop: K5's work (14, 32).
            "forces_sym_turbo2": (12, 32), "forces_sym_turbof": (14, 32),
            "forces_sym_turbop": (14, 32)}
# K7 for both bodies of a pair: K2's 23 with inv computed once and the two
# one-sided weights m_j inv, m_i inv (JAX's count for variant vpu: 26).
# K11 an interaction: K1's 19 (its two-sum is 4 adds a j-tile).
FLOPS_PAIR_VPU, FLOPS_KAHAN = 26, FLOPS_ONE_SIDED
# One-sided kernels (N(N-1) interactions).
ONE_SIDED = ("forces_tiled_turbo", "forces_tiled_mxu", "forces_fast")
# Integrator flops per body and (sub-)step: reference kick + drift, KDK
# two kicks + drift.
FLOPS_REF_UPDATE, FLOPS_KDK_UPDATE = 12, 18
# Rounds of classic, K14, K14, classic at N = 1M for each K14 kernel.
K14_ROUNDS = 3
# K2-rect: kernel -> (variant, schedule, float32 flops a pair, tensor-core
# flops a pair), the square tiers' counts over the A x B pairs (no
# diagonal).
RECT_KERNELS = {
    "rect_forces_sym_vpu2": ("vpu2", None, FLOPS_PAIR, 0),
    "rect_forces_sym_vpu": ("vpu", None, FLOPS_PAIR_VPU, 0),
    "rect_forces_sym_fold": ("vpu2", "fold", FLOPS_PAIR, 0),
    "rect_forces_sym_vpu_fold": ("vpu", "fold", FLOPS_PAIR_VPU, 0),
    **{f"rect_forces_sym_{v}": (v, None, *FLOPS_TC[f"forces_sym_{v}"])
       for v in ("turbo", "mxu", "turbo2", "turbof", "turbop")}}
# The rect shapes: a shard pair of validate --shards 4 at N = 8192, a
# ragged pair, and a shard pair of the 4-shard ring at N = 1M.
RECT_SHAPES = ((2048, 2048), (2048 + 96, 1536))
RECT_1M = 1 << 18
RECT_1M_ROWS = 2048
# The 1M ring's parts on the rows where the ring and K2 differ past
# REL_TOL, each against a float64 sum of its pairs, as a share of the
# row's |a|: K2 and both K2-rect sides at a tenth of the exact tolerance;
# K1's one-sided antipodal sweep, one float32 running sum of 262,144
# terms a row, and with it the ring, at validate's 1% (1.193e-3 at most on
# an H100, PERF.md); K11 on the same sweep, where a compensated sum
# removes that error, at the exact tolerance (1.022e-6 at most).
RING_PART_GATES = {"self K2": REL_TOL / 10, "rect a side": REL_TOL / 10,
                   "rect b side": REL_TOL / 10, "antipodal K1": 1e-2,
                   "antipodal K11": REL_TOL, "ring": 1e-2}
# Rounds of single-device K2, 4-shard ring, ring, K2 at N = 1M.
RING_N = 1 << 20
RING_ROUNDS = 2
# K15, the bench-only ablations: name -> (control, float32 flops a pair,
# tensor-core flops a pair) off the diagonal tiles, where the diagonal stays
# the exact one-sided pass.  vpu_noj: K7's geometry and the row side only
# (3 sub, 6 for d2 + eps2, 2 for the cube, 1 rsqrt, 1 weight, 6 for the
# row sums: 19); vpu_fix0 K7's 26; vpu_rc K7's and 3 subtractions (29);
# tmm_full and tmm_noscat K5's (14, 32); tmm_noj K5's geometry with one
# weight and one product (13, 16); tmm_nomm K5's geometry and both weights
# (14) and the two row-sum adds, no product (16, 0).
ABLATIONS = {"vpu_noj": ("forces_sym_vpu", 19, 0),
             "vpu_fix0": ("forces_sym_vpu", 26, 0),
             "vpu_rc": ("forces_sym_vpu", 29, 0),
             "tmm_full": ("forces_sym_turbo", 14, 32),
             "tmm_noscat": ("forces_sym_turbo", 14, 32),
             "tmm_noj": ("forces_sym_turbo", 13, 16),
             "tmm_nomm": ("forces_sym_turbo", 16, 0)}
# The twin shapes: the triangular forms at N = 8192, the rect forms at
# 2048 x 6144 (B spans 24 superblocks, so B's superblock 0 differs from the
# others for vpu_fix0 and tmm_noscat); the 1M sweep in rounds, each round
# every form once, the order reversed every other round.
ABLATION_N = 8192
ABLATION_RECT = (2048, 6144)
ABLATION_ROUNDS = 4
# K13, the fused ring: (variant, one_sided) cases at N = RDMA_N on each
# of RDMA_SHARDS shards (8192 / P real bodies a shard padded to whole
# 256-body tiles with zero-mass ghosts), both protocols.
RDMA_N = 8192
RDMA_SHARDS = (1, 2, 3, 4, 5, 8)
RDMA_CASES = (("vpu2", False), ("vpu", False), ("turbo", False),
              ("mxu", False), ("turbo2", False), ("vpu", True),
              ("turbo", True))
# Flops of K13's tiles: a two-sided pair (K2-rect's counts) and a
# one-sided interaction (vpu2 K2's geometry and m_i m_j times inv, then
# the row side: 20; vpu K1's 19; turbo K9's, mxu K10's; turbo2 K10's
# geometry with no weight multiply, one product), (float32, tensor-core).
RDMA_TWO = {v: RECT_KERNELS[f"rect_forces_sym_{v}"][2:]
            for v in ("vpu2", "vpu", "turbo", "mxu", "turbo2")}
RDMA_ONE = {"vpu2": (20, 0), "vpu": (FLOPS_ONE_SIDED, 0),
            "turbo": FLOPS_TC["forces_tiled_turbo"],
            "mxu": FLOPS_TC["forces_tiled_mxu"], "turbo2": (12, 16)}
# K13's tensor-core variants against their twin: TC_REL_TOL + TC_ABS_FLOOR
# a component, with at most RDMA_TC_MAX_BAD of the components outside it,
# and every row within FAST_ROW_REL_TOL of its |a| (plus the floor).  The
# per-tile correction sum w x_j - x_i sum w subtracts a term that a close
# pair's large weight makes ~1e6 at N = 8192, and the kernel's tensor-core
# float32 accumulation and the twin's matmul each round it by a unit or
# two, which can put a component that is small beside its row outside
# the per-component tolerance (mxu at P = 3 on an H100: kernel 172.199,
# twin 172.949, the variant's sums in float64 171.121, on a row of |a|
# 4364 with a correction term of 1.05e6).  Each
# such component is held to the variant's own sums in float64
# (twin_outliers): the kernel must be at least as close as the twin.
RDMA_TC_MAX_BAD = 1e-4
# K13's tier gates against float64: the sym variants at their square
# tiers' gates, the one-sided turbo at K9's; the exact ones at the exact
# tolerance.
RDMA_TIERS = {("turbo", False): "forces_sym_turbo",
              ("mxu", False): "forces_sym_mxu",
              ("turbo2", False): "forces_sym_turbo2",
              ("turbo", True): "forces_tiled_turbo"}
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
# The redesign of K8 (the symmetric total pe_total against the parent's
# row sums) and of K5's geometry for this card, timed against the designs
# before it: the commit that holds them, unpacked (``git archive PARENT_COMMIT nbody_tpu_torch/csrc | tar
# -x -C build/parent``) into PARENT_CSRC, where check_redesign builds them
# beside the package's and times both in rounds (the order reversed every
# other round; medians).  Without those sources and without git, the
# rounds and the SASS comparison are skipped and say so.
PARENT_COMMIT = "1d221d8513d8cb4fadcc519b4235513c42f7ebb1"
PARENT_CSRC = os.path.join(ROOT, "build", "parent", "nbody_tpu_torch",
                           "csrc")
REDESIGN_ROUNDS = 4
# tools/ptxas_compare.py against PARENT_CSRC: every kernel of these
# libraries keeps the parent's SASS, but those the redesign changes: the
# pair passes that take K5's trimmed geometry (TURBO 0, TURBOP 4 and the
# TMM_FULL 5 / TMM_NOSCAT 6 controls, square and rect) and K8's new
# symmetric total (its row-sum kernel pe_rows_kernel stays).
SASS_LIBS = ("forces_tiled", "forces_sym", "forces_sym_tc", "forces_tiled_tc",
             "pe", "rdma_ring", "resident", "forces_fast")
SASS_REDESIGNED = (r"\bsym_tc_pairs_kernel<[0456]>",
                   r"\brect_tc_pairs_kernel<[0456]>", r"^pe_total_kernel",
                   r"^pe_sum_kernel")


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def compare(name, got, want, rel_tol=REL_TOL, abs_floor=ABS_FLOOR,
            max_bad=0):
    """Gate ``got`` against ``want``, at most ``max_bad`` components
    outside the tolerance; returns (max abs err, max rel err)."""
    import numpy as np
    from nbody_tpu_torch.oracle.numpy_oracle import relative_mismatch
    g = got.detach().cpu().double().numpy()
    w = want.detach().cpu().double().numpy()
    scale = float(np.abs(w).max())
    bad = relative_mismatch(g, w, rel_tol, abs_floor * scale)
    max_abs = float(np.abs(g - w).max())
    max_rel = max_abs / scale
    check(np.isfinite(g).all(), f"{name}: non-finite output")
    print(f"[check] {name}: max rel err {max_rel:.3e} (max abs "
          f"{max_abs:.3e}), {int(bad.sum())} of {g.size} components outside "
          f"rel {rel_tol:g} + {abs_floor:g}*max (allowed {max_bad})")
    for idx in list(zip(*np.nonzero(bad)))[:20]:
        print(f"[check]   component {tuple(int(i) for i in idx)}: "
              f"{g[idx]:.6e} against {w[idx]:.6e}, rel "
              f"{abs(g[idx] - w[idx]) / abs(w[idx]):.3e}")
    check(bad.sum() <= max_bad,
          f"{name}: {int(bad.sum())} components outside tolerance")
    return max_abs, max_rel, sorted({int(i) for i in np.nonzero(bad)[0]})


def bound(flops, nbytes, tc_flops=0.0):
    """(bound_ms, bound_by): the largest of the float32 flops over the
    float32 peak, the tensor-core flops over the bf16 tensor-core peak
    (the two run on different units) and the bytes over the HBM rate."""
    t_ops = max(flops / PEAK_FP32_FLOPS, tc_flops / PEAK_BF16_TC_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def sym_bound(fp32, tc, n, width=256):
    """The bound of one pair-symmetric evaluation of N bodies at ``fp32``
    float32 and ``tc`` tensor-core flops a pair off the diagonal tiles (or
    superblocks) of ``width`` bodies, plus the exact one-sided diagonal."""
    full, rem = divmod(n, width)
    diag = full * width * width + rem * rem
    work = (n * n - diag) // 2
    return bound(fp32 * work + FLOPS_ONE_SIDED * diag, 28 * n, tc * work)


def tc_bound(kname, n):
    """The bound of tensor-core tier ``kname`` for one evaluation of N
    bodies: one-sided N(N-1) interactions, or pair-symmetric pairs off the
    256-wide diagonal tiles plus the exact diagonal tiles."""
    fp32, tc = FLOPS_TC[kname]
    if kname in ONE_SIDED:
        return bound(fp32 * n * (n - 1), 28 * n, tc * n * (n - 1))
    return sym_bound(fp32, tc, n)


def bodies(n, seed, device):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    pos = torch.empty(n, 3, device=device).uniform_(-1e5, 1e5, generator=g)
    mass = torch.empty(n, device=device).uniform_(1e5, 1e9, generator=g)
    return pos, mass


def ablation_rect_sets(device):
    """The K15 rect forms' A and B (ABLATION_RECT), the same in
    check_ablations and on the main path."""
    na, nb = ABLATION_RECT
    return (*bodies(na, na + 51, device), *bodies(nb, nb + 52, device))


def states_equal(a, b):
    import torch
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("pos", "vel", "acc"))


def check_forces(dev, eps2, record):
    """K1 and K2 against their plain twins; K2 reproducible and chunk-
    invariant, and right for real zero-mass bodies."""
    import torch
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_tiled as k1
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.utils.timing import time_ms
    for n in (1000, 8192):
        pos, mass = bodies(n, n, dev)
        got = k1.forces_tiled(pos, mass, eps2)
        want = k1.rect_forces_tiled_plain(pos, pos, mass, eps2)
        torch.cuda.synchronize()
        err = compare(f"K1 forces_tiled vs plain, N={n}", got, want)
        if n == 8192:
            record["forces_tiled"] = {
                "shape": "N=8192, one force evaluation",
                "max_abs_err": err[0],
                "ms": time_ms(lambda: k1.forces_tiled(pos, mass, eps2), dev),
                "plain_ms": time_ms(lambda: k1.rect_forces_tiled_plain(
                    pos, pos, mass, eps2), dev, iters=3),
                "bound": bound(FLOPS_ONE_SIDED * n * (n - 1), 28 * n)}
    for n in (1000, 3001, 8192):
        pos, mass = bodies(n, n + 1, dev)
        got = k2.forces_sym(pos, mass, eps2)
        want = k2.forces_sym_plain(pos, mass, eps2)
        torch.cuda.synchronize()
        err = compare(f"K2 forces_sym vs plain, N={n}", got, want)
        again = k2.forces_sym(pos, mass, eps2)
        check(torch.equal(got, again), f"K2 N={n}: not bit-reproducible")
        chunked = k2.forces_sym(pos, mass, eps2,
                                slot_budget=24 * (-(-n // 256) * 256))
        check(torch.equal(got, chunked),
              f"K2 N={n}: one offset per chunk differs from one chunk")
        if n == 8192:
            record["forces_sym"] = {
                "shape": "N=8192, one force evaluation",
                "max_abs_err": err[0],
                "ms": time_ms(lambda: k2.forces_sym(pos, mass, eps2), dev),
                "plain_ms": time_ms(lambda: k2.forces_sym_plain(
                    pos, mass, eps2), dev, iters=3),
                "bound": bound(FLOPS_PAIR * n * (n - 1) // 2, 28 * n)}
    pos, mass = bodies(1000, 7, dev)
    mass[[3, 400, 999]] = 0.0
    compare("K2 with three real zero-mass bodies vs direct form",
            k2.forces_sym(pos, mass, eps2), rect_forces(pos, pos, mass, eps2))
    print("[check] K2 bit-reproducible run to run and across offset chunks")


def gate_numbers(got, ref):
    """(p99 of the relative error, fraction of components outside the 1%
    gate with a 1e-4 absolute floor) of ``got`` against ``ref``."""
    import numpy as np
    from nbody_tpu_torch.oracle.numpy_oracle import relative_mismatch
    g = got.detach().cpu().double().numpy()
    r = ref.detach().cpu().numpy()
    check(np.isfinite(g).all(), "non-finite output")
    p99 = float(np.percentile(np.abs(g - r) / (np.abs(r) + 1e-30), 99))
    return p99, float(relative_mismatch(g, r, 0.01, 1e-4).mean())


def tier_gate(kname, got, ref):
    """Hold tier ``kname``'s accelerations to its gate against a float64
    direct sum ``ref``."""
    p99, frac = gate_numbers(got, ref)
    p99_gate, frac_gate = TIER_GATES[kname]
    print(f"[gate] {kname} vs float64, {got.shape[0]} rows: p99 rel err "
          f"{p99:.3e} (gate {p99_gate}), bad fraction at 1% {frac:.3e} "
          f"(gate {frac_gate})")
    check(p99_gate is None or p99 < p99_gate, f"{kname}: p99 {p99:.3e}")
    check(frac <= frac_gate, f"{kname}: bad fraction {frac:.3e}")


def check_tc(dev, eps2, record, smi):
    """K9, K10, K5 and K6 against their plain twins at N = 1000 and 8192,
    bit-reproducible (K5/K6 also chunk-invariant), at their tier gates
    against a float64 direct sum (K5 also on 4096 sampled rows at N = 1M),
    and their times at 8192 and 1M."""
    import torch
    from nbody_tpu_torch.ops import forces_sym_tc, forces_tiled_tc
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.utils.timing import time_ms
    t0 = time.perf_counter()
    tiers = {}
    for variant in ("turbo", "mxu"):
        tiers[f"forces_tiled_{variant}"] = (
            getattr(forces_tiled_tc, f"forces_tiled_{variant}"),
            lambda p, m, v=variant: forces_tiled_tc.rect_forces_tiled_tc_plain(
                p, p, m, eps2, v, True))
        tiers[f"forces_sym_{variant}"] = (
            getattr(forces_sym_tc, f"forces_sym_{variant}"),
            lambda p, m, v=variant: forces_sym_tc.forces_sym_tc_plain(
                p, m, eps2, v))
    for n in (1000, 8192):
        pos, mass = bodies(n, n + 5, dev)
        ref = rect_forces(pos.double(), pos.double(), mass.double(), eps2)
        for kname, (kernel, plain) in tiers.items():
            got = kernel(pos, mass, eps2)
            want = plain(pos, mass)
            torch.cuda.synchronize()
            err = compare(f"{kname} vs plain, N={n}", got, want,
                          rel_tol=TC_REL_TOL, abs_floor=TC_ABS_FLOOR)
            check(torch.equal(got, kernel(pos, mass, eps2)),
                  f"{kname} N={n}: not bit-reproducible")
            if kname.startswith("forces_sym"):
                chunked = kernel(pos, mass, eps2,
                                 slot_budget=24 * (-(-n // 256) * 256))
                check(torch.equal(got, chunked), f"{kname} N={n}: one "
                      f"offset per chunk differs from one chunk")
            tier_gate(kname, got, ref)
            if n == 8192:
                record[kname] = {
                    "shape": "N=8192, one force evaluation",
                    "max_abs_err": err[0],
                    "ms": time_ms(lambda: kernel(pos, mass, eps2), dev),
                    "plain_ms": time_ms(lambda: plain(pos, mass), dev,
                                        iters=3),
                    "bound": tc_bound(kname, n)}
    print("[check] K9/K10/K5/K6 bit-reproducible run to run, K5/K6 across "
          "offset chunks")

    # K5 at the bench rider's shape: 4096 sampled rows of one evaluation
    # against a float64 direct sum on the card, rows in chunks of 64.
    n = 1 << 20
    pos, mass = bodies(n, 2, dev)
    acc = forces_sym_tc.forces_sym_turbo(pos, mass, eps2)
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(2))[
        :4096].to(dev)
    ref = rect_forces(pos[rows].double(), pos.double(), mass.double(), eps2,
                      chunk=64)
    tier_gate("forces_sym_turbo", acc[rows], ref)
    for kname, (kernel, _) in tiers.items():
        record[kname]["ms_1m"] = time_ms(lambda: kernel(pos, mass, eps2),
                                         dev, iters=2, warmup=1)
        record[kname]["bound_ms_1m"] = tc_bound(kname, n)[0]
        print(f"[1M] {kname}: {record[kname]['ms_1m']:.3f} ms per "
              f"evaluation ({smi})")
    print(f"[time] tensor-core tier checks: {time.perf_counter() - t0:.1f} s")


def slice4_bound(kname, n):
    """The bound of one evaluation of K7 (pairs), K11 (one-sided
    interactions) or K12 (``tc_bound``) for N bodies."""
    if kname == "forces_fast":
        return tc_bound(kname, n)
    flops = (FLOPS_PAIR_VPU * n * (n - 1) // 2 if kname == "forces_sym_vpu"
             else FLOPS_KAHAN * n * (n - 1))
    return bound(flops, 28 * n)


def check_close_pairs(dev, eps2, n):
    """K12's direct-distance branch against its twin: close pairs planted
    among N unsorted bodies, so that every role a lane has in the branch
    (rows g and g + 8, columns 2t and 2t + 1, both n8 halves) and a pair
    across blocks and tiles take it.  Each pair lies 75 apart, where the
    centred d2's float32 error (~1e4 here) is larger than the true d2 and
    the pair's force outweighs the rest of its row's."""
    import torch
    from nbody_tpu_torch.ops import forces_fast as k12
    pos, mass = bodies(n, n + 11, dev)
    planted = ((0, 9), (1, 8), (300, n - 7))
    for i, j in planted:
        pos[j] = pos[i] + torch.tensor([60.0, -40.0, 20.0], device=dev)
    close = k12.close_pairs(pos, pos, mass, eps2)
    close.fill_diagonal_(False)
    check(all(bool(close[i, j] and close[j, i]) for i, j in planted),
          f"K12 N={n}: a planted pair passes the close-pair test")
    print(f"[check] forces_fast, N={n} unsorted with {len(planted)} planted "
          f"pairs: {int(close.sum())} ordered pairs take the direct "
          f"distance")
    got = k12.forces_fast(pos, mass, eps2)
    want = k12.rect_forces_fast_plain(pos, pos, mass, eps2, True)
    rows = torch.tensor(sorted(sum(planted, ())), device=dev)
    compare(f"forces_fast vs plain, N={n}, the planted pairs' rows",
            got[rows], want[rows], rel_tol=FAST_REL_TOL,
            abs_floor=TC_ABS_FLOOR)


def check_slice4(dev, eps2, record, smi):
    """K7, K11 and K12 against their plain twins at N = 1000 and 8192 (K12
    on Morton-sorted and on unsorted bodies, and with planted close
    pairs), bit-reproducible run to run (K7 also across offset chunks), at
    their float64 gates (K12 on sorted bodies; its error on unsorted
    bodies printed, not gated), K11's compensation carried (it differs
    from K1 and is no less accurate), K7 with real massless bodies, and one
    evaluation each at N = 1M for the times, where K12's first 4096 sorted
    rows are also held to the twin and the gate."""
    import torch
    from nbody_tpu_torch.models.ordering import morton_permutation
    from nbody_tpu_torch.ops import forces_fast as k12
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_tiled as k1
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.utils.timing import time_ms
    t0 = time.perf_counter()
    kernels = {
        "forces_sym_vpu": (k2.forces_sym_vpu,
                           lambda p, m: k2.forces_sym_vpu_plain(p, m, eps2)),
        "forces_tiled_kahan": (k1.forces_tiled_kahan,
                               lambda p, m: k1.rect_forces_tiled_plain(
                                   p, p, m, eps2, kahan=True)),
        "forces_fast": (k12.forces_fast,
                        lambda p, m: k12.rect_forces_fast_plain(
                            p, p, m, eps2, True))}
    for n in (1000, 8192):
        pos, mass = bodies(n, n + 9, dev)
        ref = rect_forces(pos.double(), pos.double(), mass.double(), eps2)
        perm = morton_permutation(pos, -1e5, 1e5)
        for kname, (kernel, plain) in kernels.items():
            fast = kname == "forces_fast"
            p, m, r = ((pos[perm].contiguous(), mass[perm].contiguous(),
                        ref[perm]) if fast else (pos, mass, ref))
            got = kernel(p, m, eps2)
            want = plain(p, m)
            torch.cuda.synchronize()
            err = compare(f"{kname} vs plain, N={n}"
                          + (", Morton-sorted" if fast else ""), got, want,
                          **({"rel_tol": FAST_REL_TOL,
                              "abs_floor": TC_ABS_FLOOR} if fast else {}))
            check(torch.equal(got, kernel(p, m, eps2)),
                  f"{kname} N={n}: not bit-reproducible")
            if kname == "forces_sym_vpu":
                chunked = kernel(p, m, eps2,
                                 slot_budget=24 * (-(-n // 256) * 256))
                check(torch.equal(got, chunked), f"{kname} N={n}: one "
                      f"offset per chunk differs from one chunk")
            tier_gate(kname, got, r)
            if fast:
                unsorted = kernel(pos, mass, eps2)
                compare(f"{kname} vs plain, N={n}, unsorted", unsorted,
                        plain(pos, mass), rel_tol=FAST_REL_TOL,
                        abs_floor=TC_ABS_FLOOR)
                p99, frac = gate_numbers(unsorted, ref)
                print(f"[info] forces_fast on unsorted bodies, N={n} (not "
                      f"gated): p99 rel err {p99:.3e}, bad fraction at 1% "
                      f"{frac:.3e}")
                check_close_pairs(dev, eps2, n)
            if kname == "forces_tiled_kahan" and n == 8192:
                # The compensation is carried: K11 is not K1, and its
                # summed error against float64 is no larger.
                plain_sum = k1.forces_tiled(p, m, eps2)
                check(not torch.equal(got, plain_sum),
                      "K11 equals K1: the compensation folded away")
                err_k = float((got.double() - r).abs().sum())
                err_1 = float((plain_sum.double() - r).abs().sum())
                print(f"[check] forces_tiled_kahan, N={n}: summed |error| "
                      f"against float64 {err_k:.6e}, K1's {err_1:.6e}")
                check(err_k <= err_1, "K11 less accurate than K1")
            if n == 8192:
                record[kname] = {
                    "shape": "N=8192, one force evaluation"
                             + (", Morton-sorted" if fast else ""),
                    "max_abs_err": err[0],
                    "ms": time_ms(lambda: kernel(p, m, eps2), dev),
                    "plain_ms": time_ms(lambda: plain(p, m), dev, iters=3),
                    "bound": slice4_bound(kname, n)}
    print("[check] K7/K11/K12 bit-reproducible run to run, K7 across offset "
          "chunks")
    pos, mass = bodies(1000, 7, dev)
    mass[[3, 400, 999]] = 0.0
    compare("K7 with three real zero-mass bodies vs direct form",
            k2.forces_sym_vpu(pos, mass, eps2),
            rect_forces(pos, pos, mass, eps2))

    # One evaluation each at N = 1M (K12 on sorted bodies).
    n = 1 << 20
    pos, mass = bodies(n, 4, dev)
    perm = morton_permutation(pos, -1e5, 1e5)
    ps, ms = pos[perm].contiguous(), mass[perm].contiguous()
    for kname, (kernel, _), iters in (
            ("forces_sym_vpu", kernels["forces_sym_vpu"], 2),
            ("forces_fast", kernels["forces_fast"], 2),
            ("forces_tiled_kahan", kernels["forces_tiled_kahan"], 1)):
        p, m = (ps, ms) if kname == "forces_fast" else (pos, mass)
        record[kname]["ms_1m"] = time_ms(lambda: kernel(p, m, eps2), dev,
                                         iters=iters, warmup=1)
        record[kname]["bound_ms_1m"] = slice4_bound(kname, n)[0]
        print(f"[1M] {kname}: {record[kname]['ms_1m']:.3f} ms per "
              f"evaluation ({smi})")
    # K12 at the main path's 1M shape: the first 4096 sorted rows (a prefix
    # of j, so the self-pairs are masked alike) against the twin and,
    # through a float64 direct sum, the tier gate.  Against the twin, at
    # most 1e-3 of the components outside FAST_REL_TOL and every row within
    # FAST_ROW_REL_TOL; the rows outside with their nearest body's d2 in
    # units of the pair's close-pair threshold.
    rows = 4096
    acc = k12.forces_fast(ps, ms, eps2)[:rows]
    want = k12.rect_forces_fast_plain(ps[:rows], ps, ms, eps2, True)
    name = "forces_fast vs plain, N=1M Morton-sorted, first 4096 rows"
    outside = compare(name, acc, want, rel_tol=FAST_REL_TOL,
                      abs_floor=TC_ABS_FLOOR, max_bad=3 * rows // 1000)[2]
    norm = want.norm(dim=1)
    row_err = (acc - want).norm(dim=1) / (norm + TC_ABS_FLOOR * norm.max())
    # Each j-tile's centroid and |v|^2 (N is a multiple of the tile).
    tile = k12.FAST_TILE_J
    cent = ps.view(-1, tile, 3).mean(1)
    vn2 = ((ps - cent.repeat_interleave(tile, 0)) ** 2).sum(1)
    for i in outside:
        d2 = ((ps - ps[i]) ** 2).sum(1) + eps2
        d2[i] = float("inf")
        un2 = ((ps[i] - cent) ** 2).sum(1).repeat_interleave(tile)
        ratio = d2 / (k12.CLOSE_PAIR_SCALE * (un2 + eps2 + vn2))
        j = int(ratio.argmin())
        print(f"[check]   row {i}: differs by {float(row_err[i]):.3e} of its "
              f"|a|; the pair nearest its close-pair test is body {j}, d2 "
              f"{float(d2[j]):.4e} = {float(ratio[j]):.3f} x the test, "
              f"m/d2 {float(ms[j] / d2[j]) / float(norm[i]):.3f} of |a| "
              f"(nearest body: {int(d2.argmin())})")
    worst = int(row_err.argmax())
    print(f"[check] {name}: largest row difference {float(row_err[worst]):.3e}"
          f" of its |a| (row {worst}), {int((row_err > FAST_REL_TOL).sum())} "
          f"rows over {FAST_REL_TOL:g}, gate {FAST_ROW_REL_TOL:g}")
    check(float(row_err[worst]) <= FAST_ROW_REL_TOL,
          f"{name}: row {worst} differs by {float(row_err[worst]):.3e}")
    tier_gate("forces_fast", acc, rect_forces(
        ps[:rows].double(), ps.double(), ms.double(), eps2, chunk=64))
    print(f"[time] K7/K11/K12 checks: {time.perf_counter() - t0:.1f} s")


def k14_bound(kname, n):
    """The bound of one evaluation of a K14 kernel for N bodies: the
    tensor-core variants on 256-wide diagonal tiles, the fold schedule
    (K2's or K7's flops a pair) on diagonal superblocks of FOLD_BLOCK_U."""
    from nbody_tpu_torch.ops.forces_sym import FOLD_BLOCK_U
    if kname in FLOPS_TC:
        return tc_bound(kname, n)
    fp32 = FLOPS_PAIR if kname == "forces_sym_fold" else FLOPS_PAIR_VPU
    return sym_bound(fp32, 0, n, FOLD_BLOCK_U)


def check_k14(dev, eps2, record, smi):
    """K14a-c (turbo2, turbof, turbop) and K14d (the fold schedule with K2's
    and K7's math) against their plain twins at a ragged N = 2500 and at
    the main path's 8192 on unsorted bodies, bit-reproducible and chunk-
    invariant; turbo2 and turbof at turbo's float64 gate at 8192 and on
    4096 sampled rows at 1M, turbof with three real massless bodies; turbop
    bit-equal to K5 at 8192 and 1M; the fold kernels at the exact tiers'
    float64 gate at 8192 and within the exact tolerance of classic K2/K7 at
    8192 and 1M; their times at 8192 and, in K14_ROUNDS rounds with the
    classic kernel, at 1M."""
    import torch
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_sym_tc as ktc
    from nbody_tpu_torch.ops.forces_sym_variants import forces_pallas_sym
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.utils.timing import time_ms
    t0 = time.perf_counter()
    u = k2.FOLD_BLOCK_U
    tc = {"rel_tol": TC_REL_TOL, "abs_floor": TC_ABS_FLOOR}
    # name -> (variant, schedule, twin, tolerance, tile or superblock).
    kernels = {
        f"forces_sym_{v}": (
            v, None, lambda p, m, v=v: ktc.forces_sym_tc_plain(p, m, eps2, v),
            tc, 256)
        for v in ("turbo2", "turbof", "turbop")}
    kernels["forces_sym_fold"] = (
        "vpu2", "fold",
        lambda p, m: k2.forces_sym_plain(p, m, eps2, block_u=u), {}, u)
    kernels["forces_sym_vpu_fold"] = (
        "vpu", "fold",
        lambda p, m: k2.forces_sym_vpu_plain(p, m, eps2, block_u=u), {}, u)

    def run(kname, p, m, **kw):
        """K14 kernel ``kname`` through the entry point a user calls."""
        variant, schedule = kernels[kname][:2]
        return forces_pallas_sym(p, m, eps2, variant=variant,
                                 schedule=schedule, **kw)

    for n in (2500, 8192):
        pos, mass = bodies(n, n + 13, dev)
        for kname, (_, _, plain, tol, width) in kernels.items():
            got = run(kname, pos, mass)
            err = compare(f"{kname} vs plain, N={n}", got, plain(pos, mass),
                          **tol)
            check(torch.equal(got, run(kname, pos, mass)),
                  f"{kname} N={n}: not bit-reproducible")
            one = run(kname, pos, mass,
                      slot_budget=24 * (-(-n // width) * width))
            check(torch.equal(got, one), f"{kname} N={n}: one offset per "
                  f"chunk differs from one chunk")
            if n == 8192:
                record[kname] = {
                    "shape": "N=8192, one force evaluation",
                    "max_abs_err": err[0],
                    "plain_ms": time_ms(lambda: plain(pos, mass), dev,
                                        iters=3)}
    print("[check] K14a-d bit-reproducible run to run and across offset "
          "chunks")
    pos, mass = bodies(1000, 17, dev)
    mass[[3, 400, 999]] = 0.0
    ref = rect_forces(pos.double(), pos.double(), mass.double(), eps2)
    acc = ktc.forces_sym_turbof(pos, mass, eps2)
    compare("forces_sym_turbof, the three massless rows vs float64 direct "
            "form", acc[[3, 400, 999]], ref[[3, 400, 999]])
    tier_gate("forces_sym_turbof", acc, ref)

    # N = 8192 (the bodies of the last twin round, made again): the gates,
    # turbop against K5, fold against classic, and the times.
    n = 8192
    pos, mass = bodies(n, n + 13, dev)
    ref = rect_forces(pos.double(), pos.double(), mass.double(), eps2)
    k5 = ktc.forces_sym_turbo(pos, mass, eps2)
    classic = {"forces_sym_fold": k2.forces_sym(pos, mass, eps2),
               "forces_sym_vpu_fold": k2.forces_sym_vpu(pos, mass, eps2)}
    for kname in kernels:
        got = run(kname, pos, mass)
        torch.cuda.synchronize()
        if kname == "forces_sym_turbop":
            check(torch.equal(got, k5), "turbop N=8192: differs from K5")
            print("[check] forces_sym_turbop, N=8192: bit-equal to K5")
        else:
            tier_gate(kname, got, ref)
        if kname in classic:
            compare(f"{kname} vs classic, N={n}", got, classic[kname])
        record[kname]["ms"] = time_ms(lambda: run(kname, pos, mass), dev)
        record[kname]["bound"] = k14_bound(kname, n)

    # N = 1M: turbo2 and turbof on 4096 sampled rows against float64,
    # turbop against K5 and fold against classic over every row; times.
    n = 1 << 20
    pos, mass = bodies(n, 6, dev)
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(6))[
        :4096].to(dev)
    ref = rect_forces(pos[rows].double(), pos.double(), mass.double(), eps2,
                      chunk=64)
    against = {"forces_sym_turbop": ktc.forces_sym_turbo,
               "forces_sym_fold": k2.forces_sym,
               "forces_sym_vpu_fold": k2.forces_sym_vpu}
    for kname in kernels:
        got = run(kname, pos, mass)
        if kname == "forces_sym_turbop":
            check(torch.equal(got, against[kname](pos, mass, eps2)),
                  "turbop N=1M: differs from K5")
            print("[check] forces_sym_turbop, N=1M: bit-equal to K5")
        elif kname in against:
            compare(f"{kname} vs classic, N=1M", got,
                    against[kname](pos, mass, eps2))
        else:
            tier_gate(kname, got[rows], ref)
        del got
        # In rounds with the classic kernel it varies (K5 for the
        # tensor-core variants): classic, K14, K14, classic; the ratio of
        # classic's time to K14's in each round, and their spread.
        base = against.get(kname, ktc.forces_sym_turbo)
        k14_ms, ratios = [], []
        for _ in range(K14_ROUNDS):
            turns = [time_ms(f, dev, iters=1, warmup=0) for f in (
                lambda: base(pos, mass, eps2), lambda: run(kname, pos, mass),
                lambda: run(kname, pos, mass), lambda: base(pos, mass, eps2))]
            k14_ms += turns[1:3]
            ratios.append((turns[0] + turns[3]) / (turns[1] + turns[2]))
        record[kname]["ms_1m"] = sum(k14_ms) / len(k14_ms)
        record[kname]["bound_ms_1m"] = k14_bound(kname, n)[0]
        print(f"[1M] {kname}: {record[kname]['ms_1m']:.3f} ms per "
              f"evaluation; {base.__name__} / {kname} in {K14_ROUNDS} "
              f"rounds: {', '.join(f'{r:.4f}' for r in ratios)} (spread "
              f"{max(ratios) - min(ratios):.4f}) ({smi})")
    print(f"[time] K14 checks: {time.perf_counter() - t0:.1f} s")


def rect_bound(kname, na, nb):
    """The bound of one K2-rect sweep of na x nb pairs."""
    _, _, fp32, tc = RECT_KERNELS[kname]
    return bound(fp32 * na * nb, 28 * (na + nb), tc * na * nb)


def check_rect(dev, eps2, record, smi):
    """K2-rect, every variant and both schedules, against its plain twin
    at the shard shapes (2048 x 2048 and a ragged 2144 x 1536; fold on
    superblocks of FOLD_BLOCK_U), bit-reproducible and chunk-invariant;
    turbop bit-equal to turbo; each against a float64 direct sum of the
    cross pairs (the exact variants at the exact tolerance, the
    tensor-core ones at their tiers' gates on 2048 x 2048); real massless
    bodies on both sides; times at 2048 x 2048 and at the 1M ring's shard
    pair, 262,144 x 262,144."""
    import torch
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_sym_tc as ktc
    from nbody_tpu_torch.ops.forces_sym_variants import rect_forces_sym
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.utils.timing import time_ms
    t0 = time.perf_counter()
    u = k2.FOLD_BLOCK_U

    def run(kname, pa, ma, pb, mb, **kw):
        variant, schedule = RECT_KERNELS[kname][:2]
        return rect_forces_sym(pa, ma, pb, mb, eps2, variant=variant,
                               schedule=schedule, **kw)

    def plain(kname, pa, ma, pb, mb):
        variant, schedule = RECT_KERNELS[kname][:2]
        if variant in ("vpu", "vpu2"):
            fold = schedule == "fold" and pa.shape[0] % u == 0
            return k2.rect_forces_sym_plain(pa, ma, pb, mb, eps2,
                                            variant == "vpu",
                                            u if fold else 256)
        return ktc.rect_forces_sym_tc_plain(pa, ma, pb, mb, eps2, variant)

    for na, nb in RECT_SHAPES:
        pa, ma = bodies(na, na + 21, dev)
        pb, mb = bodies(nb, nb + 22, dev)
        ref = (rect_forces(pa.double(), pb.double(), mb.double(), eps2),
               rect_forces(pb.double(), pa.double(), ma.double(), eps2))
        for kname, (variant, _, _, _) in RECT_KERNELS.items():
            exact = variant in ("vpu", "vpu2")
            tol = {} if exact else {"rel_tol": TC_REL_TOL,
                                    "abs_floor": TC_ABS_FLOOR}
            got = run(kname, pa, ma, pb, mb)
            want = plain(kname, pa, ma, pb, mb)
            torch.cuda.synchronize()
            err = max(compare(f"{kname} acc_{side} vs plain, {na}x{nb}", g,
                              w, **tol)[0]
                      for side, g, w in zip("ab", got, want))
            again = run(kname, pa, ma, pb, mb)
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"{kname} {na}x{nb}: not bit-reproducible")
            width = u if RECT_KERNELS[kname][1] else 256
            one = run(kname, pa, ma, pb, mb,
                      slot_budget=24 * (-(-na // width) * width))
            check(all(torch.equal(x, y) for x, y in zip(got, one)),
                  f"{kname} {na}x{nb}: one column superblock per chunk "
                  f"differs from one chunk")
            for side, g, r in zip("ab", got, ref):
                if exact:
                    compare(f"{kname} acc_{side} vs float64, {na}x{nb}", g,
                            r)
                elif na == nb and variant != "turbop":
                    tier_gate(f"forces_sym_{variant}", g, r)
            if (na, nb) == RECT_SHAPES[0]:
                record[kname] = {
                    "shape": f"{na} x {nb} pairs (a shard pair of "
                             f"validate --shards 4 at N=8192)",
                    "max_abs_err": err,
                    "ms": time_ms(lambda: run(kname, pa, ma, pb, mb), dev),
                    "plain_ms": time_ms(lambda: plain(kname, pa, ma, pb,
                                                      mb), dev, iters=3),
                    "bound": rect_bound(kname, na, nb)}
        turbo = run("rect_forces_sym_turbo", pa, ma, pb, mb)
        check(all(torch.equal(x, y) for x, y in zip(
            turbo, run("rect_forces_sym_turbop", pa, ma, pb, mb))),
            f"rect turbop {na}x{nb}: differs from turbo")
        print(f"[check] rect_forces_sym_turbop, {na}x{nb}: bit-equal to "
              f"rect turbo")
    print("[check] K2-rect bit-reproducible run to run and across column "
          "chunks")

    # Real massless bodies on both sides: the mass-scaled variants
    # recompute their rows one-sided over the other set.
    pa, ma = bodies(2048 + 96, 31, dev)
    pb, mb = bodies(1536, 32, dev)
    ma[[3, 2100]] = 0.0
    mb[[5, 1535]] = 0.0
    ref = (rect_forces(pa.double(), pb.double(), mb.double(), eps2),
           rect_forces(pb.double(), pa.double(), ma.double(), eps2))
    for kname in ("rect_forces_sym_vpu2", "rect_forces_sym_turbof",
                  "rect_forces_sym_vpu"):
        got = run(kname, pa, ma, pb, mb)
        compare(f"{kname}, massless rows of A vs float64", got[0][[3, 2100]],
                ref[0][[3, 2100]])
        compare(f"{kname}, massless rows of B vs float64", got[1][[5, 1535]],
                ref[1][[5, 1535]])

    # The 1M ring's shard pair, where B's column superblocks take three
    # slot chunks: every variant's acc_a and acc_b on RECT_1M_ROWS sampled
    # rows of each side against a float64 direct sum of the cross pairs
    # (the exact variants at the exact tolerance, the tensor-core ones at
    # their tiers' gates; turbop bit-equal to turbo), then its time.
    n = RECT_1M
    pa, ma = bodies(n, 41, dev)
    pb, mb = bodies(n, 42, dev)
    gen = torch.Generator().manual_seed(41)
    rows = [torch.randperm(n, generator=gen)[:RECT_1M_ROWS].to(dev)
            for _ in "ab"]
    ref = (rect_forces(pa[rows[0]].double(), pb.double(), mb.double(), eps2,
                       chunk=64),
           rect_forces(pb[rows[1]].double(), pa.double(), ma.double(), eps2,
                       chunk=64))
    outs = {}
    for kname, (variant, _, _, _) in RECT_KERNELS.items():
        got = outs[variant] = run(kname, pa, ma, pb, mb)
        torch.cuda.synchronize()
        if variant == "turbop":
            check(all(torch.equal(x, y) for x, y in zip(got, outs["turbo"])),
                  f"rect turbop {n}x{n}: differs from turbo")
            print(f"[check] {kname}, {n}x{n}: bit-equal to rect turbo")
        for side, g, r, idx in zip("ab", got, ref, rows):
            if variant in ("vpu", "vpu2"):
                compare(f"{kname} acc_{side} vs float64, {n}x{n}, "
                        f"{RECT_1M_ROWS} sampled rows", g[idx], r)
            elif variant != "turbop":
                tier_gate(f"forces_sym_{variant}", g[idx], r)
        record[kname]["ms_1m"] = time_ms(lambda: run(kname, pa, ma, pb, mb),
                                         dev, iters=2, warmup=1)
        record[kname]["bound_ms_1m"] = rect_bound(kname, n, n)[0]
        print(f"[1M ring pair] {kname}: {record[kname]['ms_1m']:.3f} ms per "
              f"{n} x {n} sweep ({smi})")
    print(f"[time] K2-rect checks: {time.perf_counter() - t0:.1f} s")


def ablation_bound(name, n, rect_n=None):
    """The bound of one K15 evaluation: the triangular sweep of N bodies
    (the ablated tile off the 256-wide diagonal tiles, the exact one-sided
    diagonal), or the rect sweep of n x rect_n pairs."""
    _, fp32, tc = ABLATIONS[name]
    if rect_n is None:
        return sym_bound(fp32, tc, n)
    return bound(fp32 * n * rect_n, 28 * (n + rect_n), tc * n * rect_n)


def check_ablations(dev, eps2, record, smi):
    """K15 (``ablation_sym.enable()``, then ``forces_pallas_sym`` and
    ``rect_forces_sym`` with an ablation variant): each of the seven forms
    of both sweeps against its plain twin (triangular at N = 8192 seed 0,
    rect at 2048 x 6144), bit-reproducible and the same with one offset /
    column superblock a slot chunk, and (triangular) the same at the
    control's CTAs per SM; vpu_rc and tmm_full also against a float64
    direct sum at the exact and the turbo gate, and bit-equal to K7 and
    K5; the none forms give B nothing.  Then the sweep at N = 1M (K7 and
    the vpu_* forms, K5, turbop and the tmm_* forms, and each ablation at
    its control's CTAs per SM) in ABLATION_ROUNDS interleaved rounds, the
    outputs of vpu_rc and tmm_full bit-equal to K7 and K5 and each pinned
    form's to its own; and each rect form at the 1M ring's 262,144 x
    262,144 shard pair beside K2-rect vpu and turbo, checked there on
    sampled rows and timed once."""
    import torch
    from nbody_tpu_torch.ops import ablation_sym as ab
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_sym_tc as ktc
    from nbody_tpu_torch.ops.forces_sym_variants import (forces_pallas_sym,
                                                         rect_forces_sym)
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.utils.timing import time_ms
    t0 = time.perf_counter()
    ab.enable()
    tc = {"rel_tol": TC_REL_TOL, "abs_floor": TC_ABS_FLOOR}

    def tol(name):
        return {} if name.startswith("vpu_") else tc

    n = ABLATION_N
    pos, mass = bodies(n, 0, dev)
    n_pad = -(-n // 256) * 256
    na, nb = ABLATION_RECT
    pa, ma, pb, mb = ablation_rect_sets(dev)
    for name in ab.ABLATION_NAMES:
        got = forces_pallas_sym(pos, mass, eps2, variant=name)
        plain = ab.forces_sym_ablation_plain(pos, mass, eps2, name)
        err = compare(f"forces_sym_{name} vs plain, N={n}", got, plain,
                      **tol(name))[0]
        check(torch.equal(got, forces_pallas_sym(pos, mass, eps2,
                                                 variant=name)),
              f"forces_sym_{name}: not bit-reproducible")
        check(torch.equal(got, forces_pallas_sym(
            pos, mass, eps2, variant=name, slot_budget=24 * n_pad)),
            f"forces_sym_{name}: one offset per chunk differs from one "
            f"chunk")
        with ab.control_occupancy():
            check(torch.equal(got, forces_pallas_sym(pos, mass, eps2,
                                                     variant=name)),
                  f"forces_sym_{name}: differs at its control's occupancy")
        record[f"forces_sym_{name}"] = {
            "shape": f"N={n}, one force evaluation",
            "max_abs_err": err,
            "ms": time_ms(lambda: forces_pallas_sym(pos, mass, eps2,
                                                    variant=name), dev),
            "plain_ms": time_ms(lambda: ab.forces_sym_ablation_plain(
                pos, mass, eps2, name), dev, iters=3),
            "bound": ablation_bound(name, n)}
        got = rect_forces_sym(pa, ma, pb, mb, eps2, variant=name)
        plain = ab.rect_forces_sym_ablation_plain(pa, ma, pb, mb, eps2,
                                                  name)
        torch.cuda.synchronize()
        err = compare(f"rect_forces_sym_{name} acc_a vs plain, {na}x{nb}",
                      got[0], plain[0], **tol(name))[0]
        if ab.J_MODE[name] == "none":
            check(not bool(got[1].any()), f"rect {name}: B got a force")
        else:
            err = max(err, compare(f"rect_forces_sym_{name} acc_b vs plain, "
                                   f"{na}x{nb}", got[1], plain[1],
                                   **tol(name))[0])
        again = rect_forces_sym(pa, ma, pb, mb, eps2, variant=name)
        one = rect_forces_sym(pa, ma, pb, mb, eps2, variant=name,
                              slot_budget=24 * na)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"rect_forces_sym_{name}: not bit-reproducible")
        check(all(torch.equal(x, y) for x, y in zip(got, one)),
              f"rect_forces_sym_{name}: one column superblock per chunk "
              f"differs from one chunk")
        record[f"rect_forces_sym_{name}"] = {
            "shape": f"{na} x {nb} pairs",
            "max_abs_err": err,
            "ms": time_ms(lambda: rect_forces_sym(pa, ma, pb, mb, eps2,
                                                  variant=name), dev),
            "plain_ms": time_ms(lambda: ab.rect_forces_sym_ablation_plain(
                pa, ma, pb, mb, eps2, name), dev, iters=3),
            "bound": ablation_bound(name, na, nb)}
    print("[check] K15 bit-reproducible run to run, across slot chunks "
          "and (triangular) at the control's occupancy")
    print(f"[occupancy] CTAs per SM of the triangular pair kernels: "
          f"{ab.ctas_per_sm()}; at the control's: ", end="")
    with ab.control_occupancy():
        print(ab.ctas_per_sm())

    # The two exact-physics forms: float64 gates, and against the controls.
    ref = rect_forces(pos.double(), pos.double(), mass.double(), eps2)
    rc = forces_pallas_sym(pos, mass, eps2, variant="vpu_rc")
    full = forces_pallas_sym(pos, mass, eps2, variant="tmm_full")
    tier_gate("forces_sym_vpu", rc, ref)
    tier_gate("forces_sym_turbo", full, ref)
    k7 = k2.forces_sym_vpu(pos, mass, eps2)
    check(torch.equal(rc, k7), f"vpu_rc, N={n}: differs from K7")
    check(torch.equal(full, ktc.forces_sym_turbo(pos, mass, eps2)),
          f"tmm_full, N={n}: differs from K5")
    print(f"[check] N={n}: forces_sym_vpu_rc bit-equal to K7, "
          f"forces_sym_tmm_full to K5")
    ra = rect_forces(pa.double(), pb.double(), mb.double(), eps2)
    rb = rect_forces(pb.double(), pa.double(), ma.double(), eps2)
    for name, kname in (("vpu_rc", "forces_sym_vpu"),
                        ("tmm_full", "forces_sym_turbo")):
        got = rect_forces_sym(pa, ma, pb, mb, eps2, variant=name)
        for g, r in zip(got, (ra, rb)):
            tier_gate(kname, g, r)
    del ref, ra, rb

    # N = 1M: one evaluation of each form a round, in turns; each
    # ablation also at its control's CTAs per SM ("pinned").
    n = RING_N
    pos, mass = bodies(n, 6, dev)

    def form(v, pinned=False):
        def f(p, m, e):
            with (ab.control_occupancy() if pinned
                  else contextlib.nullcontext()):
                return forces_pallas_sym(p, m, e, variant=v)
        return f
    forms = {"forces_sym_vpu": k2.forces_sym_vpu,
             **{f"forces_sym_{v}": form(v) for v in ab.ABLATION_NAMES[:3]},
             "forces_sym_turbo": ktc.forces_sym_turbo,
             "forces_sym_turbop": ktc.forces_sym_turbop,
             **{f"forces_sym_{v}": form(v) for v in ab.ABLATION_NAMES[3:]},
             **{f"forces_sym_{v} pinned": form(v, True)
                for v in ab.ABLATION_NAMES}}
    out = {}
    for kname, f in forms.items():
        out[kname] = f(pos, mass, eps2)
        check(bool(torch.isfinite(out[kname]).all()),
              f"{kname} N=1M: non-finite")
    check(torch.equal(out["forces_sym_vpu_rc"], out["forces_sym_vpu"]),
          "vpu_rc N=1M: differs from K7")
    check(torch.equal(out["forces_sym_tmm_full"], out["forces_sym_turbo"]),
          "tmm_full N=1M: differs from K5")
    for v in ab.ABLATION_NAMES:
        check(torch.equal(out[f"forces_sym_{v} pinned"],
                          out[f"forces_sym_{v}"]),
              f"{v} N=1M: differs at its control's occupancy")
    print("[check] N=1M: forces_sym_vpu_rc bit-equal to K7, "
          "forces_sym_tmm_full to K5, each ablation to itself pinned")
    del out
    times = {k: [] for k in forms}
    for r in range(ABLATION_ROUNDS):
        for kname in (list(forms) if r % 2 == 0 else list(forms)[::-1]):
            times[kname].append(time_ms(lambda: forms[kname](pos, mass,
                                                             eps2),
                                        dev, iters=1, warmup=0))
    for kname, ts in times.items():
        control = ("forces_sym_vpu" if kname.startswith("forces_sym_vpu")
                   else "forces_sym_turbo")
        ratios = [c / x for c, x in zip(times[control], ts)]
        med = statistics.median(ts)
        name = kname[len("forces_sym_"):]
        if name in ABLATIONS:
            record[kname]["ms_1m"] = med
            record[kname]["bound_ms_1m"] = ablation_bound(name, n)[0]
        print(f"[1M ablation] {kname}: median {med:.3f} ms per evaluation "
              f"(rounds {', '.join(f'{x:.3f}' for x in ts)}); "
              f"{control} / {kname} median {statistics.median(ratios):.4f} "
              f"(rounds {', '.join(f'{x:.4f}' for x in ratios)}) ({smi})")
    del pos, mass

    # The 1M ring's shard pair (B in three slot chunks), beside K2-rect:
    # each rect form's output checked, then its time.  acc_a on sampled
    # rows against the twin over those rows and all of B (a row's sum
    # reads no other row of A); acc_b of vpu_rc and tmm_full on sampled
    # rows against float64; fix0's superblock 0 against the sum of its
    # control's column superblocks, the rest of B 0; the none forms give B
    # nothing.
    n = RECT_1M
    pa, ma = bodies(n, 41, dev)
    pb, mb = bodies(n, 42, dev)
    gen = torch.Generator().manual_seed(43)
    ra, rb = (torch.randperm(n, generator=gen)[:RECT_1M_ROWS].to(dev)
              for _ in "ab")
    ref_b = rect_forces(pb[rb].double(), pa.double(), ma.double(), eps2,
                        chunk=64)
    outs = {}
    for variant in ("vpu", "turbo", *ab.ABLATION_NAMES):
        kname = f"rect_forces_sym_{variant}"
        got = outs[variant] = rect_forces_sym(pa, ma, pb, mb, eps2,
                                              variant=variant)
        if variant in ab.ABLATION_NAMES:
            what = f"{kname}, {n}x{n}"
            twin = ab.rect_forces_sym_ablation_plain(
                pa[ra], ma[ra], pb, mb, eps2, variant)[0]
            compare(f"{what} acc_a vs plain, {RECT_1M_ROWS} sampled rows",
                    got[0][ra], twin, **tol(variant))
            mode = ab.J_MODE[variant]
            control = "vpu" if variant.startswith("vpu") else "turbo"
            if mode == "none":
                check(not bool(got[1].any()), f"{what}: B got a force")
            elif mode == "fix0":
                cols = outs[control][1].double().view(-1, 256, 3).sum(0)
                compare(f"{what} acc_b of B's superblock 0 vs the sum of "
                        f"rect {control}'s column superblocks", got[1][:256],
                        cols, **tol(variant))
                check(not bool(got[1][256:].any()),
                      f"{what}: B beyond superblock 0 got a force")
            elif variant == "vpu_rc":
                compare(f"{what} acc_b vs float64, {RECT_1M_ROWS} sampled "
                        f"rows", got[1][rb], ref_b)
            else:
                tier_gate("forces_sym_turbo", got[1][rb], ref_b)
        ms = time_ms(lambda: rect_forces_sym(pa, ma, pb, mb, eps2,
                                             variant=variant), dev,
                     iters=1, warmup=0)
        if variant in ab.ABLATION_NAMES:
            record[kname]["ms_1m"] = ms
            record[kname]["bound_ms_1m"] = ablation_bound(variant, n, n)[0]
        print(f"[1M ring pair ablation] {kname}: {ms:.3f} ms per {n} x {n} "
              f"sweep ({smi})")
    print(f"[time] K15 checks: {time.perf_counter() - t0:.1f} s")


def rdma_bound(variant, one_sided, n):
    """The bound of one K13 evaluation of N bodies, from the function: on
    the sym ladder N(N-1)/2 pairs at the two-sided tile's flops (RDMA_TWO;
    K2's count at the same N for vpu2), for the one-sided family N(N-1)
    interactions at the one-sided tile's (RDMA_ONE)."""
    f, t = (RDMA_ONE if one_sided else RDMA_TWO)[variant]
    work = n * (n - 1) // (1 if one_sided else 2)
    return bound(f * work, 28 * n, t * work)


def rdma_schedule_bound(variant, one_sided, p, c):
    """The bound of the work K13's schedule does on P shards of C bodies,
    beside ``rdma_bound``: the self phase one-sided over C x C a shard, the
    two-sided phases over C x C pairs, the other cross phases one-sided
    (the self and the even-P antipodal phase count each pair twice)."""
    from nbody_tpu_torch.parallel.rdma_ring import ring_phases
    half, d_final = ring_phases(p, one_sided)
    block = p * c * c
    one = (1 + d_final - half) * block
    two = half * block
    (f1, t1), (f2, t2) = RDMA_ONE[variant], RDMA_TWO[variant]
    return bound(f1 * one + f2 * two, 28 * p * c, t1 * one + t2 * two)


def row_gate(name, got, want):
    """Every row of ``got`` within FAST_ROW_REL_TOL of the row's |a| in
    ``want``, plus TC_ABS_FLOOR of the largest |a|."""
    d = (got - want).double().norm(dim=1)
    w = want.double().norm(dim=1)
    worst = float((d / (w + TC_ABS_FLOOR * float(w.max()))).max())
    print(f"[check] {name}: rows within {worst:.3e} of their |a| (gate "
          f"{FAST_ROW_REL_TOL:g})")
    check(worst <= FAST_ROW_REL_TOL, f"{name}: a row off by {worst:.3e}")


def tc_rows_float64(variant, pos, mass, rows, eps2):
    """A tensor-core variant's own sums for ``rows`` against every body,
    exact after the variant's bf16 rounding: each pair's bf16 weight limbs
    and packs as the kernel and its twin form them (turbo bf16(m_j inv),
    turbo2 bf16(inv), mxu its hi/lo split, on the position or mass-folded
    pack), the self pair dropped, the products and the per-tile correction
    summed in float64.  Returns the sums and the correction term
    |x_i sum w| they cancel."""
    import torch
    from nbody_tpu_torch.ops.forces_tiled_tc import (
        bf16_split, mass_folded_pack, pair_inv, position_pack)
    xi = pos[rows]
    inv = pair_inv(xi, pos, eps2)
    inv[range(len(rows)), rows] = 0.0
    if variant == "turbo":
        limbs = [(mass[None, :] * inv).to(torch.bfloat16).float()]
        pack = position_pack(pos)
    else:
        limbs = ([inv.to(torch.bfloat16).float()] if variant == "turbo2"
                 else list(bf16_split(inv)))
        pack = mass_folded_pack(pos, mass)
    out = sum(w.double() @ pack.double() for w in limbs)
    s = out[:, 0::2] + out[:, 1::2]
    corr = xi.double() * s[:, 3:4]
    return s[:, :3] - corr, corr.abs()


def twin_outliers(name, variant, got, want, pos, mass, eps2, rows):
    """The components of ``rows`` where a tensor-core K13 output ``got``
    and its twin ``want`` differ past the twin tolerance, each beside the
    variant's own sums in float64 (``tc_rows_float64``), of which both are
    float32 roundings, and beside a float64 direct sum: the kernel must be
    at least as close to the variant's float64 sums as the twin, or within
    the twin tolerance of them."""
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    if not rows:
        return
    v, corr = tc_rows_float64(variant, pos, mass, rows, eps2)
    f = rect_forces(pos[rows].double(), pos.double(), mass.double(), eps2)
    g, w = got[rows].double(), want[rows].double()
    floor = TC_ABS_FLOOR * float(want.abs().max())
    out = (g - w).abs() > TC_REL_TOL * w.abs() + floor
    for r, k in out.nonzero().tolist():
        ek, et = float(abs(g[r, k] - v[r, k])), float(abs(w[r, k] - v[r, k]))
        tol = TC_REL_TOL * abs(float(v[r, k])) + floor
        print(f"[check] {name}: component ({rows[r]},{k}) kernel "
              f"{float(g[r, k]):.6f}, twin {float(w[r, k]):.6f}, the "
              f"variant's sums in float64 {float(v[r, k]):.6f}: kernel off "
              f"by {ek:.3e}, twin by {et:.3e} (twin tolerance {tol:.3e}; "
              f"correction term {float(corr[r, k]):.4e}); float64 direct sum {float(f[r, k]):.6f} (row |a| "
              f"{float(f[r].norm()):.3f})")
        check(ek <= et or ek <= tol,
              f"{name}: component ({rows[r]},{k}) is further from the "
              f"variant's float64 sums than the twin, and outside the "
              f"tolerance")


def rdma_shards(n, p, seed, dev):
    """N uniform bodies padded with zero-mass ghosts to P shards of whole
    256-body tiles, as the mesh pads them: (pos, mass) packed."""
    import torch
    c = -(-n // (p * 256)) * 256
    pos, mass = bodies(n, seed, dev)
    pad = p * c - n
    return (torch.cat([pos, pos.new_zeros(pad, 3)]),
            torch.cat([mass, mass.new_zeros(pad)]))


def check_rdma(dev, eps2, record, smi):
    """K13 against its plain twin at N = RDMA_N on each of RDMA_SHARDS
    shards, every variant of the sym ladder and the one-sided family, both
    protocols, bit-reproducible; overlap within the twin tolerance of the
    sequential protocol; each variant against float64 at its tier's gate;
    a run in several in-launch column chunks bit-equal to one chunk; real
    massless bodies under vpu2 at the exact float64 gate (JAX's K13 gives
    them 0); one launch an evaluation."""
    import torch
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.parallel import rdma_ring as k13
    from nbody_tpu_torch.utils.timing import time_ms
    t0 = time.perf_counter()
    for variant in ("vpu2", "vpu", "turbo", "mxu", "turbo2"):
        print(f"[k13] {variant}: {k13.max_blocks(variant)} co-resident CTAs "
              f"(the cooperative grid)")
    for p in RDMA_SHARDS:
        pos, mass = rdma_shards(RDMA_N, p, 60 + p, dev)
        c = pos.shape[0] // p
        ref = rect_forces(pos[:RDMA_N].double(), pos.double(), mass.double(),
                          eps2)
        for variant, one_sided in RDMA_CASES:
            tc = variant not in ("vpu", "vpu2")
            tol = ({"rel_tol": TC_REL_TOL, "abs_floor": TC_ABS_FLOOR,
                    "max_bad": int(RDMA_TC_MAX_BAD * pos.numel())} if tc
                   else {})
            what = (f"K13 {variant}{' one-sided' if one_sided else ''} "
                    f"P={p}")
            outs = {}
            for overlap in (False, True):
                before = k13.rdma_ring.launches
                got = k13.rdma_ring(pos, mass, p, eps2, variant, one_sided,
                                    overlap)
                check(k13.rdma_ring.launches == before + 1,
                      f"{what}: not one launch an evaluation")
                want = k13.rdma_ring_plain(pos, mass, p, eps2, variant,
                                           one_sided, overlap)
                torch.cuda.synchronize()
                proto = "overlap" if overlap else "sequential"
                err, _, bad = compare(f"{what} {proto} vs plain", got, want,
                                      **tol)
                if tc:
                    row_gate(f"{what} {proto} vs plain", got, want)
                    twin_outliers(f"{what} {proto}", variant, got, want,
                                  pos, mass, eps2, bad)
                check(torch.equal(got, k13.rdma_ring(
                    pos, mass, p, eps2, variant, one_sided, overlap)),
                    f"{what} {proto}: not bit-reproducible")
                few = k13.rdma_ring(pos, mass, p, eps2, variant, one_sided,
                                    overlap, slot_budget=3 * 2 * p * c * 12)
                check(torch.equal(few, got),
                      f"{what} {proto}: three column tiles a chunk differ "
                      f"from one chunk")
                outs[overlap] = got
            compare(f"{what} overlap vs sequential", outs[True], outs[False],
                    **tol)
            if tc:
                tier_gate(RDMA_TIERS[variant, one_sided],
                          outs[False][:RDMA_N], ref)
            else:
                compare(f"{what} vs float64", outs[False][:RDMA_N], ref)
            if p == 4 and (variant, one_sided) == ("vpu2", False):
                record["rdma_ring"] = {
                    "shape": f"N={RDMA_N} on {p} shards, pallas_sym2 "
                             f"(the auto path of --comm rdma)",
                    "max_abs_err": err,
                    "ms": time_ms(lambda: k13.rdma_ring(
                        pos, mass, p, eps2, variant), dev),
                    "plain_ms": time_ms(lambda: k13.rdma_ring_plain(
                        pos, mass, p, eps2, variant), dev, iters=3),
                    "bound": rdma_bound(variant, False, RDMA_N),
                    "schedule_bound_ms": rdma_schedule_bound(
                        variant, False, p, c)[0]}
                # The overlap protocol's kernel time beside it: its
                # copy items ride the compute phases' work lists.
                turns = [time_ms(lambda o=o: k13.rdma_ring(
                    pos, mass, p, eps2, variant, overlap=o), dev)
                    for o in (False, True, True, False)]
                record["rdma_ring"]["ms_overlap"] = statistics.median(
                    turns[1:3])
                print(f"[time] K13 vpu2 P={p} N={RDMA_N}, rounds of "
                      f"sequential, overlap, overlap, sequential: "
                      f"{', '.join(f'{t:.4f}' for t in turns)} ms "
                      f"({smi})")
    print("[check] K13 bit-reproducible, chunk-invariant (3 column tiles a "
          "chunk, both protocols)")

    # Real massless bodies under vpu2, sequential and overlap.
    p = 4
    pos, mass = rdma_shards(RDMA_N, p, 70, dev)
    zero = [3, 2048, 5000, 8191]
    mass[zero] = 0.0
    ref = rect_forces(pos[zero].double(), pos.double(), mass.double(), eps2)
    for overlap in (False, True):
        got = k13.rdma_ring(pos, mass, p, eps2, "vpu2", overlap=overlap)
        compare(f"K13 vpu2 P=4 {'overlap' if overlap else 'sequential'}, "
                f"massless rows vs float64", got[zero], ref)
        print(f"[check] K13 massless rows {zero}: |a| "
              f"{[f'{v:.4e}' for v in got[zero].norm(dim=1).tolist()]}; "
              f"JAX's K13 gives 0 there (_inv_mass_scale)")
    print(f"[time] K13 checks: {time.perf_counter() - t0:.1f} s")


def check_resident(dev, record):
    """K3 and K4 against their plain twins and, bit for bit, against the
    per-step K2 path; chunk invariance; real zero-mass bodies."""
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.ops import resident
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.utils.timing import time_ms
    print(f"[resident] co-resident grid: K3 {resident.max_blocks(False)} "
          f"blocks, K4 {resident.max_blocks(True)} blocks of 256 threads")
    cases = [("reference", 1000, 10), ("reference", 8192, 10),
             ("kdk", 8192, 5), ("yoshida4", 8192, 5)]
    errs = {"resident": 0.0, "resident_kdk": 0.0}
    for integrator, n, steps in cases:
        cfg = nt.SimConfig(n_bodies=n, impl="pallas_sym2",
                           integrator=integrator, seed=n + 11)
        state = nt.init_state(cfg)
        if integrator != "reference":
            state = nt.ops.step.prime_kdk(state, cfg)
        kname = "resident" if integrator == "reference" else "resident_kdk"
        what = f"{'K3' if kname == 'resident' else 'K4'} {integrator} N={n}"
        one = resident.run_steps_resident(state, cfg, 1)
        plain = resident.run_steps_resident_plain(state, cfg, 1)
        for k in ("pos", "vel", "acc"):
            err = compare(f"{what}, 1 step, {k} vs plain", getattr(one, k),
                          getattr(plain, k))
            if n == 8192:
                errs[kname] = max(errs[kname], err[0])
        got = resident.run_steps_resident(state, cfg, steps)
        per_step = nt.run_steps(state, cfg, steps, impl="pallas_sym2")
        check(states_equal(got, per_step),
              f"{what}: {steps} resident steps differ from {steps} "
              f"per-step K2 steps")
        split = steps // 2 - 1
        chained = resident.run_steps_resident(
            resident.run_steps_resident(state, cfg, split), cfg,
            steps - split)
        check(states_equal(got, chained),
              f"{what}: {split}+{steps - split} steps differ from {steps}")
        plain = resident.run_steps_resident_plain(state, cfg, steps)
        drift = float((got.pos - plain.pos).abs().max()
                      / plain.pos.abs().max())
        print(f"[check] {what}: {steps} steps bit-equal to {steps} per-step "
              f"K2 steps and to {split}+{steps - split}; pos vs plain after "
              f"{steps} steps max rel {drift:.3e}")
    cfg = nt.SimConfig(n_bodies=1000, impl="pallas_sym2", seed=7)
    state = nt.init_state(cfg)
    mass = state.mass.clone()
    mass[[3, 400, 999]] = 0.0
    state = state._replace(mass=mass)
    compare("K3 with three real zero-mass bodies vs direct form",
            resident.run_steps_resident(state, cfg, 1).acc,
            rect_forces(state.pos, state.pos, mass, cfg.eps2))

    # Times at the run verb's shapes: one launch of 1000 steps (K3) and
    # of 100 yoshida4 steps (K4) at N = 8192.
    n = 8192
    for kname, integrator, steps in (("resident", "reference", 1000),
                                     ("resident_kdk", "yoshida4", 100)):
        cfg = nt.SimConfig(n_bodies=n, impl="pallas_sym2",
                           integrator=integrator)
        state = nt.init_state(cfg)
        if integrator != "reference":
            state = nt.ops.step.prime_kdk(state, cfg)
        ref = integrator == "reference"
        evals = steps * (1 if ref else 3)
        flops = evals * (FLOPS_PAIR * n * (n - 1) // 2 + n * (
            FLOPS_REF_UPDATE if ref else FLOPS_KDK_UPDATE))
        ms = time_ms(lambda: resident.run_steps_resident(state, cfg, steps),
                     dev, iters=3, warmup=1)
        plain_ms = time_ms(lambda: resident.run_steps_resident_plain(
            state, cfg, steps), dev, iters=1, warmup=0)
        record[kname] = {
            "shape": f"N=8192, one launch of {steps} {integrator} steps",
            "max_abs_err": errs[kname], "ms": ms, "plain_ms": plain_ms,
            "bound": bound(flops, (64 if ref else 76) * n)}


def pe_total_f64(pos, mass, eps2, chunk=512):
    """The whole set's pair potential sum_i m_i sum_j m_j (|r|^2 +
    eps2)^(-1/2), self pairs included, in float64 on the card (torch
    float64), rows in chunks: the host would take minutes."""
    import torch
    p64, m64 = pos.double(), mass.double()
    total = 0.0
    for s in range(0, pos.shape[0], chunk):
        d2 = ((p64[None, :, :] - p64[s:s + chunk, None, :]) ** 2).sum(-1)
        total += float((m64[s:s + chunk, None] * m64[None, :]
                        / torch.sqrt(d2 + eps2)).sum())
    return total


def energy_by_rows(state, eps2):
    """total_energy_bounded as the parent computed it: K8's row sums of
    every body, summed in float64, the self total subtracted."""
    import torch
    from nbody_tpu_torch.models.energy import kinetic_energy
    from nbody_tpu_torch.ops import pe
    pos, mass = state.pos.float().contiguous(), state.mass.float().contiguous()
    ke = float(kinetic_energy(state.vel.double(), mass.double()))
    pot = float(torch.sum(pe.pe_rows(pos, mass, pos, mass, eps2)))
    pot -= float(torch.sum(mass.double() ** 2)) / float(eps2) ** 0.5
    return ke - 0.5 * pot


def check_pe(dev, record, smi):
    """K8's row sums against their plain twin at N = 8192 and against a
    float64 direct sum on 4096 sampled rows at N = 1,048,576; its
    symmetric total against its twin at 8192 (bit-reproducible), a float64
    total at 65,536 and the row sums' total at 1M; the energy at 1M by
    the parent's path (the row sums) and by the new one (the total)."""
    import torch
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.models.energy import total_energy_bounded
    from nbody_tpu_torch.ops import pe
    from nbody_tpu_torch.utils.timing import time_ms
    eps2 = 0.002
    n = 8192
    pos, mass = bodies(n, 81, dev)
    got = pe.pe_rows(pos, mass, pos, mass, eps2)
    want = pe.pe_rows_plain(pos, mass, pos, mass, eps2)
    err = compare(f"K8 pe_rows vs plain, N={n}", got, want)
    record["pe"] = {
        "shape": "N=8192 rows against N=8192 bodies (a full energy)",
        "max_abs_err": err[0],
        "ms": time_ms(lambda: pe.pe_rows(pos, mass, pos, mass, eps2), dev),
        "plain_ms": time_ms(lambda: pe.pe_rows_plain(pos, mass, pos, mass,
                                                     eps2), dev, iters=3),
        "bound": bound(FLOPS_PE * n * n, 16 * n + 16 * n + 8 * n)}
    got = pe.pe_total(pos, mass, eps2)
    check(torch.equal(got, pe.pe_total(pos, mass, eps2)),
          "K8 pe_total: not bit-reproducible from call to call")
    err = compare(f"K8 pe_total vs plain, N={n}", got.reshape(1),
                  pe.pe_total_plain(pos, mass, eps2).reshape(1),
                  rel_tol=1e-6, abs_floor=0.0)
    print("[check] K8 pe_total bit-reproducible from call to call")
    record["pe_total"] = {
        "shape": "N=8192 bodies, the symmetric total (a full energy)",
        "max_abs_err": err[0],
        "ms": time_ms(lambda: pe.pe_total(pos, mass, eps2), dev),
        "plain_ms": time_ms(lambda: pe.pe_total_plain(pos, mass, eps2), dev,
                            iters=3),
        "bound": bound(FLOPS_PE * n * (n - 1) // 2, 16 * n + 8)}

    n = 1 << 16
    pos, mass = bodies(n, 82, dev)
    compare(f"K8 pe_total at N={n} vs float64 direct total",
            pe.pe_total(pos, mass, eps2).reshape(1),
            torch.tensor([pe_total_f64(pos, mass, eps2)]), rel_tol=1e-5,
            abs_floor=0.0)

    n = 1 << 20
    state = nt.init_state(nt.SimConfig(n_bodies=n, seed=1))
    pos, mass = state.pos, state.mass
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(1))[
        :4096].to(dev)
    got = pe.pe_rows(pos[rows].contiguous(), mass[rows].contiguous(), pos,
                     mass, eps2)
    # The float64 direct sum, computed on the card (torch float64), rows
    # in chunks of 64: the host would take minutes for 4e9 pairs.
    p64, m64 = pos.double(), mass.double()
    want = torch.cat([
        m64[r] * (m64[None, :] / torch.sqrt(
            ((p64[None, :, :] - p64[r][:, None, :]) ** 2).sum(-1) + eps2)
        ).sum(1) for r in rows.split(64)])
    compare("K8 at N=1,048,576, 4096 sampled rows vs float64 direct sum",
            got, want, rel_tol=1e-5)
    compare("K8 pe_total at N=1,048,576 vs the row sums' total",
            pe.pe_total(pos, mass, eps2).reshape(1),
            pe.pe_rows(pos, mass, pos, mass, eps2).sum().reshape(1),
            rel_tol=2e-6, abs_floor=0.0)
    energies = {}
    for path, fn in (("the row sums (parent)", energy_by_rows),
                     ("pe_total", total_energy_bounded)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        energies[path] = fn(state, eps2)
        torch.cuda.synchronize()
        print(f"[1M] total energy {energies[path]:.10e} in "
              f"{time.perf_counter() - t0:.3f} s by {path}")
    e_old, e_new = energies.values()
    print(f"[1M] total energy, new vs parent path: rel "
          f"{abs(e_new - e_old) / abs(e_old):.3e} (gate 2e-6)")
    check(abs(e_new - e_old) <= 2e-6 * abs(e_old),
          "the 1M total energy moved with pe_total")
    k8_ms = time_ms(lambda: pe.pe_rows(pos, mass, pos, mass, eps2), dev,
                    iters=2, warmup=0)
    record["pe"]["ms_1m"] = k8_ms
    record["pe"]["bound_ms_1m"] = bound(FLOPS_PE * n * n, 40 * n)[0]
    total_ms = time_ms(lambda: pe.pe_total(pos, mass, eps2), dev, iters=2,
                       warmup=0)
    record["pe_total"]["ms_1m"] = total_ms
    record["pe_total"]["bound_ms_1m"] = bound(FLOPS_PE * n * (n - 1) // 2,
                                              16 * n + 8)[0]
    print(f"[1M] K8 row sums {k8_ms:.2f} ms, symmetric total "
          f"{total_ms:.2f} ms per launch over 1,048,576 bodies ({smi})")


def check_k2_1m(dev):
    """K2 at the 1M headline, sampled rows vs the direct form."""
    import torch
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.utils.timing import time_ms
    n = 1 << 20
    cfg = nt.SimConfig(n_bodies=n, device="cuda")
    check(nt.resolve_impl(cfg) == "pallas_sym2", "auto at 1M is not K2")
    state = nt.init_state(cfg)
    t0 = time.perf_counter()
    acc = nt.compute_forces(state.pos, state.mass, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    eval_ms = time_ms(lambda: nt.compute_forces(state.pos, state.mass, cfg),
                      dev, iters=2, warmup=0)
    print(f"[1M] compute_forces (K2) first call {first_s:.3f} s; "
          f"{eval_ms:.2f} ms per evaluation")
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(0))[:4096]
    rows = rows.to(dev)
    ref = rect_forces(state.pos[rows], state.pos, state.mass, cfg.eps2,
                      chunk=64)
    compare("K2 at N=1,048,576, 4096 sampled rows vs rect_forces",
            acc[rows], ref)


def parent_csrc():
    """PARENT_CSRC, unpacked from git where it is not there yet; None
    where neither is to be had."""
    if not os.path.isdir(PARENT_CSRC):
        root = os.path.dirname(os.path.dirname(PARENT_CSRC))
        try:
            tar = subprocess.run(
                ["git", "-C", ROOT, "archive", PARENT_COMMIT,
                 "nbody_tpu_torch/csrc"], capture_output=True, check=True,
                timeout=120).stdout
            os.makedirs(root, exist_ok=True)
            subprocess.run(["tar", "-x", "-C", root], input=tar, check=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError) as err:
            print(f"[redesign] no parent sources at {PARENT_CSRC} and none "
                  f"from git ({type(err).__name__})")
            return None
    return PARENT_CSRC if os.path.isdir(PARENT_CSRC) else None


def start_sass_compare(csrc):
    """tools/ptxas_compare.py of SASS_LIBS against the parent's sources,
    in the background (its builds overlap the card's phases)."""
    os.makedirs(WORK, exist_ok=True)
    log = open(os.path.join(WORK, "ptxas_compare.log"), "w")
    cmd = [sys.executable, os.path.join(ROOT, "tools", "ptxas_compare.py"),
           csrc, os.path.join(ROOT, "nbody_tpu_torch", "csrc"), *SASS_LIBS,
           "--ops"]
    for pattern in SASS_REDESIGNED:
        cmd += ["--allow", pattern]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            start_new_session=True)

    def stop():
        # A failed phase ends the script before finish_sass_compare: stop
        # the comparison and the nvcc it runs.
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    atexit.register(stop)
    return proc, log


def finish_sass_compare(job):
    """Wait for the comparison and fail unless every kernel outside
    SASS_REDESIGNED kept the parent's SASS."""
    proc, log = job
    rc = proc.wait(timeout=600)
    log.close()
    with open(log.name) as f:
        lines = f.read().splitlines()
    redesigned = [re.compile(p) for p in SASS_REDESIGNED]
    for line in lines:
        name = line.strip().removeprefix("new: ").removeprefix("old: ")
        if ("==" in line or "DIFFERS" in line or "MISSING" in line
                or "ptxas_compare" in line
                or any(p.search(name) for p in redesigned)):
            print(f"[sass] {line.strip()}")
    kept = sum("identical" in line for line in lines)
    print(f"[sass] {kept} kernels of {', '.join(SASS_LIBS)} with the "
          f"parent's SASS; allowed to change: {', '.join(SASS_REDESIGNED)}")
    check(rc == 0, "tools/ptxas_compare.py: a kernel outside the redesign "
          "changed its SASS")


def build_parent(csrc, names):
    """ctypes libraries of the parent's ``names`` (csrc/<name>.cu), built
    with the package's nvcc flags, one nvcc each, all at once."""
    import ctypes
    from nbody_tpu_torch.ops import _build
    out = os.path.join(WORK, "parent")
    os.makedirs(out, exist_ok=True)
    jobs = {}
    for name in names:
        so = os.path.join(out, f"lib{name}.so")
        jobs[name] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(csrc, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"parent {name}.cu: nvcc failed\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[redesign] parent {name}.cu: {line.strip()}")
        libs[name] = ctypes.CDLL(so)
    return libs


def alternate(fns, dev, iters, warmup=1):
    """{name: [ms of each round]}: every function of ``fns`` timed once a
    round (CUDA events, ``iters`` calls), the order reversed every other
    round."""
    from nbody_tpu_torch.utils.timing import time_ms
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(REDESIGN_ROUNDS):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(time_ms(fns[k], dev, iters=iters, warmup=warmup))
    return times


def report_rounds(what, times, smi):
    """Print the rounds, the medians and new / parent; returns the
    medians."""
    med = {k: statistics.median(v) for k, v in times.items()}
    rounds = "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v)
                       for k, v in times.items())
    print(f"[redesign] {what}: parent {med['parent']:.4f} ms, new "
          f"{med['new']:.4f} ms, new/parent "
          f"{med['new'] / med['parent']:.4f} (medians of "
          f"{REDESIGN_ROUNDS} rounds: {rounds}) ({smi})")
    return med


def pair_passes_ms(pos, mass, eps2, dev, pairs):
    """The pair passes alone of one pair-symmetric sweep (K2's offset
    chunks and slots; ``pairs`` the C entry, K5's here) over every offset
    chunk of one evaluation, without the reduce passes, ms."""
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.utils.timing import time_ms
    n = pos.shape[0]
    nb = -(-n // k2.SYM_TILE)
    chunks = k2.offset_chunks(nb, nb * k2.SYM_TILE, k2.SLOT_BUDGET_BYTES)
    slots = max(dc for _, dc in chunks) * nb * k2.SYM_TILE * 3
    si, sj = pos.new_empty(slots), pos.new_empty(slots)
    stream = _build.stream_handle(pos)

    def run():
        for d_lo, dc in chunks:
            _build.check_launch("pair passes", pairs(
                pos.data_ptr(), mass.data_ptr(), n, nb, d_lo, dc, eps2,
                si.data_ptr(), sj.data_ptr(), stream))
    return time_ms(run, dev, iters=2, warmup=1)


def check_redesign(dev, eps2, record, smi, csrc):
    """K8 and K5 against the parent's designs on the same inputs, in
    alternating rounds at N = 8192 and 1,048,576: K8's symmetric total
    (pe_total) against the parent's row sums of every body, summed, as
    total_energy_bounded took them; K5 against the parent's K5 (its
    untrimmed geometry).  Each new kernel must be faster than the parent's
    in every round at 1M; K8's totals must agree within rel 2e-6, and
    K5's largest difference is printed."""
    import ctypes
    import torch
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_sym_tc as k5
    from nbody_tpu_torch.ops import pe
    t0 = time.perf_counter()
    libs = build_parent(csrc, ("pe", "forces_sym_tc"))
    pp, pt = libs["pe"], libs["forces_sym_tc"]
    pp.nbt_pe_rows.argtypes = pe._lib().nbt_pe_rows.argtypes
    pp.nbt_pe_rows.restype = ctypes.c_int
    new_tc = k5._lib()
    for name in ("nbt_sym_turbo_pairs", "nbt_sym_tc_reduce"):
        getattr(pt, name).argtypes = getattr(new_tc, name).argtypes
        getattr(pt, name).restype = getattr(new_tc, name).restype

    def parent_pe(p, m):
        out = torch.empty(p.shape[0], dtype=torch.float64, device=p.device)
        _build.check_launch("parent pe_rows", pp.nbt_pe_rows(
            p.data_ptr(), m.data_ptr(), p.shape[0], p.data_ptr(),
            m.data_ptr(), p.shape[0], eps2, out.data_ptr(),
            _build.stream_handle(p)))
        return out.sum()

    def k5_sweep(lib):
        # K5's sweep through the same host path for both builds (the
        # wrapper adds its checks on top): at 8192 the call is host-bound.
        return lambda p, m: k2.sweep("forces_sym_turbo", p, m, eps2,
                                     k2.SLOT_BUDGET_BYTES,
                                     lib.nbt_sym_turbo_pairs,
                                     lib.nbt_sym_tc_reduce)
    parent_k5, new_k5 = k5_sweep(pt), k5_sweep(new_tc)

    for n, iters in ((8192, 20), (1 << 20, 1)):
        tag = "N=8192" if n == 8192 else "N=1,048,576"
        key = "" if n == 8192 else "_1m"
        pos, mass = bodies(n, n + 10, dev)
        compare(f"pe_total {tag}, new vs the parent's row sums summed",
                pe.pe_total(pos, mass, eps2).reshape(1),
                parent_pe(pos, mass).reshape(1), rel_tol=2e-6,
                abs_floor=0.0)
        times = alternate({"parent": lambda: parent_pe(pos, mass),
                           "new": lambda: pe.pe_total(pos, mass, eps2)},
                          dev, iters)
        med = report_rounds(f"K8 {tag}: pe_total against the parent's "
                            f"pe_rows summed", times, smi)
        record["pe_total"].update({f"parent_ms{key}": med["parent"],
                                   f"new_ms{key}": med["new"]})
        if n > 8192:
            check(max(times["new"]) < min(times["parent"]),
                  "pe_total at 1M: not faster than the parent in every "
                  "round")
        new, old = k5.forces_sym_turbo(pos, mass, eps2), parent_k5(pos, mass)
        torch.cuda.synchronize()
        check(torch.equal(new, new_k5(pos, mass)),
              f"forces_sym_turbo {tag}: the wrapper and the timed sweep differ")
        diff = (new - old).abs()
        print(f"[redesign] forces_sym_turbo {tag}, new vs parent: largest "
              f"difference {float(diff.max() / old.abs().max()):.3e} of "
              f"max |a|, {int((diff > 0).sum())} of {diff.numel()} "
              f"components differ")
        times = alternate({"parent": lambda: parent_k5(pos, mass),
                           "new": lambda: new_k5(pos, mass)}, dev, iters)
        med = report_rounds(f"K5 {tag}", times, smi)
        record["forces_sym_turbo"].update({f"parent_ms{key}": med["parent"],
                                           f"new_ms{key}": med["new"]})
        if n > 8192:
            check(max(times["new"]) < min(times["parent"]),
                  "forces_sym_turbo at 1M: not faster than the parent in "
                  "every round")
            split = {"parent": pair_passes_ms(pos, mass, eps2, dev,
                                              pt.nbt_sym_turbo_pairs),
                     "new": pair_passes_ms(pos, mass, eps2, dev,
                                           new_tc.nbt_sym_turbo_pairs)}
            print(f"[redesign] forces_sym_turbo N=1,048,576 split: the pair "
                  f"passes {split['new']:.3f} ms of {med['new']:.3f} "
                  f"(parent {split['parent']:.3f} of {med['parent']:.3f}); "
                  f"the reduce passes (slots, diagonal) "
                  f"{med['new'] - split['new']:.3f} ms ({smi})")
        del pos, mass, new, old, diff
    print(f"[time] redesign rounds: {time.perf_counter() - t0:.1f} s")


def crossovers(dev, smi):
    """K1 / K2 per force evaluation, and the resident kernels against the
    per-step K2 path per step, over N."""
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_tiled as k1
    from nbody_tpu_torch.ops import resident
    from nbody_tpu_torch.ops.forces import SYM_CROSSOVER_N
    from nbody_tpu_torch.utils.timing import time_ms
    eps2 = 0.002
    # Median of five alternating rounds of 100 launches each.
    print(f"[crossover] N, K1 ms, K2 ms, median of 5 ({smi}); auto takes "
          f"K2 from N={SYM_CROSSOVER_N}")
    for n in (512, 1024, 1536, 2048, 3072, 4096, 8192, 16384):
        pos, mass = bodies(n, 3, dev)
        t1, t2 = [], []
        for _ in range(5):
            t1.append(time_ms(lambda: k1.forces_tiled(pos, mass, eps2), dev,
                              iters=100))
            t2.append(time_ms(lambda: k2.forces_sym(pos, mass, eps2), dev,
                              iters=100))
        t1, t2 = statistics.median(t1), statistics.median(t2)
        print(f"[crossover] {n} {t1:.4f} {t2:.4f} "
              f"{'K2' if t2 < t1 else 'K1'} faster")
    # ms per step: one resident launch against the per-step loop on the
    # same chunk, alternating, median of the rounds.
    print(f"[resident crossover] integrator, N, resident ms/step, per-step "
          f"K2 ms/step, median of rounds of chunks ({smi}); auto window "
          f"{resident.RESIDENT_AUTO_MIN_N}..{resident.RESIDENT_AUTO_MAX_N}")
    for integrator, chunk, rounds in (("reference", 1000, 5),
                                      ("yoshida4", 200, 3)):
        for n in (1536, 2048, 4096, 8192, 12288, 16384, 32768):
            cfg = nt.SimConfig(n_bodies=n, impl="pallas_sym2",
                               integrator=integrator)
            state = nt.init_state(cfg)
            tr, ts = [], []
            for _ in range(rounds):
                tr.append(time_ms(lambda: resident.run_steps_resident(
                    state, cfg, chunk), dev, iters=1, warmup=1) / chunk)
                ts.append(time_ms(lambda: nt.run_steps(
                    state, cfg, chunk, impl="pallas_sym2"), dev, iters=1,
                    warmup=1) / chunk)
            tr, ts = statistics.median(tr), statistics.median(ts)
            print(f"[resident crossover] {integrator} {n} {tr:.5f} {ts:.5f} "
                  f"{'resident' if tr < ts else 'per-step'} faster "
                  f"({ts / tr:.3f}x)")


def share_oracle_runs():
    """validate's numpy oracle is a pure function of its inputs and takes
    ~50 s a run at N = 8192 on the card's host; the validate phases at
    seed 5 (K2, K1, K7, K11 and each tensor-core tier) start from one
    state, so each distinct oracle run is computed once and handed to every
    phase that asks for it."""
    import hashlib
    from nbody_tpu_torch.oracle import numpy_oracle
    run, runs = numpy_oracle.oracle_run, {}

    def shared(pos, vel, mass, *args, **kw):
        h = hashlib.sha256()
        for a in (pos, vel, mass):
            h.update(a.tobytes())
        key = (h.hexdigest(), args, tuple(sorted(kw.items())))
        if key not in runs:
            runs[key] = run(pos, vel, mass, *args, **kw)
        return runs[key]
    numpy_oracle.oracle_run = shared


def main_path(counts, reset):
    """The CLI's main paths with the launch counters: validate at N = 8192
    (K1, K2, K7, K11, and the tensor-core tiers K9, K10, K5, K6, K14a), the
    entry point ``forces_pallas_sym`` at N = 8192 (K14b, K14c, K14d), and
    the run verb (K3, K4, auto, K8 at 1M, K5 and K14a at 1M, K12 with
    --sort-every at 8192 and 1M, resume).  Returns the launches of every
    kernel over all of them."""
    import numpy as np
    from nbody_tpu_torch.cli import main as cli_main

    def phase(what, argv, expect=None):
        before = counts()
        rc = cli_main(argv)
        check(rc == 0, f"{what}: exit {rc}")
        delta = {k: v - before[k] for k, v in counts().items()}
        print(f"[main path] {what}: launches {delta}")
        for k, v in (expect or {}).items():
            check(v(delta[k]), f"{what}: {k} launched {delta[k]} times")
        return delta

    share_oracle_runs()
    reset()
    # The float64 gates run at seed 5: at seeds 0, 1, 2 and 4 the uniform
    # box holds close encounters whose 10-step outcome differs between
    # float32 and float64 arithmetic, and there the numpy oracle run in
    # float32 misses the float64 gate on the same components as the
    # kernels (PERF.md, "Validate horizon at N=8192").  Seed 0, the
    # default, is gated against the float32 oracle.
    for impl, kernel, extra in (
            ("auto", "forces_sym", ["--seed", "5"]),
            ("pallas", "forces_tiled", ["--seed", "5"]),
            ("pallas_sym", "forces_sym_vpu", ["--seed", "5"]),
            ("pallas_kahan", "forces_tiled_kahan", ["--seed", "5"]),
            ("auto", "forces_sym", ["--seed", "0", "--oracle-f32"])):
        phase(f"validate --impl {impl} {' '.join(extra)}",
              ["validate", "--n", "8192", "--steps", "10", "--long-steps",
               "0", "--impl", impl, *extra],
              {k: (lambda v: v == 10) if k == kernel else (lambda v: v == 0)
               for k in counts()})

    # The tensor-core tiers, each held to its gate: allowances no looser
    # than the tier's bad fraction, for pos, vel and acc.
    for kernel, impl in TIER_IMPLS.items():
        t0 = time.perf_counter()
        frac = str(TIER_GATES[kernel][1])
        phase(f"validate --impl {impl} --seed 5 --max-bad-frac {frac} "
              f"--max-bad-frac-acc {frac}",
              ["validate", "--n", "8192", "--steps", "10", "--long-steps",
               "0", "--impl", impl, "--seed", "5", "--max-bad-frac", frac,
               "--max-bad-frac-acc", frac],
              {k: (lambda v: v == 10) if k == kernel else (lambda v: v == 0)
               for k in counts()})
        print(f"[time] validate --impl {impl}: "
              f"{time.perf_counter() - t0:.1f} s")

    # The variants without an impl, through the entry point a caller
    # names them by: each launches its own kernel once and nothing else.
    import torch
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.ops.forces_sym_variants import forces_pallas_sym
    cfg = nt.SimConfig(n_bodies=8192, seed=5)
    state = nt.init_state(cfg)
    for kernel, kw in (("forces_sym_turbof", {"variant": "turbof"}),
                       ("forces_sym_turbop", {"variant": "turbop"}),
                       ("forces_sym_fold", {"variant": "vpu2",
                                            "schedule": "fold"}),
                       ("forces_sym_vpu_fold", {"variant": "vpu",
                                                "schedule": "fold"})):
        before = counts()
        acc = forces_pallas_sym(state.pos, state.mass, cfg.eps2, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(acc).all()),
              f"forces_pallas_sym {kw}: non-finite")
        delta = {k: v - before[k] for k, v in counts().items()}
        print(f"[main path] forces_pallas_sym N=8192 {kw}: launches {delta}")
        check(all(v == (1 if k == kernel else 0) for k, v in delta.items()),
              f"forces_pallas_sym {kw}: launches {delta}")
    # K8's row sums, the entry point for a subset of rows against every
    # body (the energy takes the symmetric total).
    from nbody_tpu_torch.ops import pe
    before = counts()
    rows = pe.pe_rows(state.pos[:1024].contiguous(),
                      state.mass[:1024].contiguous(), state.pos, state.mass,
                      cfg.eps2)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(rows).all()), "pe_rows: non-finite")
    delta = {k: v - before[k] for k, v in counts().items()}
    print(f"[main path] pe_rows 1024 rows of N=8192: launches {delta}")
    check(all(v == (1 if k == "pe" else 0) for k, v in delta.items()),
          f"pe_rows: launches {delta}")

    # The sharded path: validate through the mesh at N = 8192 (P = 4:
    # the self shards, one cross rotation through K2-rect, the antipodal
    # rotation through K1; P = 3: the self shards and one cross rotation;
    # P = 2 with the all-gather: K1 only), 10 steps of P shards each.
    # Launches per run: P x 10 of each kernel of the schedule.
    for shards, impl, extra, expect in (
            (4, "pallas_sym2", [], {"forces_sym": 40,
                                    "rect_forces_sym_vpu2": 40,
                                    "forces_tiled": 40}),
            (3, "pallas_sym_turbo2", "forces_sym_turbo2",
             {"forces_sym_turbo2": 30, "rect_forces_sym_turbo2": 30}),
            (3, "pallas_sym", [], {"forces_sym_vpu": 30,
                                   "rect_forces_sym_vpu": 30}),
            (3, "pallas_sym_turbo", "forces_sym_turbo",
             {"forces_sym_turbo": 30, "rect_forces_sym_turbo": 30}),
            (3, "pallas_sym_mxu", "forces_sym_mxu",
             {"forces_sym_mxu": 30, "rect_forces_sym_mxu": 30}),
            (2, "pallas", ["--comm", "allgather"], {"forces_tiled": 20})):
        if isinstance(extra, str):
            frac = str(TIER_GATES[extra][1])
            extra = ["--max-bad-frac", frac, "--max-bad-frac-acc", frac]
        t0 = time.perf_counter()
        phase(f"validate --shards {shards} --impl {impl} --seed 5 "
              + " ".join(extra),
              ["validate", "--n", "8192", "--steps", "10", "--long-steps",
               "0", "--shards", str(shards), "--impl", impl, "--seed", "5",
               *extra],
              {k: (lambda v, e=expect.get(k, 0): v == e) for k in counts()})
        print(f"[time] validate --shards {shards} --impl {impl}: "
              f"{time.perf_counter() - t0:.1f} s")
    # The fused ring K13 through the CLI: one launch a force evaluation
    # (10 a validate of 10 reference steps; a KDK prime and 10 kdk steps
    # 11; 10 + 100 with the long phase), no other kernel.
    k13 = "rdma_ring"
    for what, argv, evals in (
            ("validate --shards 4 --comm rdma (auto)",
             ["--shards", "4", "--comm", "rdma"], 10),
            ("validate --shards 3 --comm rdma --impl pallas_sym_turbo2",
             ["--shards", "3", "--comm", "rdma", "--impl",
              "pallas_sym_turbo2", "forces_sym_turbo2"], 10),
            ("validate --shards 3 --comm rdma --impl pallas_sym_mxu",
             ["--shards", "3", "--comm", "rdma", "--impl", "pallas_sym_mxu",
              "forces_sym_mxu"], 10),
            ("validate --shards 5 --comm rdma_overlap --impl pallas_sym",
             ["--shards", "5", "--comm", "rdma_overlap", "--impl",
              "pallas_sym"], 10),
            ("validate --shards 2 --comm rdma --impl pallas",
             ["--shards", "2", "--comm", "rdma", "--impl", "pallas"], 10),
            ("validate --shards 4 --comm rdma --long-steps 100 --oracle "
             "native", ["--shards", "4", "--comm", "rdma", "--long-steps",
                        "100", "--oracle", "native"], 110)):
        if argv[-1] in TIER_GATES:
            frac = str(TIER_GATES[argv.pop()][1])
            argv += ["--max-bad-frac", frac, "--max-bad-frac-acc", frac]
        t0 = time.perf_counter()
        phase(what, ["validate", "--n", "8192", "--steps", "10",
                     "--long-steps", "0", "--seed", "5", *argv],
              {k: (lambda v, e=(evals if k == k13 else 0): v == e)
               for k in counts()})
        print(f"[time] {what}: {time.perf_counter() - t0:.1f} s")
    phase("run --n 8192 --shards 4 --comm rdma --integrator kdk --steps 10",
          ["run", "--n", "8192", "--shards", "4", "--comm", "rdma",
           "--integrator", "kdk", "--steps", "10"],
          {k: (lambda v, e=(11 if k == k13 else 0): v == e)
           for k in counts()})
    # K2-rect's variants without an impl, through the entry point a
    # caller names them by, at a shard pair of the 4-shard ring at 8192.
    from nbody_tpu_torch.ops.forces_sym_variants import rect_forces_sym
    pa, pb = state.pos[:2048], state.pos[2048:4096]
    ma, mb = state.mass[:2048], state.mass[2048:4096]
    for kernel, kw in (("rect_forces_sym_turbof", {"variant": "turbof"}),
                       ("rect_forces_sym_turbop", {"variant": "turbop"}),
                       ("rect_forces_sym_fold", {"variant": "vpu2",
                                                 "schedule": "fold"}),
                       ("rect_forces_sym_vpu_fold", {"variant": "vpu",
                                                     "schedule": "fold"})):
        before = counts()
        out = rect_forces_sym(pa, ma, pb, mb, cfg.eps2, **kw)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in out),
              f"rect_forces_sym {kw}: non-finite")
        delta = {k: v - before[k] for k, v in counts().items()}
        print(f"[main path] rect_forces_sym 2048x2048 {kw}: launches "
              f"{delta}")
        check(all(v == (1 if k == kernel else 0) for k, v in delta.items()),
              f"rect_forces_sym {kw}: launches {delta}")
    # K15, the bench-only ablations, the way a sweep reaches them:
    # enable(), then both entry points by variant name, at N = 8192 and on
    # check_ablations' rect sets.  Each form launches its own kernel once.
    from nbody_tpu_torch.ops import ablation_sym
    ablation_sym.enable()
    pa, ma, pb, mb = ablation_rect_sets("cuda")
    for variant in ablation_sym.ABLATION_NAMES:
        for kernel, call in (
                (f"forces_sym_{variant}", lambda: [forces_pallas_sym(
                    state.pos, state.mass, cfg.eps2, variant=variant)]),
                (f"rect_forces_sym_{variant}", lambda: rect_forces_sym(
                    pa, ma, pb, mb, cfg.eps2, variant=variant))):
            before = counts()
            out = call()
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(x).all()) for x in out),
                  f"{kernel}: non-finite")
            delta = {k: v - before[k] for k, v in counts().items()}
            check(all(v == (1 if k == kernel else 0)
                      for k, v in delta.items()),
                  f"{kernel} through its entry point: launches {delta}")
        print(f"[main path] forces_pallas_sym N=8192 / rect_forces_sym "
              f"{ABLATION_RECT[0]}x{ABLATION_RECT[1]} variant={variant}: "
              f"one launch each")

    os.makedirs(WORK, exist_ok=True)
    a, b, c = (os.path.join(WORK, f"{x}.npz") for x in "abc")
    never = (lambda v: v == 0)
    phase("run --n 8192 --steps 1000 --resident on --checkpoint",
          ["run", "--n", "8192", "--steps", "1000", "--resident", "on",
           "--checkpoint", a],
          {"resident": lambda v: v >= 1, "forces_sym": never,
           "resident_kdk": never})
    phase("run --resume (500 more steps)",
          ["run", "--resume", a, "--steps", "500", "--checkpoint", b],
          {"resident": lambda v: v >= 1, "forces_sym": never})
    phase("run --n 8192 --steps 1500 --resident on (uninterrupted)",
          ["run", "--n", "8192", "--steps", "1500", "--resident", "on",
           "--checkpoint", c], {"resident": lambda v: v >= 1})
    with np.load(b) as zb, np.load(c) as zc:
        check(int(zb["step"]) == int(zc["step"]) == 1500, "resume steps")
        for k in ("pos", "vel", "acc", "mass"):
            check(np.array_equal(zb[k], zc[k]),
                  f"resume: {k} after 1000 + 500 steps differs from 1500")
    print("[main path] resume: 1000 + 500 steps bit-equal to 1500 steps")
    phase("run --n 8192 --integrator yoshida4 --resident on --steps 100",
          ["run", "--n", "8192", "--integrator", "yoshida4", "--resident",
           "on", "--steps", "100"],
          {"resident_kdk": lambda v: v >= 1, "resident": never})
    delta = phase("run --n 8192 --steps 1000 (auto)",
                  ["run", "--n", "8192", "--steps", "1000"])
    print(f"[main path] auto at N=8192 ran "
          f"{'resident K3' if delta['resident'] else 'per-step K2'}")
    phase("run --n 1048576 --steps 2 --energy",
          ["run", "--n", "1048576", "--steps", "2", "--energy"],
          {k: (lambda v: v == 2) if k in ("forces_sym", "pe_total")
           else (lambda v: v == 0) for k in counts()})
    t0 = time.perf_counter()
    phase("run --impl pallas_sym_turbo --n 1048576 --steps 2",
          ["run", "--impl", "pallas_sym_turbo", "--n", "1048576", "--steps",
           "2"],
          {k: (lambda v: v == 2) if k == "forces_sym_turbo"
           else (lambda v: v == 0) for k in counts()})
    print(f"[time] run --impl pallas_sym_turbo at 1M: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    end = os.path.join(WORK, "turbo2_1m.npz")
    phase("run --impl pallas_sym_turbo2 --n 1048576 --steps 2",
          ["run", "--impl", "pallas_sym_turbo2", "--n", "1048576", "--steps",
           "2", "--checkpoint", end],
          {k: (lambda v: v == 2) if k == "forces_sym_turbo2"
           else (lambda v: v == 0) for k in counts()})
    with np.load(end) as z:
        check(np.isfinite(z["pos"]).all() and np.isfinite(z["vel"]).all(),
              "run --impl pallas_sym_turbo2 at 1M: non-finite end state")
    print(f"[time] run --impl pallas_sym_turbo2 at 1M: "
          f"{time.perf_counter() - t0:.1f} s")
    # K12, the documented way: Morton-sorted first and every K steps; every
    # body of the end state finite (the watchdog reads body 0 only).
    for n, steps, every in (("8192", "100", "10"), ("1048576", "2", "1")):
        t0 = time.perf_counter()
        end = os.path.join(WORK, f"fast_{n}.npz")
        phase(f"run --impl pallas_fast --sort-every {every} --n {n} "
              f"--steps {steps}",
              ["run", "--impl", "pallas_fast", "--sort-every", every, "--n",
               n, "--steps", steps, "--checkpoint", end],
              {k: (lambda v, s=int(steps): v == s) if k == "forces_fast"
               else (lambda v: v == 0) for k in counts()})
        with np.load(end) as z:
            check(np.isfinite(z["pos"]).all() and np.isfinite(z["vel"]).all(),
                  f"run --impl pallas_fast at N={n}: non-finite end state")
            print(f"[main path] pallas_fast N={n}: end state finite, max "
                  f"|x| {np.abs(z['pos']).max():.4e}")
        print(f"[time] run --impl pallas_fast at N={n}: "
              f"{time.perf_counter() - t0:.1f} s")
    launches = counts()
    print(f"[main path] launch counts: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path did not launch: {launches}")
    return launches


def ring_1m(dev, smi, record):
    """One N3L-ring step at N = RING_N on 4 shards of this card and one
    K13 step (``--comm rdma``) against the single-device K2 step, in rounds
    of K2, ring, K13, K13, ring, K2 (one card moves no bytes between
    shards: the rings' extra time is their schedules), and the ring's parts
    at the shard shape: K2 on one 262,144-body shard and K1 on one
    antipodal 262,144 x 262,144 sweep; K13's phases by partial launches."""
    import numpy as np
    import torch
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_tiled as k1
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.oracle.numpy_oracle import relative_mismatch
    from nbody_tpu_torch.ops.forces_sym import SLOT_BUDGET_BYTES
    from nbody_tpu_torch.parallel import rdma_ring as k13
    from nbody_tpu_torch.parallel.mesh import make_mesh
    from nbody_tpu_torch.parallel.ring import run_steps_sharded
    from nbody_tpu_torch.utils.timing import time_ms
    n, p = RING_N, 4
    cfg = nt.SimConfig(n_bodies=n, impl="pallas_sym2", seed=3,
                       device=str(dev))
    state = nt.init_state(cfg)
    mesh = make_mesh(p, dev)
    print(f"[ring 1M] {mesh.describe()}")

    def one():
        return nt.run_steps(state, cfg, 1)

    def ring_step():
        return run_steps_sharded(state, cfg, mesh, 1, impl="pallas_sym2")

    def rdma_step():
        return run_steps_sharded(state, cfg, mesh, 1, impl="pallas_sym2",
                                 comm="rdma")

    # The ring sums each row in another order than K2 (shard tiles, the
    # rect slots, K1's one-sided antipodal sweep).  Against K2: no
    # component outside validate's 1% gate.  The components outside the
    # exact tolerance, and 4096 sampled rows, against a float64 direct
    # sum: the ring and K2 each at the exact tiers' gate (at most 5e-4 of
    # the components outside 1%), with both errors printed.  Then
    # ring_parts pins the rows where the two differ on the part that
    # carries the difference (K1's antipodal sweep) and holds the others,
    # K2-rect among them, at a tenth of the exact tolerance.
    ring_acc, one_acc = ring_step().acc, one().acc
    before = k13.rdma_ring.launches
    rdma_acc = rdma_step().acc
    torch.cuda.synchronize()
    print(f"[ring 1M] K13 launches a step: "
          f"{k13.rdma_ring.launches - before}")
    check(k13.rdma_ring.launches - before == 1, "ring 1M: K13 launches")
    compare("4-shard K13 step vs single-device K2 step, N=1M, acc, at 1%",
            rdma_acc, one_acc, rel_tol=0.01)
    compare("4-shard N3L ring step vs single-device K2 step, N=1M, acc, "
            "at 1%", ring_acc, one_acc, rel_tol=0.01)
    diff = relative_mismatch(ring_acc.double().cpu().numpy(),
                             one_acc.double().cpu().numpy(), REL_TOL,
                             ABS_FLOOR * float(one_acc.abs().max()))
    diff_rows = sorted({int(i) for i in np.nonzero(diff)[0]})
    sampled = torch.randperm(n, generator=torch.Generator().manual_seed(3))
    rows = sorted(set(diff_rows[:512]) | set(sampled[:4096].tolist()))
    at = {r: k for k, r in enumerate(rows)}
    dsel = [at[r] for r in diff_rows[:512]]
    rows = torch.tensor(rows, device=dev)
    ref = rect_forces(state.pos[rows].double(), state.pos.double(),
                      state.mass.double(), cfg.eps2, chunk=64)
    for what, acc in (("4-shard ring", ring_acc), ("K2", one_acc),
                      ("4-shard K13", rdma_acc)):
        got = acc[rows]
        p99, frac = gate_numbers(got, ref)
        d99, dfrac = (gate_numbers(got[dsel], ref[dsel]) if dsel
                      else (0.0, 0.0))
        print(f"[ring 1M] {what} vs float64 on {len(rows)} rows (the "
              f"{len(diff_rows)} rows where ring and K2 differ past rel "
              f"{REL_TOL:g}, and 4096 sampled): p99 rel err {p99:.3e}, bad "
              f"fraction at 1% {frac:.3e} (gate 5e-4); on the differing "
              f"rows p99 {d99:.3e}, bad fraction {dfrac:.3e}")
        check(frac <= 5e-4, f"ring 1M: {what} vs float64 bad fraction "
              f"{frac:.3e}")
        if dsel:
            e = ((got[dsel].double() - ref[dsel]).norm(dim=1)
                 / ref[dsel].norm(dim=1))
            print(f"[ring 1M] {what}: |err| / |a| against float64 on the "
                  f"{len(dsel)} rows where ring and K2 differ: max "
                  f"{float(e.max()):.3e}, median {float(e.median()):.3e}")
            check(float(e.max()) <= RING_PART_GATES["ring"],
                  f"ring 1M: {what} off by {float(e.max()):.3e} of |a|")
    ring_parts(state, cfg, p, ring_acc, diff_rows[:512], dev)
    single, ring, rdma = [], [], []
    for _ in range(RING_ROUNDS):
        turns = [time_ms(f, dev, iters=1, warmup=0)
                 for f in (one, ring_step, rdma_step, rdma_step, ring_step,
                           one)]
        single += [turns[0], turns[5]]
        ring += [turns[1], turns[4]]
        rdma += turns[2:4]
    # K13's phases by partial launches: the self sweep alone, then with
    # the two-sided phase, then the whole evaluation (the antipodal phase
    # and the finish).
    parts = [time_ms(lambda k=k: k13._launch(
        state.pos, state.mass, p, cfg.eps2, "vpu2", False, False,
        SLOT_BUDGET_BYTES, phases=k), dev, iters=1, warmup=1)
        for k in (1, 2, 3)]
    # The overlap protocol over 13 in-launch column chunks a phase,
    # against the sequential protocol at the exact twin tolerance, before
    # it is timed.
    compare("4-shard K13 vpu2 N=1M, overlap vs sequential",
            k13.rdma_ring(state.pos, state.mass, p, cfg.eps2, "vpu2",
                          overlap=True),
            k13.rdma_ring(state.pos, state.mass, p, cfg.eps2, "vpu2"))
    overlap = time_ms(lambda: k13.rdma_ring(state.pos, state.mass, p,
                                            cfg.eps2, "vpu2", overlap=True),
                      dev, iters=1, warmup=1)
    record["rdma_ring"]["ms_1m"] = statistics.median(rdma)
    record["rdma_ring"]["bound_ms_1m"] = rdma_bound("vpu2", False, n)[0]
    record["rdma_ring"]["schedule_bound_ms_1m"] = rdma_schedule_bound(
        "vpu2", False, p, n // p)[0]
    print(f"[ring 1M] K13 (4-shard --comm rdma) ms/step "
          f"{', '.join(f'{t:.3f}' for t in rdma)}; median "
          f"{statistics.median(rdma):.3f}, against the ppermute ring "
          f"{statistics.median(rdma) / statistics.median(ring):.4f}x and "
          f"K2 {statistics.median(rdma) / statistics.median(single):.4f}x; "
          f"partial launches: phase 0 (self, one-sided) {parts[0]:.3f} ms, "
          f"+ phase 1 (two-sided) {parts[1]:.3f} ms, + phase 2 (antipodal, "
          f"one-sided) and finish {parts[2]:.3f} ms; one rdma_overlap "
          f"evaluation {overlap:.3f} ms; bound "
          f"{record['rdma_ring']['bound_ms_1m']:.3f} ms (the schedule's "
          f"work {record['rdma_ring']['schedule_bound_ms_1m']:.3f} ms) "
          f"({smi})")
    c = n // p
    part_k2 = time_ms(lambda: k2.forces_sym(state.pos[:c], state.mass[:c],
                                            cfg.eps2), dev, iters=2)
    part_k1 = time_ms(lambda: k1.rect_forces_tiled(
        state.pos[:c], state.pos[2 * c:3 * c], state.mass[2 * c:3 * c],
        cfg.eps2), dev, iters=2)
    print(f"[ring 1M] ms/step, rounds of K2, ring, ring, K2: single K2 "
          f"{', '.join(f'{t:.3f}' for t in single)}; 4-shard ring "
          f"{', '.join(f'{t:.3f}' for t in ring)}; median single "
          f"{statistics.median(single):.3f}, ring "
          f"{statistics.median(ring):.3f} "
          f"({statistics.median(ring) / statistics.median(single):.4f}x); "
          f"parts: K2 on a {c}-body shard {part_k2:.3f} ms, K1 on a "
          f"{c} x {c} antipodal sweep {part_k1:.3f} ms ({smi})")


def ring_parts(state, cfg, p, ring_acc, diff_rows, dev):
    """Pin the ring's error on the rows where it differs from K2: the
    ring's four parts for those rows (K2 on the row's own shard, the a
    side of K2-rect with the shard before, the b side of K2-rect with the
    shard after, K1's one-sided antipodal sweep), each against a float64
    direct sum of the same pairs, as a share of the row's |a|.  Added in
    the ring's order the parts must give the ring's rows bit for bit.  K11
    on the same antipodal sweep is measured beside K1."""
    import torch
    from nbody_tpu_torch.ops import forces_tiled as k1
    from nbody_tpu_torch.ops.forces_sym_variants import (forces_pallas_sym,
                                                         rect_forces_sym)
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    if not diff_rows:
        return
    eps2, c = cfg.eps2, state.n // p
    sh = [(state.pos[i * c:(i + 1) * c], state.mass[i * c:(i + 1) * c])
          for i in range(p)]
    names = ("self K2", "rect a side", "rect b side", "antipodal K1",
             "antipodal K11", "ring")
    errs = {k: [] for k in names}
    for s in sorted({r // c for r in diff_rows}):
        local = torch.tensor([r - s * c for r in diff_rows if r // c == s],
                             device=dev)
        (x, m), (xp, mp) = sh[s], sh[(s - 1) % p]
        (xn, mn), (xo, mo) = sh[(s + 1) % p], sh[(s + 2) % p]
        parts = {
            "self K2": forces_pallas_sym(x, m, eps2, variant="vpu2"),
            "rect a side": rect_forces_sym(x, m, xp, mp, eps2,
                                           variant="vpu2")[0],
            "rect b side": rect_forces_sym(xn, mn, x, m, eps2,
                                           variant="vpu2")[1],
            "antipodal K1": k1.rect_forces_tiled(x, xo, mo, eps2),
            "antipodal K11": k1.rect_forces_tiled_kahan(x, xo, mo, eps2)}
        parts = {k: v[local] for k, v in parts.items()}
        parts["ring"] = ring_acc[local + s * c]
        summed = ((parts["self K2"] + parts["rect a side"])
                  + parts["antipodal K1"]) + parts["rect b side"]
        check(torch.equal(summed, parts["ring"]),
              "ring 1M: the parts do not add up to the ring's rows")
        parts = {k: v.double() for k, v in parts.items()}
        xr = x[local].double()
        refs = {k: rect_forces(xr, xj.double(), mj.double(), eps2, chunk=64)
                for k, (xj, mj) in (("self K2", (x, m)),
                                    ("rect a side", (xp, mp)),
                                    ("rect b side", (xn, mn)),
                                    ("antipodal K1", (xo, mo)))}
        refs["antipodal K11"] = refs["antipodal K1"]
        refs["ring"] = sum(refs[k] for k in ("self K2", "rect a side",
                                             "rect b side", "antipodal K1"))
        norm = refs["ring"].norm(dim=1)
        for k in names:
            errs[k] += ((parts[k] - refs[k]).norm(dim=1) / norm).tolist()
    for k in names:
        e = sorted(errs[k])
        gate = RING_PART_GATES[k]
        print(f"[ring 1M parts] {k}: |err| / |a| against float64 on the "
              f"{len(e)} rows where ring and K2 differ: max {e[-1]:.3e}, "
              f"median {e[len(e) // 2]:.3e} (gate {gate:g})")
        check(e[-1] <= gate, f"ring 1M: {k} off by {e[-1]:.3e} of |a|")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    from nbody_tpu_torch.ops import _build

    # 1. Toolchain.
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"torch.version.cuda {torch.version.cuda}")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    print("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    triton = (importlib.metadata.version("triton")
              if importlib.util.find_spec("triton") else "not installed")
    print(f"triton {triton}")
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; nvidia-smi name, power.limit: {smi}")

    # 2. Build every kernel from a clean build directory, in parallel.
    libs = ("forces_tiled", "forces_sym", "resident", "pe",
            "forces_tiled_tc", "forces_sym_tc", "forces_fast", "rdma_ring")
    shutil.rmtree(_build.BUILD_ROOT, ignore_errors=True)
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    _build.build_all(libs)
    print(f"[build] all {len(libs)} libraries: "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        _build.load(lib)
        print(f"[build] {lib}.cu: done at {_build.BUILD_SECONDS[lib]:.2f} s")
        for line in _build.BUILD_LOG[lib].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    # The parent's sources for the redesign rounds, and its SASS against
    # this build's, compiled in the background meanwhile.
    csrc = parent_csrc()
    sass = start_sass_compare(csrc) if csrc else None

    import nbody_tpu_torch as nt
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_tiled as k1
    from nbody_tpu_torch.ops import forces_sym_tc as k56
    from nbody_tpu_torch.ops import forces_tiled_tc as k910
    from nbody_tpu_torch.ops import forces_fast as k12
    from nbody_tpu_torch.ops import pe, resident

    # 3. Every kernel against its plain twin on the card.
    record = {}
    check_forces(dev, 0.002, record)
    check_tc(dev, 0.002, record, smi)
    check_slice4(dev, 0.002, record, smi)
    check_k14(dev, 0.002, record, smi)
    check_rect(dev, 0.002, record, smi)
    check_ablations(dev, 0.002, record, smi)
    check_rdma(dev, 0.002, record, smi)
    check_resident(dev, record)
    check_pe(dev, record, smi)
    for kname, r in record.items():
        print(f"[time] {kname} ({r['shape']}): kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}) ({smi})")

    # 4. K2 at the 1M headline; K8 and K5 against the designs before
    # their redesign.
    check_k2_1m(dev)
    if csrc:
        check_redesign(dev, 0.002, record, smi, csrc)
    else:
        print("[redesign] skipped: no parent sources (PARENT_CSRC)")

    # 5. The main paths, through the CLI, with the launch counters.
    from nbody_tpu_torch.ops import ablation_sym
    from nbody_tpu_torch.parallel import rdma_ring as k13
    wrappers = {"forces_tiled": k1.forces_tiled, "forces_sym": k2.forces_sym,
                "resident": resident.resident_steps,
                "resident_kdk": resident.resident_steps_kdk,
                "pe": pe.pe_rows, "pe_total": pe.pe_total,
                "forces_tiled_turbo": k910.forces_tiled_turbo,
                "forces_tiled_mxu": k910.forces_tiled_mxu,
                "forces_sym_turbo": k56.forces_sym_turbo,
                "forces_sym_mxu": k56.forces_sym_mxu,
                "forces_sym_vpu": k2.forces_sym_vpu,
                "forces_tiled_kahan": k1.forces_tiled_kahan,
                "forces_fast": k12.forces_fast,
                "forces_sym_turbo2": k56.forces_sym_turbo2,
                "forces_sym_turbof": k56.forces_sym_turbof,
                "forces_sym_turbop": k56.forces_sym_turbop,
                "forces_sym_fold": k2.forces_sym_fold,
                "forces_sym_vpu_fold": k2.forces_sym_vpu_fold,
                "rect_forces_sym_vpu2": k2.rect_forces_sym_vpu2,
                "rect_forces_sym_vpu": k2.rect_forces_sym_vpu,
                "rect_forces_sym_fold": k2.rect_forces_sym_fold,
                "rect_forces_sym_vpu_fold": k2.rect_forces_sym_vpu_fold,
                "rect_forces_sym_turbo": k56.rect_forces_sym_turbo,
                "rect_forces_sym_mxu": k56.rect_forces_sym_mxu,
                "rect_forces_sym_turbo2": k56.rect_forces_sym_turbo2,
                "rect_forces_sym_turbof": k56.rect_forces_sym_turbof,
                "rect_forces_sym_turbop": k56.rect_forces_sym_turbop,
                "rdma_ring": k13.rdma_ring,
                **{f"forces_sym_{v}": w
                   for v, w in ablation_sym.SYM_WRAPPERS.items()},
                **{f"rect_forces_sym_{v}": w
                   for v, w in ablation_sym.RECT_WRAPPERS.items()}}

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    launches = main_path(counts, reset)

    # 6. Invariants over 200 device-only steps.
    from nbody_tpu_torch.analysis import invariant_drifts
    cfg = nt.SimConfig(n_bodies=8192, device="cuda")
    out = nt.run_steps(nt.init_state(cfg), cfg, 200)
    host = nt.state_to_numpy(out)
    import numpy as np
    check(np.isfinite(host["pos"]).all(), "non-finite state after 200 steps")
    p_drift, l_drift = invariant_drifts(host["pos"], host["vel"],
                                        host["mass"])
    print(f"[invariants] 200 steps N=8192 ({nt.resolve_impl(cfg)}): "
          f"|P|/scale {p_drift:.3e}, |L|/scale {l_drift:.3e} (gate 1e-3)")
    check(p_drift <= 1e-3 and l_drift <= 1e-3, "invariant gate")

    # 7. Crossovers, and the 4-shard ring step at 1M against K2's.
    crossovers(dev, smi)
    ring_1m(dev, smi, record)

    # 8. Bench lines.
    from nbody_tpu_torch.bench_lib import run_benchmark
    for kw in ({"n": 8192}, {"n": 8192, "resident": False},
               {"n": 8192, "resident": True}, {"n": 8192, "impl": "pallas"},
               {"n": 8192, "impl": "xla"}, {"n": 1 << 20, "energy": True},
               *({"n": 8192, "impl": impl} for impl in TIER_IMPLS.values()),
               {"n": 1 << 20, "impl": "pallas_sym_turbo"},
               # K7 per step (auto would hand pallas_sym to K3 at 8192).
               {"n": 8192, "impl": "pallas_sym", "resident": False},
               {"n": 8192, "impl": "pallas_kahan"},
               {"n": 8192, "impl": "pallas_fast"},
               {"n": 1 << 20, "impl": "pallas_sym_turbo2"},
               # The mesh on this card: the N3L ring, the all-gather.
               {"n": 8192, "impl": "pallas_sym2", "shards": 4},
               {"n": 8192, "impl": "pallas_sym2", "shards": 4,
                "comm": "allgather"},
               {"n": 1 << 20, "impl": "pallas_sym2", "shards": 4},
               # The fused ring K13 on the same meshes.
               {"n": 8192, "shards": 4, "comm": "rdma"},
               {"n": 8192, "shards": 4, "comm": "rdma_overlap"},
               {"n": 1 << 20, "shards": 4, "comm": "rdma"}):
        t0 = time.perf_counter()
        res = run_benchmark(**kw)
        check(res["finite"], f"bench {kw}: non-finite")
        print("[bench] " + json.dumps(res))
        print(f"[time] bench {kw}: {time.perf_counter() - t0:.1f} s")

    if sass:
        finish_sass_compare(sass)
    else:
        print("[sass] skipped: no parent sources (PARENT_CSRC)")

    kernels = []
    for kname, src, repl in (
            ("forces_tiled", "nbody_tpu_torch/csrc/forces_tiled.cu",
             "nbody_tpu/ops/forces_pallas.py:147"),
            ("forces_sym", "nbody_tpu_torch/csrc/forces_sym.cu",
             "nbody_tpu/ops/forces_pallas_sym.py:353"),
            ("resident", "nbody_tpu_torch/csrc/resident.cu",
             "nbody_tpu/ops/resident.py:320"),
            ("resident_kdk", "nbody_tpu_torch/csrc/resident.cu",
             "nbody_tpu/ops/resident.py:362"),
            ("pe", "nbody_tpu_torch/csrc/pe.cu",
             "nbody_tpu/ops/pe_pallas.py:40"),
            ("pe_total", "nbody_tpu_torch/csrc/pe.cu",
             "nbody_tpu/ops/pe_pallas.py:40"),
            ("forces_tiled_turbo", "nbody_tpu_torch/csrc/forces_tiled_tc.cu",
             "nbody_tpu/ops/forces_pallas.py:209"),
            ("forces_tiled_mxu", "nbody_tpu_torch/csrc/forces_tiled_tc.cu",
             "nbody_tpu/ops/forces_pallas.py:258"),
            ("forces_sym_turbo", "nbody_tpu_torch/csrc/forces_sym_tc.cu",
             "nbody_tpu/ops/forces_pallas_sym.py:353"),
            ("forces_sym_mxu", "nbody_tpu_torch/csrc/forces_sym_tc.cu",
             "nbody_tpu/ops/forces_pallas_sym.py:353"),
            ("forces_sym_vpu", "nbody_tpu_torch/csrc/forces_sym.cu",
             "nbody_tpu/ops/forces_pallas_sym.py:353"),
            ("forces_tiled_kahan", "nbody_tpu_torch/csrc/forces_tiled.cu",
             "nbody_tpu/ops/forces_pallas.py:170"),
            ("forces_fast", "nbody_tpu_torch/csrc/forces_fast.cu",
             "nbody_tpu/ops/forces_pallas.py:308"),
            ("forces_sym_turbo2", "nbody_tpu_torch/csrc/forces_sym_tc.cu",
             "nbody_tpu/ops/forces_pallas_sym.py:353"),
            ("forces_sym_turbof", "nbody_tpu_torch/csrc/forces_sym_tc.cu",
             "nbody_tpu/ops/forces_pallas_sym.py:353"),
            ("forces_sym_turbop", "nbody_tpu_torch/csrc/forces_sym_tc.cu",
             "nbody_tpu/ops/forces_pallas_sym.py:453"),
            ("forces_sym_fold", "nbody_tpu_torch/csrc/forces_sym.cu",
             "nbody_tpu/ops/forces_pallas_sym.py:580"),
            ("forces_sym_vpu_fold", "nbody_tpu_torch/csrc/forces_sym.cu",
             "nbody_tpu/ops/forces_pallas_sym.py:580"),
            *((k, "nbody_tpu_torch/csrc/forces_sym.cu",
               "nbody_tpu/ops/forces_pallas_sym.py:"
               + ("636" if k.endswith("fold") else "686"))
              for k in ("rect_forces_sym_vpu2", "rect_forces_sym_vpu",
                        "rect_forces_sym_fold", "rect_forces_sym_vpu_fold")),
            *((f"rect_forces_sym_{v}", "nbody_tpu_torch/csrc/forces_sym_tc.cu",
               "nbody_tpu/ops/forces_pallas_sym.py:"
               + ("518" if v == "turbop" else "686"))
              for v in ("turbo", "mxu", "turbo2", "turbof", "turbop")),
            ("rdma_ring", "nbody_tpu_torch/csrc/rdma_ring.cu",
             "nbody_tpu/parallel/rdma_ring.py:277"),
            # K15: the triangular sweep (_make_tri) and the panel pair
            # (_make_rect) of each ablation.
            *((f"{kind}_{v}", "nbody_tpu_torch/csrc/forces_sym"
               + ("_tc" if v.startswith("tmm_") else "") + ".cu",
               f"nbody_tpu/ops/ablation_sym.py:{line}")
              for kind, line in (("forces_sym", 131),
                                 ("rect_forces_sym", 155))
              for v in ABLATIONS)):
        r = dict(record[kname])
        bound_ms, bound_by = r.pop("bound")
        # No single PyTorch call computes any of these functions.
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[kname],
                        "max_abs_err": r.pop("max_abs_err"),
                        "ms": r.pop("ms"), "plain_ms": r.pop("plain_ms"),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None, **r})
    # The pair-symmetric kernels also replace the exact diagonal pass, and
    # K2-rect the rect call that launches it.
    for k in kernels:
        if k["name"].startswith("forces_sym"):
            k["also_replaces"] = "nbody_tpu/ops/forces_pallas_sym.py:328"
        elif k["name"].startswith("rect_forces_sym"):
            k["also_replaces"] = "nbody_tpu/ops/forces_pallas_sym.py:919"
        elif k["name"] == "rdma_ring":
            k["also_replaces"] = "nbody_tpu/parallel/rdma_ring.py:587"
        elif k["name"] == "pe_total":
            k["also_replaces"] = "nbody_tpu/ops/pe_pallas.py:92"
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
