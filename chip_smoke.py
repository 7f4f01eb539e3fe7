#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nbody_tpu_torch/csrc`` into a clean
build root (``utils/compcache.py``: ``build/nbody_tpu_torch/`` unless
``NBODY_COMPCACHE`` names another; one ``nvcc`` per source, all at once), holds each kernel
against its plain PyTorch version on the card (K1, K2; the resident
kernels K3 and K4 also bit for bit against the per-step K2 path; K8's row
sums also against a float64 direct sum at N = 1,048,576, its symmetric
total against its twin, a float64 total at N = 65,536 and the row sums'
total at 1M; the tensor-core tiers K9,
K10, K5 and K6 also against their tier gates on a float64 direct sum, at
N = 1,048,576 too, and K9's and K10's rect forms at 2048 x 8192 with and
without self_tile; the exact tiers K7 and K11 and the centred tier K12,
on Morton-sorted bodies, at their float64 gates, K7 and K11 on sampled
rows at 1M too; K12 also on unsorted
bodies, with planted close pairs, and on 4096 sorted rows at N = 1M;
K11 also against K1; the K14 variants turbo2 and turbof at turbo's
float64 gate at 8192 and on sampled rows at 1M, turbof with massless
bodies, turbop bit for bit against K5, and the fold schedule at the exact
gate and against classic K2/K7 at 8192 and 1M, and at clusters of 2, 3
and 8 CTAs with real massless bodies; K2-rect, every variant
and both schedules, at the shard shapes 2048 x 2048 and 2144 x 1536, at
its float64 gates and with massless bodies on both sides, and at the 1M
ring's 262,144 x 262,144 shard pair on sampled rows against float64;
K15, the seven bench-only ablations in both sweeps, after
``ablation_sym.enable()``, at N = 8192 and 2048 x 6144, vpu_rc and
tmm_full also at their float64 gates, vpu_rc and tmm_full bit for bit
against K7 / K5 (rect vpu_rc against K2-rect vpu, rect vpu_noj's,
vpu_fix0's and tmm_noj's acc_a against K2-rect vpu's / turbo's), then
timed at N = 1M in interleaved rounds with K7, K5 and turbop, also held at
their control's CTAs per SM (K5's and K7's splits from those rounds), and
checked and timed at the 262,144 x 262,144 shard pair; K13, the fused
ring, every
variant on 1, 2,
3, 4, 5 and 8 shards at N = 8192, both protocols, bit-reproducible and
chunk-invariant, at its tiers' float64 gates and with real massless
bodies), checks K2 at
N = 1,048,576 against the direct-form ``rect_forces``, then drives the
port's main paths through the CLI with the kernels' launch counters reset
just before and read just after: ``validate`` at N = 8192 (exact with K1,
K2, K7 and K11, and each tensor-core tier, ``pallas_sym_turbo2`` among
them), ``validate --shards P`` through the mesh on this card (the N3L
ring with K2-rect on its cross rotations for pallas_sym2, pallas_sym,
pallas_sym_turbo, pallas_sym_mxu and pallas_sym_turbo2; the one-sided
ring with K10's rect form; the all-gather, with K1 and with K9;
the fused ring K13 with ``--comm rdma`` and ``rdma_overlap``, one launch a
force evaluation, also with ``--oracle native`` and through ``run``),
the variant / schedule entry points ``forces_pallas_sym`` and
``rect_forces_sym`` for turbof, turbop and the fold schedule, K8's row
sums ``pe_rows`` (also held to its plain version at that shape) and,
after ``ablation_sym.enable()``, for each K15 ablation, and the
``run`` verb (resident K3 with a
checkpoint, K4 with yoshida4, auto routing, N = 1M with ``--energy``,
N = 1M with ``pallas_sym_turbo`` and with ``pallas_sym_turbo2``, K12 with
``--sort-every`` at N = 8192 and 1M, and a resume that must equal one
uninterrupted run), then the closed-form two-body gates
(``check_kepler``): ``validate --analytic`` through every impl at N = 2
(K1, K11, K12, K9, K10, K2, K7, K5, K6, K14a; 1024 and 2048 steps a
period; float64 through xla_nxn), and the split form, body 1 at index 256
behind 255 massless bodies, through the pair-symmetric impls' pair tiles
and K3 / K4 (bit-equal to per-step K2), each gate's error held to the JAX
package's CPU figures (``JAX_KEPLER``); and the ``--init`` presets at full
width (``check_presets``: plummer-virial at 1M with ``--energy``, the
collision through auto's K3, the disk through K12 with ``--sort-every``,
``validate`` from plummer-virial), each state held to its contract; and
the viz phase (``check_viz``): config #5, ``run --n 65536 --steps 120
--viz --viz-every 1`` (K2 a step), timed in rounds with the same run
headless, its last frame and K3's at 8192 (auto) equal to the host's
render of the checkpointed end state, K3's frames bit-equal to the
per-step chain's, the 4-shard mesh's frames equal to renders of the
gathered state, the AVI sink, ``render`` and ``analyze`` of a 1M
trajectory, the live viewer's frame, camera and stop, and
``interactive`` with kernels 0 (K1) and 1 (K10); and huge N
(``check_huge_n``): ``run --n 4194304 --steps 1`` under auto (K2 in two
bounded programs an evaluation) and a resume of one more step with
``--energy --checkpoint-every 1``, bit-equal to two steps of
``run_steps`` with the bound off, ``run --n 16777216 --steps 1 --flat-state on
--viz`` (24 programs, the heartbeat's lines, 256 sampled rows of the
first evaluation at the exact gate against float64, the frame equal to
the host's render of the checkpointed end state, s/step and peak
memory), and the 4-shard ring at 4M with ``--prog-cap 2e12 --energy``
bit-equal to the same run without them; its two energies take the mesh's
(``parallel/energy.py``: 12 programs of 4 K8 ``pe_rows`` launches, the
heartbeat's lines), held on the card against K8's ``pe_total`` of the
gathered state in alternating rounds, beside one ``pe_rows`` launch at
the 4M shard shape, and at 8192 on 1 to 5 shards against float64
(``check_mesh_energy``); and the examples (``examples/demo_torch.py``,
``examples/orbit_torch.py``) at their defaults (``check_examples``).
K13's two protocols (``check_rdma_protocols``): the flag kernel, as one
launch and as G launches on G streams, bit-equal to the grid-sync kernel
at N = 8192 on 2 to 5 shards, every variant, both protocols, no wait past
its bound, and both at 1M on 4 shards in alternating rounds.  Every mesh
of these phases is pinned to ``cuda:0`` (``on_card0``); on a host of
several cards ``check_cross_card`` spreads meshes over them (at 8192
every (impl, comm) pair the mesh takes, with its float64 gate, kdk and
yoshida4, the bounded mesh on each tier of the ladder and ``run --shards
4`` on a tensor-core tier; at 4M one step of the ring on each tier of the
ladder and of K13; each bit-equal to cuda:0's, with each card's launches,
and at 4M s/step, the efficiency and each card's peak memory; ``python3
chip_smoke.py --cross-card`` runs it alone), and on one card it prints a
skip line.  The sampler (``check_sampler``): 24 seeded draws of the
routes a user reaches (N up to 40,000 with the K1/K2 crossover and the
resident window's edges, every impl, integrator, comm and preset, 1-5
shards, the resident and flat modes, bounded or not, resumed or not),
each route read from the launch counters against the port's predicates,
the first evaluation against float64 rows and, up to N = 8192, against
the same call on the CPU.
Then 200 steps under the momentum and angular-momentum gates
(their change from the initial state), the K1/K2
and resident crossovers that set ``auto``, one 4-shard N3L-ring step and
one 4-shard K13 step at N = 1M against the single-device K2 step (on the
rows where the ring and K2 differ and on sampled rows, each of the ring's
kernels, K11 on its antipodal sweep and K13 against float64; K13's
phases by partial launches), and the bench lines (4M under auto among them).
The JAX rounds' platform probes (``ops/probes.py``, ``csrc/probes.cu``),
run on the main path through both probe scripts (``probe_scripts``): r3's
column sums of a bf16 pack built on the card, the same bits round-tripped
through the host and the pack derived in the kernel with the tiers'
``split_bf16``, bit-equal to each other and to their plain versions; r8's
copies (a device workspace, shared-memory staging, a row slice, a value
row split, an (8, 3) buffer, a transpose, and the remote copy to itself
as K13's peer store and flag at P = 1), each its plain version bit for
bit; ``check_probes`` times them for the kernels line.  The ladder
(``nbody_tpu_torch/bench_suite.py``): rows 1 and 3 as a user runs them,
``python -m nbody_tpu_torch.bench_suite --configs 1,3`` in a process of
its own (``ladder_smoke``).
Any failed check raises and the script exits nonzero; without a CUDA
card it exits 1 before doing anything.

The last three lines of standard output are the kernels' JSON record, the
``nvidia-smi`` name / power-limit line, and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --long-horizon EPS2 [--integrator kdk]

runs config #2's long-horizon gate alone (``long_horizon``): validate's
1000-step phase at N = 8192 on every route (K3 through ``run``, the
per-step kernels, the ring and K13 on 4 shards, ``xla``), one native
float64 oracle run shared by all of them; at eps2 = 1e7 every verdict
gated, at other eps2 the energy where the oracle is well-posed.

    python3 chip_smoke.py --ladder [KEY,KEY,...]

runs the JAX rounds' ladder alone (``check_ladder``; every row by
default, row 5 on every card of the host), each row's kernels read from
the launch counters against its route, row 1's gate, and rows 2 and 7
against the drift of validate's 1000-step phase at the same N, eps2 and
seed (``--long-horizon``'s K3 / per-step K2 numbers, PERF.md section 6).
"""

import contextlib
import functools
import importlib.metadata
import importlib.util
import json
import os
import re
import shutil
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
# REL_TOL, where the parent's K2-rect vpu2 differs from the new one past
# it, and on RING_PART_ROWS sampled rows, each against a float64 sum of
# its pairs, as a share of the row's |a|: K2 and both K2-rect sides at a
# tenth of the exact tolerance; K1's one-sided antipodal sweep,
# tile and slice partials since its redesign, at the parent's worst on
# the rows where its ring differed from K2 (1.193e-3 on an H100, PERF.md:
# one float32 running sum of 262,144 terms a row), and the ring at
# validate's 1%; K11 on the same sweep, where a compensated sum removes
# that error, at the exact tolerance (1.022e-6 at most).
RING_PART_GATES = {"self K2": REL_TOL / 10, "rect a side": REL_TOL / 10,
                   "rect b side": REL_TOL / 10, "antipodal K1": 1.193e-3,
                   "antipodal K11": REL_TOL, "ring": 1e-2}
RING_PART_ROWS = 256
# Rounds of single-device K2, 4-shard ring, ring, K2 at N = 1M.
RING_N = 1 << 20
RING_ROUNDS = 2
# K15, the bench-only ablations: name -> (control, float32 flops a pair,
# tensor-core flops a pair) off the diagonal tiles, where the diagonal
# stays the exact one-sided pass; the controls are ablation_sym.CONTROLS'.
# On K7's pair tile: vpu_noj K7's geometry and the row side only (3 sub, 6
# for d2 + eps2, 2 for the cube, 1 rsqrt, 1 weight, 6 for the row sums:
# 19); vpu_fix0 K7's 26; vpu_rc K7's and 3 subtractions (29).  tmm_full
# and tmm_noscat K5's (14, 32); tmm_noj K5's geometry with one weight and
# one product (13, 16); tmm_nomm K5's geometry and both weights (14) and
# the two row-sum adds, no product (16, 0).
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
# every form once, the order reversed every other round (two: four rounds
# spread under 1% a form on an H100, PERF.md).
ABLATION_N = 8192
ABLATION_RECT = (2048, 6144)
ABLATION_ROUNDS = 2
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
# K14b and K2-rect turbof against their twin: TC_REL_TOL + TC_ABS_FLOOR a
# component, with at most TURBOF_TWIN_MAX_BAD components of an output
# outside it, each held to turbof's own sums in float64 (turbof_twin): the
# kernel at least as close to them as the twin, or within the twin
# tolerance plus TURBOF_CORR_UNITS units of float32 (2^-23) of the
# correction term |x_i sum w| / m_i that the per-tile sums cancel.  As in
# K13, a large weight makes that term ~1e6 where a component is ~1e2, and
# the kernel's tensor-core float32 accumulation and the twin's matmul each
# round it.  tools/turbof_twin_outliers.py --seeds 32 on an H100 80GB HBM3
# at 700 W, the package's kernels: K14b, 4 of 843,084 components outside
# on 35 body sets (N = 8192 on seeds 1-32, 8205 and 41, N = 2500 on
# 2513), at most 1 a set, the kernel the closer every time (seed 6:
# kernel 166.315, twin 166.887, turbof's float64 sums 166.278); K2-rect
# turbof, 5 of 428,832 on 35 pairs of sets (2048 x 2048
# on seeds (s, 32 + s), (2069, 2070) and (41, 42); 2144 x 1536), at most 1
# a side, the kernel off its float64 sums by up to 3.75e-6 of the
# correction term (31 units; the twin up to 2.1e-6).
TURBOF_TWIN_MAX_BAD = 2
TURBOF_CORR_UNITS = 64
# K13's tier gates against float64: the sym variants at their square
# tiers' gates, the one-sided turbo at K9's; the exact ones at the exact
# tolerance.
RDMA_TIERS = {("turbo", False): "forces_sym_turbo",
              ("mxu", False): "forces_sym_mxu",
              ("turbo2", False): "forces_sym_turbo2",
              ("turbo", True): "forces_tiled_turbo"}
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
# The closed-form two-body gates (nbody_tpu_torch/models/kepler.py) on the
# card: ``validate --analytic`` through the CLI for each impl at N = 2
# ("pair") at KEPLER_STEPS steps a period, and the split form ("split":
# body 1 at index 256 behind 255 massless bodies, so that the
# pair-symmetric impls compute the pair on their pair tile) through
# run_steps and the resident entry points.  Each impl's kernel (None: no
# kernel) and the JAX package's impl whose figures it is held to.
KEPLER_STEPS = (1024, 2048)
KEPLER_PAIR_IMPLS = {"auto": "forces_tiled", "pallas": "forces_tiled",
                     "pallas_kahan": "forces_tiled_kahan",
                     "pallas_fast": "forces_fast",
                     "pallas_turbo": "forces_tiled_turbo",
                     "pallas_mxu": "forces_tiled_mxu",
                     "pallas_sym2": "forces_sym",
                     "pallas_sym": "forces_sym_vpu",
                     "pallas_sym_turbo": "forces_sym_turbo",
                     "pallas_sym_mxu": "forces_sym_mxu",
                     "pallas_sym_turbo2": "forces_sym_turbo2"}
KEPLER_SPLIT_IMPLS = ("pallas_sym2", "pallas_sym", "pallas_sym_turbo",
                      "pallas_sym_mxu", "pallas_sym_turbo2")
# auto runs K1 at N = 2 on the card (below SYM_CROSSOVER_N).
KEPLER_JAX_IMPL = {"auto": "pallas"}
KEPLER_SPLIT_AT = 256
# The JAX package's gate errors, float32 on the CPU with the Pallas impls
# in interpret mode, as ``PYTHONPATH=. python tests/kepler_jax_figures.py``
# prints them (the JAX package at commit
# 22cd32cd22cab26631757ca4be0b1b16d38eccaa): for
# each (placement, impl, S) the five gates in run_analytic_gates' order,
# each at S + k steps a period for k in KEPLER_OFFSETS (float64: S only).
# A gate's float32 error is often rounding noise: where the JAX figures
# over those five step counts differ by more than 2x, the card's error is
# held to at most twice the larger of their largest and the gates' float32
# noise term (KEPLER_NOISE), elsewhere to within a factor of 2 of the
# figures both ways; where the figure at S is more than 25% from its
# tolerance, the card's verdict must be the JAX package's.
# JAX_KEPLER_SAME: cells whose figures equal another's.
KEPLER_OFFSETS = (-16, -8, 0, 8, 16)
KEPLER_NOISE = {"float32": 5e-5, "float64": 1e-12}
JAX_KEPLER = {
    ('pair', 'pallas', 1024): (
        (0.000209443, 0.000206923, 0.000212371, 0.000206357, 0.000207095),
        (5.70264e-05, 3.43572e-05, 5.04971e-05, 5.15523e-05, 5.31694e-05),
        (1.05654e-05, 1.199e-05, 4.49269e-06, 4.82009e-06, 2.12651e-05),
        (0.00355337, 0.00345814, 0.00347729, 0.0034218, 0.00333698),
        (1.55586e-05, 6.23152e-05, 4.51756e-06, 6.04019e-05, 6.16004e-05),
    ),
    ('pair', 'pallas', 2048): (
        (9.46332e-05, 9.49779e-05, 9.61638e-05, 9.82235e-05, 9.52911e-05),
        (5.3099e-06, 4.15771e-06, 6.08275e-06, 4.22062e-05, 1.18371e-05),
        (1.41941e-05, 2.37754e-06, 1.82409e-05, 8.95076e-06, 2.49827e-06),
        (0.000879467, 0.000898789, 0.000839242, 0.000842908, 0.000857099),
        (0.000130794, 4.06996e-05, 7.42639e-05, 5.85329e-05, 3.75893e-05),
    ),
    ('pair', 'pallas_fast', 1024): (
        (0.000211114, 0.000208926, 0.000214948, 0.000207354, 0.000207389),
        (6.7618e-05, 3.55199e-05, 5.30441e-05, 5.21714e-05, 5.05332e-05),
        (5.32421e-06, 2.68598e-05, 6.9787e-06, 1.58148e-05, 6.37006e-06),
        (0.00354655, 0.00346264, 0.00350175, 0.00341968, 0.00333159),
        (1.16861e-05, 8.12236e-05, 3.40376e-06, 5.87668e-05, 8.02974e-06),
    ),
    ('pair', 'pallas_fast', 2048): (
        (9.41022e-05, 9.47501e-05, 9.68354e-05, 9.55715e-05, 9.48674e-05),
        (3.86243e-06, 6.20875e-06, 1.5407e-06, 3.9487e-05, 1.48713e-05),
        (1.84675e-05, 5.25784e-06, 1.83156e-05, 1.05887e-05, 1.37506e-06),
        (0.000892783, 0.000916197, 0.000857417, 0.000841393, 0.000864089),
        (0.000140377, 3.02799e-05, 8.70632e-05, 7.60875e-05, 4.64901e-05),
    ),
    ('pair', 'pallas_mxu', 1024): (
        (0.00021105, 0.000208929, 0.000214442, 0.000207586, 0.00020785),
        (5.85846e-05, 3.49607e-05, 5.32133e-05, 5.29277e-05, 4.87779e-05),
        (1.00238e-05, 2.83813e-05, 2.31618e-05, 1.93595e-05, 2.09495e-05),
        (0.00354079, 0.0034624, 0.00350419, 0.00342533, 0.0033308),
        (5.85956e-05, 7.57751e-05, 3.1565e-05, 5.43499e-05, 3.0444e-05),
    ),
    ('pair', 'pallas_mxu', 2048): (
        (9.42385e-05, 9.37151e-05, 9.70552e-05, 9.43993e-05, 9.4714e-05),
        (8.4528e-06, 7.1435e-06, 3.13301e-06, 4.05029e-05, 1.30894e-05),
        (5.58486e-06, 1.92672e-05, 1.89008e-05, 2.21019e-05, 1.64593e-06),
        (0.000896389, 0.000916903, 0.000852374, 0.000864268, 0.000861244),
        (0.000136697, 1.21463e-05, 7.76027e-05, 8.39648e-05, 3.08301e-05),
    ),
    ('pair', 'pallas_turbo', 1024): (
        (0.00144426, 0.00145817, 0.00148027, 0.0014801, 0.00149195),
        (0.00171727, 0.0017173, 0.00171626, 0.00171767, 0.00171766),
        (0.00172131, 0.00172343, 0.00172354, 0.00172303, 0.00172503),
        (0.00518774, 0.013194, 0.0109151, 0.00746667, 0.00925895),
        (0.00445329, 0.0046026, 0.00606917, 0.00941141, 0.00499407),
    ),
    ('pair', 'pallas_turbo', 2048): (
        (0.00184915, 0.00183678, 0.00186379, 0.00187144, 0.00187415),
        (0.0017222, 0.00172257, 0.00172228, 0.00172023, 0.00172211),
        (0.00172126, 0.00172541, 0.00172585, 0.00172162, 0.00172395),
        (0.00614132, 0.000822424, 0.0046175, 0.00370638, 0.00169564),
        (0.00811291, 8.27995e-05, 0.00304367, 0.00397174, 0.00138862),
    ),
    ('pair', 'xla_nxn/float64', 1024): (
        (0.000206499,),
        (4.91825e-05,),
        (5.18621e-09,),
        (0.00343017,),
        (1.76606e-06,),
    ),
    ('pair', 'xla_nxn/float64', 2048): (
        (9.49208e-05,),
        (1.22957e-05,),
        (3.24104e-10,),
        (0.000857179,),
        (9.14692e-08,),
    ),
}
JAX_KEPLER_SAME = {
    ('pair', 'pallas_kahan', 1024): ('pair', 'pallas', 1024),
    ('pair', 'pallas_kahan', 2048): ('pair', 'pallas', 2048),
    ('pair', 'pallas_sym', 1024): ('pair', 'pallas', 1024),
    ('pair', 'pallas_sym', 2048): ('pair', 'pallas', 2048),
    ('pair', 'pallas_sym2', 1024): ('pair', 'pallas', 1024),
    ('pair', 'pallas_sym2', 2048): ('pair', 'pallas', 2048),
    ('pair', 'pallas_sym_mxu', 1024): ('pair', 'pallas', 1024),
    ('pair', 'pallas_sym_mxu', 2048): ('pair', 'pallas', 2048),
    ('pair', 'pallas_sym_turbo', 1024): ('pair', 'pallas', 1024),
    ('pair', 'pallas_sym_turbo', 2048): ('pair', 'pallas', 2048),
    ('pair', 'pallas_sym_turbo2', 1024): ('pair', 'pallas', 1024),
    ('pair', 'pallas_sym_turbo2', 2048): ('pair', 'pallas', 2048),
    ('split', 'pallas_sym', 1024): ('pair', 'pallas', 1024),
    ('split', 'pallas_sym', 2048): ('pair', 'pallas', 2048),
    ('split', 'pallas_sym2', 1024): ('pair', 'pallas', 1024),
    ('split', 'pallas_sym2', 2048): ('pair', 'pallas', 2048),
    ('split', 'pallas_sym_mxu', 1024): ('pair', 'pallas_mxu', 1024),
    ('split', 'pallas_sym_mxu', 2048): ('pair', 'pallas_mxu', 2048),
    ('split', 'pallas_sym_turbo', 1024): ('pair', 'pallas_turbo', 1024),
    ('split', 'pallas_sym_turbo', 2048): ('pair', 'pallas_turbo', 2048),
    ('split', 'pallas_sym_turbo2', 1024): ('pair', 'pallas_turbo', 1024),
    ('split', 'pallas_sym_turbo2', 2048): ('pair', 'pallas_turbo', 2048),
}


def on_card0(argv):
    """``argv`` of a CLI call with its mesh pinned to card 0 (``--device
    cuda:0`` added where it has ``--shards`` and no ``--device``): the
    one-card phases measure the same schedule on a host of several cards.
    check_cross_card spreads its meshes over the cards on purpose."""
    argv = list(argv)
    if "--shards" in argv and "--device" not in argv:
        argv += ["--device", "cuda:0"]
    return argv


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
    against a float64 direct sum (also on 4096 sampled rows at N = 1M, K6
    bit-reproducible there), K9's and K10's rect forms at 2048 x 8192 with
    and without self_tile, and their times at 8192 and 1M."""
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

    # K9's and K10's rect forms at a shard shape, 2048 rows against 8192
    # bodies: the rows a prefix of the bodies (self_tile, the self-pairs
    # masked) or a set of their own (nothing masked); against the twin,
    # bit-reproducible, and at the tier gate against float64.
    pos, mass = bodies(8192, 8192 + 5, dev)
    for self_tile, pi in ((True, pos[:2048].contiguous()),
                          (False, bodies(2048, 2048 + 5, dev)[0])):
        ref = rect_forces(pi.double(), pos.double(), mass.double(), eps2)
        for variant in ("turbo", "mxu"):
            what = (f"forces_tiled_{variant} rect 2048x8192, "
                    f"self_tile={self_tile}")
            got = forces_tiled_tc.rect_forces_tiled_tc(pi, pos, mass, eps2,
                                                       variant, self_tile)
            compare(f"{what} vs plain", got,
                    forces_tiled_tc.rect_forces_tiled_tc_plain(
                        pi, pos, mass, eps2, variant, self_tile),
                    rel_tol=TC_REL_TOL, abs_floor=TC_ABS_FLOOR)
            check(torch.equal(got, forces_tiled_tc.rect_forces_tiled_tc(
                pi, pos, mass, eps2, variant, self_tile)),
                f"{what}: not bit-reproducible")
            tier_gate(f"forces_tiled_{variant}", got, ref)

    # K5 at the bench rider's shape: 4096 sampled rows of one evaluation
    # against a float64 direct sum on the card, rows in chunks of 64; K6,
    # K9 and K10 on the same rows.
    n = 1 << 20
    pos, mass = bodies(n, 2, dev)
    acc = forces_sym_tc.forces_sym_turbo(pos, mass, eps2)
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(2))[
        :4096].to(dev)
    ref = rect_forces(pos[rows].double(), pos.double(), mass.double(), eps2,
                      chunk=64)
    tier_gate("forces_sym_turbo", acc[rows], ref)
    acc = forces_sym_tc.forces_sym_mxu(pos, mass, eps2)
    check(torch.equal(acc, forces_sym_tc.forces_sym_mxu(pos, mass, eps2)),
          "forces_sym_mxu N=1M: not bit-reproducible")
    tier_gate("forces_sym_mxu", acc[rows], ref)
    for kname in ("forces_tiled_turbo", "forces_tiled_mxu"):
        acc = tiers[kname][0](pos, mass, eps2)
        tier_gate(kname, acc[rows], ref)
    del acc
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
    evaluation each at N = 1M for the times, where K7 and K11 are also
    bit-reproducible and held to their gates on 2048 sampled rows (K11
    also to K1's summed error), and K12's first 4096 sorted rows to the
    twin and the gate."""
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
    # K7 and K11 at 1M: bit-reproducible, at their float64 gates on 2048
    # sampled rows, and K11 not K1 there with no larger summed error.
    sample = torch.randperm(n, generator=torch.Generator().manual_seed(13))[
        :2048].sort()[0].to(dev)
    ref = rect_forces(pos[sample].double(), pos.double(), mass.double(),
                      eps2, chunk=64)
    for kname in ("forces_sym_vpu", "forces_tiled_kahan"):
        kernel = kernels[kname][0]
        got = kernel(pos, mass, eps2)
        check(torch.equal(got, kernel(pos, mass, eps2)),
              f"{kname} N=1M: not bit-reproducible")
        tier_gate(kname, got[sample], ref)
        if kname == "forces_tiled_kahan":
            plain_sum = k1.forces_tiled(pos, mass, eps2)[sample]
            check(not torch.equal(got[sample], plain_sum),
                  "K11 N=1M equals K1: the compensation folded away")
            err_k = float((got[sample].double() - ref).abs().sum())
            err_1 = float((plain_sum.double() - ref).abs().sum())
            print(f"[check] forces_tiled_kahan, N=1M, 2048 sampled rows: "
                  f"summed |error| against float64 {err_k:.6e}, K1's "
                  f"{err_1:.6e}")
            check(err_k <= err_1, "K11 N=1M less accurate than K1")
        del got
    del ref
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
            name = f"{kname} vs plain, N={n}"
            err = (turbof_twin(name, got, plain(pos, mass), pos, mass, pos,
                               mass, eps2, True)
                   if kname == "forces_sym_turbof" else
                   compare(name, got, plain(pos, mass), **tol))
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
            sets = ((pa, ma, pb, mb), (pb, mb, pa, ma))
            err = max((turbof_twin(f"{kname} acc_{side} vs plain, "
                                   f"{na}x{nb}", g, w, *ab, eps2, False)
                       if variant == "turbof" else
                       compare(f"{kname} acc_{side} vs plain, {na}x{nb}", g,
                               w, **tol))[0]
                      for side, g, w, ab in zip("ab", got, want, sets))
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
    # slot chunks: every variant bit-reproducible, its acc_a and acc_b on
    # RECT_1M_ROWS sampled rows of each side against a float64 direct sum
    # of the cross pairs (the exact variants at the exact tolerance, the
    # tensor-core ones at their tiers' gates; turbop bit-equal to turbo),
    # then its time.
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
        check(all(torch.equal(x, y) for x, y in zip(
            got, run(kname, pa, ma, pb, mb))),
            f"{kname} {n}x{n}: not bit-reproducible")
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
    ``rect_forces_sym`` with an ablation variant): each of the seven
    forms of both sweeps against its plain twin (triangular at N = 8192
    seed 0, rect at 2048 x 6144), bit-reproducible and the same with one
    offset / column superblock a slot chunk, and (triangular) the same at
    the control's CTAs per SM; vpu_rc and tmm_full also against a float64
    direct sum at the exact and the turbo gate, vpu_rc bit-equal to K7 and
    tmm_full to K5, rect vpu_rc bit-equal to K2-rect vpu on both sides and
    the acc_a of rect vpu_noj, vpu_fix0 and tmm_noj bit-equal to K2-rect
    vpu's, vpu's and turbo's (here and at 262,144 x 262,144); the none
    forms give B nothing.  Then the sweep at N = 1M (K7 and the vpu_*
    forms, K5, turbop and the tmm_* forms, and each ablation at its
    control's CTAs per SM) in ABLATION_ROUNDS interleaved rounds, the
    outputs of vpu_rc and tmm_full bit-equal to K7 and K5 and each pinned
    form's to its own, and K5's and K7's splits from those rounds
    (k5_split, k7_split); and each rect form at the 1M ring's 262,144 x
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
    check(all(ABLATIONS[v][0] == f"forces_sym_{c}"
              for v, c in ab.CONTROLS.items()),
          "chip_smoke.ABLATIONS names other controls than "
          "ablation_sym.CONTROLS")

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

    # The exact-physics forms: float64 gates, and against the controls.
    ref = rect_forces(pos.double(), pos.double(), mass.double(), eps2)
    rc = forces_pallas_sym(pos, mass, eps2, variant="vpu_rc")
    full = forces_pallas_sym(pos, mass, eps2, variant="tmm_full")
    k7 = k2.forces_sym_vpu(pos, mass, eps2)
    tier_gate("forces_sym_vpu", rc, ref)
    tier_gate("forces_sym_turbo", full, ref)
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
    # tmm_noj's row sums are K5's tile's and vpu_noj's and vpu_fix0's K7's,
    # and every reduce pass adds A's row slots in column order: their acc_a
    # is K2-rect turbo's and vpu's bit for bit; vpu_rc's sums are K7's.
    k7r = k2.rect_forces_sym_vpu(pa, ma, pb, mb, eps2)
    check(torch.equal(rect_forces_sym(pa, ma, pb, mb, eps2,
                                      variant="vpu_noj")[0], k7r[0]),
          f"rect vpu_noj {na}x{nb}: acc_a differs from K2-rect vpu's")
    check(torch.equal(rect_forces_sym(pa, ma, pb, mb, eps2,
                                      variant="tmm_noj")[0],
                      ktc.rect_forces_sym_turbo(pa, ma, pb, mb, eps2)[0]),
          f"rect tmm_noj {na}x{nb}: acc_a differs from K2-rect turbo's")
    check(torch.equal(rect_forces_sym(pa, ma, pb, mb, eps2,
                                      variant="vpu_fix0")[0], k7r[0]),
          f"rect vpu_fix0 {na}x{nb}: acc_a differs from K2-rect vpu's")
    check(all(torch.equal(x, y) for x, y in zip(
        rect_forces_sym(pa, ma, pb, mb, eps2, variant="vpu_rc"), k7r)),
          f"rect vpu_rc {na}x{nb}: differs from K2-rect vpu")
    print(f"[check] {na}x{nb}: rect_forces_sym_tmm_noj's acc_a bit-equal "
          f"to K2-rect turbo's, rect_forces_sym_vpu_noj's and vpu_fix0's to "
          f"K2-rect vpu's, rect_forces_sym_vpu_rc to K2-rect vpu on both "
          f"sides")
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
        name = kname[len("forces_sym_"):]
        # Each form against its control (K7 and K5 against themselves,
        # turbop against K5).
        control = (ABLATIONS[name.removesuffix(" pinned")][0]
                   if name.removesuffix(" pinned") in ABLATIONS else
                   "forces_sym_vpu" if name == "vpu" else "forces_sym_turbo")
        ratios = [c / x for c, x in zip(times[control], ts)]
        med = statistics.median(ts)
        if name in ABLATIONS:
            record[kname]["ms_1m"] = med
            record[kname]["bound_ms_1m"] = ablation_bound(name, n)[0]
        print(f"[1M ablation] {kname}: median {med:.3f} ms per evaluation "
              f"(rounds {', '.join(f'{x:.3f}' for x in ts)}); "
              f"{control} / {kname} median {statistics.median(ratios):.4f} "
              f"(rounds {', '.join(f'{x:.4f}' for x in ratios)}) ({smi})")
    med = {k: statistics.median(ts) for k, ts in times.items()}
    k5_split(med, n, record, smi)
    k7_split(med, n, record, smi)
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
            control = ab.CONTROLS[variant]
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
    check(torch.equal(outs["tmm_noj"][0], outs["turbo"][0]),
          f"rect tmm_noj {n}x{n}: acc_a differs from K2-rect turbo's")
    for v in ("vpu_noj", "vpu_fix0"):
        check(torch.equal(outs[v][0], outs["vpu"][0]),
              f"rect {v} {n}x{n}: acc_a differs from K2-rect vpu's")
    check(all(torch.equal(x, y) for x, y in zip(outs["vpu_rc"], outs["vpu"])),
          f"rect vpu_rc {n}x{n}: differs from K2-rect vpu")
    print(f"[check] {n}x{n}: rect_forces_sym_tmm_noj's acc_a bit-equal to "
          f"K2-rect turbo's and rect_forces_sym_vpu_noj's and vpu_fix0's to "
          f"K2-rect vpu's, rect_forces_sym_vpu_rc to K2-rect vpu on both "
          f"sides, every row")
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


def turbof_rows_float64(xi, mi, pos, mass, eps2, rows=None, inv_fn=None):
    """turbof's own sums for the rows (xi, mi) against the bodies (pos,
    mass), exact after its bf16 rounding: each pair's weight bf16((m_i m_j)
    inv) on the trimmed geometry (pair_inv_fma; ``inv_fn`` another), as the
    kernels and their twin form it, on the position pack, the products,
    the per-tile correction and the descale by 1/m_i in float64.  For the
    square form (``rows``: the rows' indices among the bodies) each row's
    own 256-body tile is a float64 direct sum, as the diagonal kernel takes
    that tile exactly.  Returns the sums and the correction term
    |x_i sum w| / m_i they cancel."""
    import torch
    from nbody_tpu_torch.ops.forces_sym import SYM_TILE
    from nbody_tpu_torch.ops.forces_tiled_tc import (pair_inv_fma,
                                                     position_pack)
    w = ((mi[:, None] * mass[None, :]) * (inv_fn or pair_inv_fma)(
        xi, pos, eps2)).to(torch.bfloat16).double()
    acc = 0.0
    if rows is not None:
        tile = torch.as_tensor(rows, device=pos.device)[:, None] // SYM_TILE
        own = torch.arange(pos.shape[0], device=pos.device) // SYM_TILE == tile
        w[own] = 0.0
        d = pos.double()[None] - xi.double()[:, None]
        d2 = (d * d).sum(-1) + eps2
        acc = ((own * mass.double() / d2 ** 1.5)[..., None] * d).sum(1)
    out = w @ position_pack(pos).double()
    s = out[:, 0::2] + out[:, 1::2]
    corr = xi.double() * s[:, 3:4]
    m = mi.double()[:, None]
    return acc + (s[:, :3] - corr) / m, corr.abs() / m


def twin_outliers(name, got, want, rows, own, pi, pj, mj, eps2,
                  corr_units=0):
    """The components of ``rows`` where a tensor-core output ``got`` and
    its twin ``want`` differ past the twin tolerance, each beside the
    variant's own sums in float64 (``own(rows)``: tc_rows_float64's or
    turbof_rows_float64's sums and correction term), of which both are
    float32 roundings, and beside a float64 direct sum of the rows ``pi``
    against the bodies (pj, mj): the kernel must be at least as close to
    the variant's float64 sums as the twin, or within the twin tolerance of
    them, widened by ``corr_units`` units of float32 of the correction
    term."""
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    if not rows:
        return
    v, corr = own(rows)
    f = rect_forces(pi[rows].double(), pj.double(), mj.double(), eps2)
    g, w = got[rows].double(), want[rows].double()
    floor = TC_ABS_FLOOR * float(want.abs().max())
    out = (g - w).abs() > TC_REL_TOL * w.abs() + floor
    for r, k in out.nonzero().tolist():
        ek, et = float(abs(g[r, k] - v[r, k])), float(abs(w[r, k] - v[r, k]))
        tol = (TC_REL_TOL * abs(float(v[r, k])) + floor
               + corr_units * 2.0 ** -23 * float(corr[r, k]))
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


def turbof_twin(name, got, want, pi, mi, pj, mj, eps2, square):
    """K14b's (``square``) or K2-rect turbof's output ``got`` for the rows
    (pi, mi) against the bodies (pj, mj), held to its twin ``want``:
    TC_REL_TOL + TC_ABS_FLOOR a component, at most TURBOF_TWIN_MAX_BAD of
    them outside it, each of those no further from turbof's own float64
    sums than the twin is, or within the twin tolerance and
    TURBOF_CORR_UNITS of them (twin_outliers).  Returns compare's
    result."""
    out = compare(name, got, want, rel_tol=TC_REL_TOL,
                  abs_floor=TC_ABS_FLOOR, max_bad=TURBOF_TWIN_MAX_BAD)
    twin_outliers(name, got, want, out[2],
                  lambda r: turbof_rows_float64(pi[r], mi[r], pj, mj, eps2,
                                                r if square else None),
                  pi, pj, mj, eps2, TURBOF_CORR_UNITS)
    return out


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
                    twin_outliers(f"{what} {proto}", got, want, bad,
                                  lambda r: tc_rows_float64(
                                      variant, pos, mass, r, eps2),
                                  pos, pos, mass, eps2)
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

    # Real massless bodies under vpu2, sequential and overlap; the flag
    # protocol (one launch, and two launches on two streams) bit-equal.
    p = 4
    pos, mass = rdma_shards(RDMA_N, p, 70, dev)
    zero = [3, 2048, 5000, 8191]
    mass[zero] = 0.0
    ref = rect_forces(pos[zero].double(), pos.double(), mass.double(), eps2)
    for overlap in (False, True):
        got = k13.rdma_ring(pos, mass, p, eps2, "vpu2", overlap=overlap)
        compare(f"K13 vpu2 P=4 {'overlap' if overlap else 'sequential'}, "
                f"massless rows vs float64", got[zero], ref)
        for proto, streams in (("flags", 1), ("flags", 2), ("grid", 1)):
            check(torch.equal(got, k13._launch(
                pos, mass, p, eps2, "vpu2", False, overlap,
                k13.SLOT_BUDGET_BYTES, protocol=proto, streams=streams)),
                f"K13 massless rows: the {proto} protocol ({streams} "
                f"launches) differs")
        print(f"[check] K13 massless rows {zero}: |a| "
              f"{[f'{v:.4e}' for v in got[zero].norm(dim=1).tolist()]}; "
              f"JAX's K13 gives 0 there (_inv_mass_scale); both protocols "
              f"and the two-launch form bit-equal")
    k13.check_errors()
    check_rdma_protocols(dev, eps2, record, smi)
    print(f"[time] K13 checks: {time.perf_counter() - t0:.1f} s")


def check_rdma_protocols(dev, eps2, record, smi):
    """K13's two protocols on one card: the flag-ordered kernel (one
    launch whose P groups order themselves by the flags) and its test form
    of G launches on G streams (the launches of G cards with only the peer
    mapping left out) bit for bit against the grid-sync kernel at N = 8192
    (seed 5) on 2 to 5 shards, every variant of the sym ladder and the
    one-sided family, sequential and overlap, no wait past its bound; then
    both protocols at N = 1M on 4 shards (vpu2, sequential) in alternating
    rounds, and the two-launch form beside them."""
    import torch
    from nbody_tpu_torch.parallel import rdma_ring as k13
    t0 = time.perf_counter()
    budget = k13.SLOT_BUDGET_BYTES
    for p in (2, 3, 4, 5):
        pos, mass = rdma_shards(RDMA_N, p, 5, dev)
        for variant, one_sided in RDMA_CASES:
            for overlap in (False, True):
                want = k13._launch(pos, mass, p, eps2, variant, one_sided,
                                   overlap, budget, protocol="grid")
                for streams in sorted({1, 2, p}):
                    got = k13._launch(pos, mass, p, eps2, variant, one_sided,
                                      overlap, budget, protocol="flags",
                                      streams=streams)
                    check(torch.equal(got, want),
                          f"K13 {variant}{' one-sided' if one_sided else ''}"
                          f" P={p} {'overlap' if overlap else 'sequential'}: "
                          f"the flag protocol in {streams} launch(es) differs "
                          f"from the grid-sync kernel")
        k13.check_errors()
    print(f"[check] K13's flag protocol (1, 2 and P launches) bit-equal to "
          f"the grid-sync kernel at N={RDMA_N}, seed 5, P = 2 to 5, every "
          f"variant, both protocols; no wait ran past its bound")
    p = 4
    pos, mass = rdma_shards(RING_N, p, 5, dev)
    forms = {"grid": {"protocol": "grid"}, "flags": {"protocol": "flags"},
             "flags, 2 launches": {"protocol": "flags", "streams": 2}}
    fns = {k: (lambda kw=kw: k13._launch(pos, mass, p, eps2, "vpu2", False,
                                         False, budget, **kw))
           for k, kw in forms.items()}
    outs = {k: fn() for k, fn in fns.items()}
    check(all(torch.equal(o, outs["grid"]) for o in outs.values()),
          "K13 at 1M: the protocols differ")
    order = ["grid", "flags", "flags, 2 launches"]
    turns = {k: [] for k in order}
    for r in range(4):
        for k in (order if r % 2 == 0 else order[::-1]):
            turns[k].append(device_ms(fns[k], 1))
    k13.check_errors()
    med = {k: statistics.median(v) for k, v in turns.items()}
    for k, v in turns.items():
        print(f"[time] K13 vpu2 P=4 N={RING_N}, {k}: rounds "
              f"{', '.join(f'{t:.3f}' for t in v)} ms, median {med[k]:.3f} "
              f"({smi})")
    print(f"[time] K13 at 1M: the flag protocol {med['flags'] / med['grid']:.4f}"
          f"x the grid-sync kernel's time (one launch), "
          f"{med['flags, 2 launches'] / med['grid']:.4f}x in two launches; "
          f"checks and rounds {time.perf_counter() - t0:.1f} s")
    record["rdma_ring"].update({
        "ms_1m_grid": med["grid"], "ms_1m_flags": med["flags"],
        "ms_1m_flags_2_launches": med["flags, 2 launches"]})


def check_resident(dev, record):
    """K3 and K4 against their plain twins and, bit for bit, against the
    per-step K2 path; chunk invariance; real zero-mass bodies."""
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.ops import resident
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.utils.timing import time_ms
    print(f"[resident] co-resident grid: K3 {resident.max_blocks(False)} "
          f"blocks, K4 {resident.max_blocks(True)} blocks of 256 threads")
    for kdk in (False, True):
        for nb in (1, 3, 10, 32, 48, 128):
            check(resident.launch_grid(nb, kdk) == resident.resident_grid(
                nb, resident.max_blocks(kdk)),
                  f"resident grid for nb={nb}: the kernel's launch and "
                  f"ops/resident.py's mirror differ")
    for nb in (1, 3, 33, 34, 48, 64, 128, 264, 265, 270, 836):
        for grid in (1, 132, 264, 528):
            check(resident.kernel_group_warps(nb, grid)
                  == resident.group_warps(nb, grid),
                  f"resident group warps for nb={nb}, grid={grid}: the "
                  f"kernel's and ops/resident.py's mirror differ")
    # (integrator, N, steps, first chunk of the chained run).  From
    # N = 8449 (nb = 34) on, 8 nb finish groups outrun one warp a block of
    # the 264-block grid (12288 and 16384, inside auto's window, take two
    # warps a block); at N = 69000 (nb = 270) every warp of a block takes
    # groups and some take two a step.
    cases = [("reference", 700, 7, 2), ("reference", 1000, 10, 4),
             ("reference", 2500, 6, 2), ("reference", 8192, 10, 4),
             ("kdk", 8192, 5, 1), ("yoshida4", 8192, 5, 1),
             ("yoshida4", 700, 2, 0), ("reference", 12288, 5, 2),
             ("reference", 16384, 5, 2), ("yoshida4", 16384, 5, 2),
             ("reference", 69000, 5, 2), ("yoshida4", 69000, 2, 1)]
    errs = {"resident": 0.0, "resident_kdk": 0.0}
    for integrator, n, steps, split in cases:
        cfg = nt.SimConfig(n_bodies=n, impl="pallas_sym2",
                           integrator=integrator, seed=n + 11)
        state = nt.init_state(cfg)
        if integrator != "reference":
            state = nt.ops.step.prime_kdk(state, cfg)
        kname = "resident" if integrator == "reference" else "resident_kdk"
        what = f"{'K3' if kname == 'resident' else 'K4'} {integrator} N={n}"
        # Against the plain twin up to 16384; past it bit for bit only.
        twin = n <= 16384
        if twin:
            one = resident.run_steps_resident(state, cfg, 1)
            plain = resident.run_steps_resident_plain(state, cfg, 1)
            for k in ("pos", "vel", "acc"):
                err = compare(f"{what}, 1 step, {k} vs plain",
                              getattr(one, k), getattr(plain, k))
                if n == 8192:
                    errs[kname] = max(errs[kname], err[0])
        got = resident.run_steps_resident(state, cfg, steps)
        per_step = nt.run_steps(state, cfg, steps, impl="pallas_sym2")
        check(states_equal(got, per_step),
              f"{what}: {steps} resident steps differ from {steps} "
              f"per-step K2 steps")
        chained = resident.run_steps_resident(
            resident.run_steps_resident(state, cfg, split), cfg,
            steps - split)
        check(states_equal(got, chained),
              f"{what}: {split}+{steps - split} steps differ from {steps}")
        drift = ""
        if twin:
            plain = resident.run_steps_resident_plain(state, cfg, steps)
            rel = float((got.pos - plain.pos).abs().max()
                        / plain.pos.abs().max())
            drift = f"; pos vs plain after {steps} steps max rel {rel:.3e}"
        nb = -(-n // 256)
        grid = resident.launch_grid(nb, kname == "resident_kdk")
        print(f"[check] {what} (grid {grid}, "
              f"{resident.group_warps(nb, grid)} finish warps a block): "
              f"{steps} steps bit-equal to {steps} per-step K2 steps and to "
              f"{split}+{steps - split}{drift}")
    cfg = nt.SimConfig(n_bodies=1000, impl="pallas_sym2", seed=7)
    state = nt.init_state(cfg)
    mass = state.mass.clone()
    mass[[3, 400, 999]] = 0.0
    state = state._replace(mass=mass)
    compare("K3 with three real zero-mass bodies vs direct form",
            resident.run_steps_resident(state, cfg, 1).acc,
            rect_forces(state.pos, state.pos, mass, cfg.eps2))
    # A zero-mass body's diagonal item reads every body: several steps of
    # it against the per-step path, both kernels.
    for integrator in ("reference", "yoshida4"):
        cfg = nt.SimConfig(n_bodies=1000, impl="pallas_sym2",
                           integrator=integrator, seed=7)
        st = state
        if integrator != "reference":
            st = nt.ops.step.prime_kdk(state, cfg)
        check(states_equal(resident.run_steps_resident(st, cfg, 6),
                           nt.run_steps(st, cfg, 6, impl="pallas_sym2")),
              f"{integrator} with zero-mass bodies: 6 resident steps differ "
              f"from 6 per-step K2 steps")
    print("[check] K3 / K4 with three real zero-mass bodies: 6 steps "
          "bit-equal to the per-step K2 path")

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


# The JAX rounds' platform probes (ops/probes.py, csrc/probes.cu): each
# kernel's name in the kernels line, the TPU kernel it replaces (the body's
# line) and the pallas_call that launched it.
PROBE_KERNELS = {
    "probe_pack_sum": ("scripts/r3_platbug.py:69",
                       "scripts/r3_platbug.py:78"),
    "probe_derive_pack_sum": ("scripts/r3_platbug.py:91",
                              "scripts/r3_platbug.py:106"),
    "probe_workspace_copy": ("scripts/r8_mosaic_rules.py:50",
                             "scripts/r8_mosaic_rules.py:31"),
    "probe_staged_copy": ("scripts/r8_mosaic_rules.py:63",
                          "scripts/r8_mosaic_rules.py:31"),
    "probe_ref_slice": ("scripts/r8_mosaic_rules.py:72",
                        "scripts/r8_mosaic_rules.py:31"),
    "probe_value_slice": ("scripts/r8_mosaic_rules.py:82",
                          "scripts/r8_mosaic_rules.py:31"),
    "probe_narrow_copy": ("scripts/r8_mosaic_rules.py:94",
                          "scripts/r8_mosaic_rules.py:31"),
    "probe_value_transpose": ("scripts/r8_mosaic_rules.py:105",
                              "scripts/r8_mosaic_rules.py:31"),
    "probe_peer_copy": ("scripts/r8_mosaic_rules.py:121",
                        "scripts/r8_mosaic_rules.py:129"),
}
# Launches of one run of both probe scripts: r3's pack sum twice (the
# pack built on the card, then round-tripped through the host), r8's
# workspace copy twice (1a, 1b), every other probe once.
PROBE_LAUNCHES = {k: 2 if k in ("probe_pack_sum", "probe_workspace_copy")
                  else 1 for k in PROBE_KERNELS}


def probe_wrappers():
    """The probe kernels' wrappers by their names in the kernels line."""
    from nbody_tpu_torch.ops import probes
    return {f"probe_{w.__name__}": w for w in (
        probes.pack_sum, probes.derive_pack_sum, probes.workspace_copy,
        probes.staged_copy, probes.ref_slice, probes.value_slice,
        probes.narrow_copy, probes.value_transpose, probes.peer_copy)}


def check_probes(dev, record, smi):
    """The probe kernels' records at their scripts' shapes: each timed
    beside its plain version and the one PyTorch call that computes the
    same function, where one does, with its largest difference from its
    plain version on the same input.  The bit checks (r3's three variants
    equal, every probe equal to its plain version) are the probe scripts'
    own, run on the main path (``probe_scripts``)."""
    import torch
    import torch.nn.functional as F
    from nbody_tpu_torch.ops import probes
    from nbody_tpu_torch.utils.timing import time_ms
    t_all = time.perf_counter()
    pos = torch.from_numpy(probes.r3_positions()).to(dev)
    n = pos.shape[0]
    pack = probes.pack8(pos * 1.0)
    x = torch.from_numpy(probes.r8_tile()).to(dev)
    # 2b's function as one multiply by a constant (8, 1) scale.
    scale = torch.tensor([2.0] * 3 + [1.0] * 5, device=dev).view(8, 1)
    tile = x.numel() * 4
    # name: (kernel, plain, one PyTorch call or None, float32 flops, bytes
    # the function must read and write).  2a reads rows 0-2 and writes the
    # tile (rows 3-7 NaN); 3a reads columns 0-2; 3b reads rows 0-3 and
    # writes a (4, 128) tile.
    cases = {
        "probe_pack_sum": (lambda: probes.pack_sum(pack),
                           lambda: probes.pack_sum_plain(pack),
                           lambda: pack.float().sum(0), 8 * n, 16 * n + 32),
        "probe_derive_pack_sum": (lambda: probes.derive_pack_sum(pos),
                                  lambda: probes.derive_pack_sum_plain(pos),
                                  None, 8 * n, 12 * n + 32),
        "probe_workspace_copy": (lambda: probes.workspace_copy(x),
                                 lambda: probes.workspace_copy_plain(x),
                                 lambda: x.clone(), 0, 2 * tile),
        "probe_staged_copy": (lambda: probes.staged_copy(x),
                              lambda: probes.staged_copy_plain(x),
                              lambda: x.clone(), 0, 2 * tile),
        "probe_ref_slice": (lambda: probes.ref_slice(x),
                            lambda: probes.ref_slice_plain(x),
                            lambda: F.pad(x[:3], (0, 0, 0, 5),
                                          value=float("nan")),
                            0, 3 * 128 * 4 + tile),
        "probe_value_slice": (lambda: probes.value_slice(x),
                              lambda: probes.value_slice_plain(x),
                              lambda: x * scale, 3 * 128, 2 * tile),
        "probe_narrow_copy": (lambda: probes.narrow_copy(x),
                              lambda: probes.narrow_copy_plain(x),
                              lambda: F.pad(x[:, :3], (0, 125)), 0,
                              8 * 3 * 4 + tile),
        "probe_value_transpose": (lambda: probes.value_transpose(x),
                                  lambda: probes.value_transpose_plain(x),
                                  None, 3 * 128, 2 * 4 * 128 * 4),
        "probe_peer_copy": (lambda: probes.peer_copy(x),
                            lambda: probes.peer_copy_plain(x),
                            lambda: x.clone(), 0, 2 * tile),
    }
    for kname, (fn, plain, library, flops, nbytes) in cases.items():
        got, want = fn(), plain()
        r3 = kname in ("probe_pack_sum", "probe_derive_pack_sum")
        record[kname] = {
            "shape": (f"N={n} rows in blocks of {probes.R3_U}" if r3
                      else "an (8, 128) float32 tile"),
            "max_abs_err": float((got.nan_to_num() - want.nan_to_num())
                                 .abs().max()),
            "ms": time_ms(fn, dev, iters=200),
            "card_ms": device_ms(fn, 100),
            "plain_ms": time_ms(plain, dev, iters=20 if r3 else 200),
            "library_ms": (time_ms(library, dev, iters=200)
                           if library is not None else None),
            "bound": bound(flops, nbytes)}
        r = record[kname]
        lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else "none")
        print(f"[time] {kname}: kernel {r['ms']:.4f} ms (the card "
              f"{r['card_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library "
              f"{lib}, bound {r['bound'][0]:.7f} ms, max abs err "
              f"{r['max_abs_err']:g} ({smi})")
    probes.peer_copy_errors()
    print(f"[time] check_probes: {time.perf_counter() - t_all:.1f} s")


def probe_scripts(counts):
    """The probes through their scripts' mains (scripts/r3_platbug_torch.py,
    scripts/r8_mosaic_rules_torch.py), each exit 0, with the launches of
    ``PROBE_LAUNCHES`` and no other kernel."""
    before = counts()
    for script in ("r3_platbug_torch", "r8_mosaic_rules_torch"):
        spec = importlib.util.spec_from_file_location(
            script, os.path.join(ROOT, "scripts", f"{script}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        rc = mod.main(["--device", "cuda"])
        check(rc == 0, f"scripts/{script}.py: exit {rc}")
    delta = {k: v - before[k] for k, v in counts().items()}
    print(f"[main path] the probe scripts: launches "
          f"{ {k: v for k, v in delta.items() if v} }")
    check(all(v == PROBE_LAUNCHES.get(k, 0) for k, v in delta.items()),
          f"the probe scripts: launches {delta}")


# The ladder (nbody_tpu_torch/bench_suite.py): the drift of rows 2 and 7
# as ``--long-horizon 0.002`` and ``--long-horizon 1e6`` read it on an H100
# (validate's 1000-step phase at N = 8192, seed 0: K3 = per-step K2,
# PERF.md section 6), to the printed digits.
LADDER_LONG_GATE = {"2": 1.237e-2, "7": 6.527e-3}


def ladder_route(key, cards):
    """The kernels ladder row ``key`` launches: K2 a step (per step at or
    above the K1/K2 crossover, bounded at 4M); the ring row on ``cards``
    shards, the N3L ring: K2 on the self shards, K2-rect on the cross
    rotations, K1 on the antipodal sweep of an even count."""
    route = {"forces_sym"}
    if key == "5":
        if (cards - 1) // 2:
            route.add("rect_forces_sym_vpu2")
        if cards > 1 and cards % 2 == 0:
            route.add("forces_tiled")
    return route


def ladder_smoke():
    """Ladder rows 1 and 3 as a user runs them, ``python -m
    nbody_tpu_torch.bench_suite --configs 1,3`` in a subprocess: exit 0,
    no row in error, row 1 passed."""
    os.makedirs(WORK, exist_ok=True)
    out = os.path.join(WORK, "ladder.jsonl")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nbody_tpu_torch.bench_suite", "--configs",
         "1,3", "--out", out], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    for line in proc.stdout.splitlines():
        print(f"[ladder] {line}")
    check(proc.returncode == 0,
          f"bench_suite --configs 1,3: exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    check([r["config"] for r in recs] == ["oracle-gate", "throughput-64k"]
          and not any("error" in r for r in recs), f"ladder rows: {recs}")
    check(recs[0]["passed"], f"ladder row 1 failed its gate: {recs[0]}")
    print(f"[time] bench_suite --configs 1,3 (a process): "
          f"{time.perf_counter() - t0:.1f} s")


def check_ladder(keys, counts, reset, smi):
    """``--ladder``: the ladder's rows in this process on every card of the
    host, each with the launch counters reset before it: no row in error,
    each row's kernels its route (``ladder_route``), row 1 passed, rows 2
    and 7 ``LADDER_LONG_GATE``; each record printed with the seconds it
    took and its launches by card."""
    import torch
    from nbody_tpu_torch import bench_suite
    from nbody_tpu_torch.ops import _build
    cards = torch.cuda.device_count()
    records = []
    for key in keys:
        name = bench_suite.CONFIGS[key][0]
        reset()
        by_card = dict(_build.DEVICE_LAUNCHES)
        t0 = time.perf_counter()
        rec = bench_suite.run_config(key)
        secs = time.perf_counter() - t0
        launched = {k: v for k, v in counts().items() if v}
        per_card = {c: n - by_card.get(c, 0)
                    for c, n in sorted(_build.DEVICE_LAUNCHES.items())
                    if n - by_card.get(c, 0)}
        print(f"[ladder] row {key} {name} on {cards} card(s): {secs:.1f} s, "
              f"launches {launched}, by card {per_card} ({smi})")
        print("[ladder] " + json.dumps(rec))
        records.append(rec)
        check("error" not in rec, f"ladder row {key}: {rec.get('error')}")
        check(set(launched) == ladder_route(key, cards),
              f"ladder row {key}: launched {launched}, its route "
              f"{sorted(ladder_route(key, cards))}")
        if key == "1":
            check(rec["passed"], f"ladder row 1 failed its gate: {rec}")
        if key in LADDER_LONG_GATE:
            drift, want = rec["energy_drift_vs_oracle"], LADDER_LONG_GATE[key]
            print(f"[ladder] row {key} drift {drift:.3e} against validate's "
                  f"1000-step phase's {want:.3e}")
            check(f"{drift:.3e}" == f"{want:.3e}",
                  f"ladder row {key}: drift {drift} is not {want}")
    bench_suite.print_table(records)
    return records


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


def device_ms(fn, iters, spin=10_000_000):
    """Milliseconds of the card's work for one of ``iters`` calls of
    ``fn``, not of the host's: a spin kernel holds the card busy while the
    host enqueues the calls between two CUDA events, so that the launch
    path does not show (the calls must enqueue within the spin, ~5 ms)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# The SymMath ids (csrc/sym_common.cuh) of the triangular pair kernels of
# K7 and the three vpu_* forms.
SYM_MATH = {"vpu": 1, "vpu_noj": 2, "vpu_fix0": 3, "vpu_rc": 4}
# The MUFU's rate on one H100 SXM: 16 a clock on each of its 132 SMs at the
# 1.98 GHz boost clock.  A pair of K5's tile takes one MUFU rsqrt, and K5's
# and tmm_nomm's one bf16x2 convert (F2FP) a pair too.
MUFU_RATE = 16 * 132 * 1.98e9
# tmm_nomm's consumer (nomm_add, csrc/sym_tc_tile.cuh) takes, for each
# bf16x2 weight register, a mask (a LOP3), a shift and two FADDs: four
# issue slots a register, one register a pair.  The pair code of K5's tile
# has no LOP3, so the consumer's slots a pair are four times the loop's
# LOP3 a pair (tools/sym_tc_variants.py --variant tmm's sink, the consumer
# cut to one XOR, gives the same count).
NOMM_SLOTS_A_LOP3 = 4


def pinned(pin, fn):
    """``fn`` with a library's ablation pair launches held at their
    controls' CTAs an SM by ``pin`` (its nbt_sym_abl_pin or
    nbt_sym_tc_abl_pin, the pins of ablation_sym.control_occupancy)."""
    from nbody_tpu_torch.ops import _build

    def run():
        check(_build.query("cuda", pin, 1) >= 0,
              f"{pin.__name__}: the pin failed")
        try:
            return fn()
        finally:
            _build.query("cuda", pin, 0)
    return run


def k5_split(med, n, record, smi):
    """K5's split from check_ablations' rounds at N = ``n`` (``med``: the
    medians by kernel name; K5, tmm_noj and tmm_nomm pinned at K5's CTAs
    an SM): the j-side pass (K5 less tmm_noj), the pair terms with both
    roundings (the no-mma floor: tmm_nomm as measured, and corrected by
    its column loop's issue slots a pair without and with its consumer,
    from tools/ptxas_compare.py's loop_slots) and what each floor leaves
    to the i-side mma, each a share of K5's median."""
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import forces_sym as k2
    from tools.ptxas_compare import loop_slots
    so = str(_build.library_path("forces_sym_tc"))
    # SymTcVariant ids (csrc/sym_tc_tile.cuh).
    slots = {v: loop_slots(so, f"_Z19sym_tc_pairs_kernelILi{i}E")
             for v, i in (("turbo", 0), ("tmm_noj", 7), ("tmm_nomm", 8))}
    check(None not in slots.values(), "K5, tmm_noj or tmm_nomm: no column "
          "loop in its SASS")
    k5, noj, nomm = (med["forces_sym_turbo"],
                     med["forces_sym_tmm_noj pinned"],
                     med["forces_sym_tmm_nomm pinned"])
    # tmm_nomm's column loop without its consumer (NOMM_SLOTS_A_LOP3).
    check(slots["turbo"][1] == 0 and slots["tmm_noj"][1] == 0,
          "K5's or tmm_noj's column loop has a LOP3: the consumer's slots "
          "cannot be counted by tmm_nomm's LOP3")
    with_c = slots["tmm_nomm"][0]
    consumer = NOMM_SLOTS_A_LOP3 * slots["tmm_nomm"][1]
    check(0 < consumer < with_c, f"tmm_nomm's consumer: {consumer} slots")
    floor = nomm * (with_c - consumer) / with_c
    print(f"[split] tmm_nomm's column loop: {with_c:.3f} issue slots a pair "
          f"with its consumer, {consumer:.3f} of them the consumer's; "
          f"consumer-corrected floor {nomm:.3f} x {with_c - consumer:.3f} / "
          f"{with_c:.3f} = {floor:.3f} ms")
    print(f"[split] K5 at N={n}, pinned at its CTAs an SM, medians of "
          f"{ABLATION_ROUNDS} rounds: K5 {k5:.3f} ms, tmm_noj {noj:.3f}, "
          f"tmm_nomm {nomm:.3f} (its consumer included); ms an issue slot "
          f"a pair: " + ", ".join(
              f"{name} {t / slots[v][0]:.3f}" for name, v, t in (
                  ("K5", "turbo", k5), ("tmm_noj", "tmm_noj", noj),
                  ("tmm_nomm", "tmm_nomm", nomm))) + f" ({smi})")
    print(f"[split] K5's j-side pass (K5 less tmm_noj): {(k5 - noj) / k5:.2%}"
          f" of K5")
    for what, base in (("consumer-corrected", floor), ("measured", nomm)):
        print(f"[split] the no-mma floor, pair terms and both roundings "
              f"({what}): {base / k5:.2%} of K5; it leaves the i-side mma "
              f"{(noj - base) / k5:.2%} (tmm_noj less the floor, which "
              f"carries the j side's rounding and tmm_noj does not; a "
              f"share below 0 means the parts do not add)")
    nb = -(-n // k2.SYM_TILE)
    mufu = 1e3 * (nb * (nb - 1) // 2) * k2.SYM_TILE ** 2 / MUFU_RATE
    print(f"[split] the sweep's off-diagonal pairs at MUFU_RATE: {mufu:.3f} "
          f"ms for one MUFU rsqrt a pair ({mufu / nomm:.2%} of tmm_nomm's "
          f"time, {mufu / k5:.2%} of K5's); {2 * mufu:.3f} if one F2FP a "
          f"pair shared that unit (not probed)")
    record["forces_sym_turbo"].update({
        "split_j_side": (k5 - noj) / k5, "split_floor_measured": nomm / k5,
        "split_floor_corrected": floor / k5})


def k7_split(med, n, record, smi):
    """K7's split from check_ablations' rounds at N = ``n`` (``med``: the
    medians by kernel name; the vpu_* forms pinned at K7's CTAs an SM):
    K7 less vpu_noj (the j side on the pair tile), vpu_fix0 less K7
    (JAX's dynamic-offset scatter), vpu_rc less K7 (three FADDs a pair,
    which its loop must carry beside K7's, by tools/ptxas_compare.py's
    loop_slots) and vpu_rc free against pinned, each a share of K7."""
    from nbody_tpu_torch.ops import _build
    from tools.ptxas_compare import loop_slots
    so = str(_build.library_path("forces_sym"))
    slots = {v: loop_slots(so, f"_Z16sym_pairs_kernelILi{SYM_MATH[v]}E",
                           ("FADD",)) for v in SYM_MATH}
    check(None not in slots.values(), "K7 or a vpu_* form: no pair loop in "
          "its SASS")
    extra = slots["vpu_rc"][1] - slots["vpu"][1]
    check(abs(extra - 3) < 1e-6, f"vpu_rc's loop carries {extra:.3f} FADD a "
          f"pair more than K7's, not 3")
    k7, noj, fix0, rc, rc_free = (
        med["forces_sym_vpu"], med["forces_sym_vpu_noj pinned"],
        med["forces_sym_vpu_fix0 pinned"], med["forces_sym_vpu_rc pinned"],
        med["forces_sym_vpu_rc"])
    print(f"[split] K7 at N={n}, the vpu_* forms pinned at its CTAs an SM, "
          f"medians of {ABLATION_ROUNDS} rounds: K7 {k7:.3f} ms, vpu_noj "
          f"{noj:.3f}, vpu_fix0 {fix0:.3f}, vpu_rc {rc:.3f} (free "
          f"{rc_free:.3f}); ms an issue slot a pair: " + ", ".join(
              f"{v} {med[k] / slots[v][0]:.3f}" for v, k in (
                  ("vpu", "forces_sym_vpu"),
                  ("vpu_noj", "forces_sym_vpu_noj pinned"),
                  ("vpu_rc", "forces_sym_vpu_rc pinned"))) + f" ({smi})")
    print(f"[split] K7 less vpu_noj, the j side on the pair tile: "
          f"{(k7 - noj) / k7:.2%} of K7 ({slots['vpu'][0]:.3f} against "
          f"{slots['vpu_noj'][0]:.3f} issue slots a pair)")
    print(f"[split] vpu_fix0 less K7, JAX's dynamic-offset scatter (a store "
          f"address here; fix0's reduce in place of the slot sum): "
          f"{(fix0 - k7) / k7:+.2%} of K7")
    print(f"[split] vpu_rc pinned less K7, three FADDs a pair: "
          f"{(rc - k7) / k7:+.2%} of K7 ({slots['vpu_rc'][0]:.3f} against "
          f"{slots['vpu'][0]:.3f} issue slots a pair)")
    print(f"[split] vpu_rc free against pinned, the liveness it frees: "
          f"{(rc_free - rc) / rc:+.2%}")
    record["forces_sym_vpu"].update({
        "split_noj": (k7 - noj) / k7, "split_fix0": (fix0 - k7) / k7,
        "split_rc": (rc - k7) / k7, "split_rc_free": (rc_free - rc) / rc})


def check_fold(dev, eps2):
    """The cluster folds at other cluster sizes: K14d (both maths) at
    block_u 512, 768 and 2048 (clusters of 2, 3 and 8 CTAs) at N = 2500
    and 8192, and the K2-rect folds at block_u 512, 1024 and 2048 at
    2048 x 2048 and at a ragged 2144 x 1536 (A padded to whole
    superblocks), each against its twin at the exact tolerance,
    bit-reproducible and chunk-invariant, K14d also bit-equal with one CTA
    an item; K2's and K7's folds, square and rect, with three real
    massless bodies against float64 (K2's math recomputes such a row
    one-sided)."""
    import torch
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    t0 = time.perf_counter()
    lib = k2._lib()
    square = ((k2.forces_sym_fold, k2.forces_sym_plain),
              (k2.forces_sym_vpu_fold, k2.forces_sym_vpu_plain))
    for n in (2500, 8192):
        pos, mass = bodies(n, n + 14, dev)
        for u in (512, 768, 2048):
            for fn, plain in square:
                tag = f"{fn.__name__} U={u} N={n}"
                got = fn(pos, mass, eps2, block_u=u)
                compare(f"{tag} vs plain", got,
                        plain(pos, mass, eps2, block_u=u))
                check(torch.equal(got, fn(pos, mass, eps2, block_u=u)),
                      f"{tag}: not bit-reproducible")
                _build.query(None, lib.nbt_sym_fold_mode, k2.FOLD_CTA)
                try:
                    cta = fn(pos, mass, eps2, block_u=u)
                finally:
                    _build.query(None, lib.nbt_sym_fold_mode, k2.FOLD_AUTO)
                check(torch.equal(got, cta), f"{tag}: one CTA an item "
                      f"differs from the automatic spread")
                one = fn(pos, mass, eps2, block_u=u,
                         slot_budget=24 * (-(-n // u) * u))
                check(torch.equal(got, one), f"{tag}: one offset per chunk "
                      f"differs from one chunk")
    for na, nb in RECT_SHAPES:
        pa, ma = bodies(na, na + 23, dev)
        pb, mb = bodies(nb, nb + 24, dev)
        for u in (512, 1024, 2048):
            for k7, fn in ((False, k2.rect_forces_sym_fold),
                           (True, k2.rect_forces_sym_vpu_fold)):
                tag = f"{fn.__name__} U={u} {na}x{nb}"
                got = fn(pa, ma, pb, mb, eps2, block_u=u)
                for side, g, w in zip("ab", got, k2.rect_forces_sym_plain(
                        pa, ma, pb, mb, eps2, k7, u)):
                    compare(f"{tag} acc_{side} vs plain", g, w)
                check(all(torch.equal(x, y) for x, y in zip(
                    got, fn(pa, ma, pb, mb, eps2, block_u=u))),
                    f"{tag}: not bit-reproducible")
                one = fn(pa, ma, pb, mb, eps2, block_u=u,
                         slot_budget=24 * (-(-na // u) * u))
                check(all(torch.equal(x, y) for x, y in zip(got, one)),
                      f"{tag}: one column superblock per chunk differs "
                      f"from one chunk")
    print("[check] K14d and the K2-rect folds at clusters of 2, 3, 4 and 8 "
          "CTAs: at their twins, bit-reproducible and chunk-invariant")
    pos, mass = bodies(1000, 7, dev)
    zero = [3, 400, 999]
    mass[zero] = 0.0
    ref = rect_forces(pos.double(), pos.double(), mass.double(), eps2)
    for fn, _ in square:
        for u in (512, 1024):
            got = fn(pos, mass, eps2, block_u=u)
            compare(f"{fn.__name__} U={u}, three real massless rows vs "
                    f"float64", got[zero], ref[zero])
            compare(f"{fn.__name__} U={u} with three massless bodies vs "
                    f"float64", got, ref)
    pa, ma = bodies(2048, 33, dev)
    pb, mb = bodies(1536, 34, dev)
    ma[[3, 2047]] = 0.0
    mb[[5, 1535]] = 0.0
    ref = (rect_forces(pa.double(), pb.double(), mb.double(), eps2),
           rect_forces(pb.double(), pa.double(), ma.double(), eps2))
    for fn in (k2.rect_forces_sym_fold, k2.rect_forces_sym_vpu_fold):
        got = fn(pa, ma, pb, mb, eps2)
        compare(f"{fn.__name__}, massless rows of A vs float64",
                got[0][[3, 2047]], ref[0][[3, 2047]])
        compare(f"{fn.__name__}, massless rows of B vs float64",
                got[1][[5, 1535]], ref[1][[5, 1535]])
    print(f"[time] fold checks: {time.perf_counter() - t0:.1f} s")


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
        for n in (1536, 2048, 4096, 8192, 12288, 16384, 20480, 24576,
                  32768):
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


def jax_kepler(place, impl, spp):
    """The JAX package's cell for ``impl`` at S = ``spp``: five gates of
    errors at S + KEPLER_OFFSETS (float64: one)."""
    key = (place, KEPLER_JAX_IMPL.get(impl, impl), spp)
    return JAX_KEPLER[JAX_KEPLER_SAME.get(key, key)]


def hold_kepler(what, results, cell, spp, dtype="float32"):
    """Print each gate's error and tolerance on the card beside the JAX
    package's figures, and hold them to the rules of JAX_KEPLER."""
    from nbody_tpu_torch.models.kepler import gate_cases
    offsets = KEPLER_OFFSETS if dtype == "float32" else (0,)
    tols = [c.tol for c in gate_cases(dtype, spp, "cpu")]
    for g, r in enumerate(results):
        errs = cell[g]
        lo, hi = min(errs), max(errs)
        j0, t0 = errs[offsets.index(0)], tols[g]
        noise = hi > 2.0 * lo
        top = max(hi, KEPLER_NOISE[dtype]) if noise else hi
        print(f"[kepler] {what} S={spp} {r['gate']}: card "
              f"{r['max_rel_err']:.4e} tol {r['tol']:.4e} "
              f"{'OK ' if r['ok'] else 'FAIL'} | JAX {j0:.4e} "
              f"{'OK ' if j0 <= t0 else 'FAIL'} (S-16..S+16: "
              f"{lo:.3e}..{hi:.3e}{', noise' if noise else ''})")
        check(r["max_rel_err"] <= 2.0 * top
              and (noise or r["max_rel_err"] >= 0.5 * lo),
              f"kepler {what} S={spp} {r['gate']}: card error "
              f"{r['max_rel_err']:.4e} not within a factor of 2 of the "
              f"JAX package's {lo:.4e}..{top:.4e}")
        if abs(j0 - t0) > 0.25 * t0:
            check(r["ok"] == (j0 <= t0), f"kepler {what} S={spp} "
                  f"{r['gate']}: the card's verdict is not the JAX "
                  f"package's ({j0:.4e} against {t0:.4e})")


_GATE_LINE = re.compile(r"\[(OK |FAIL)\] (\S+): max rel pos err (\S+) after "
                        r"(\d+) steps \(1 period; tol (\S+)\)")


def kepler_cli(counts, impl, steps, dtype="float32"):
    """``validate --analytic`` through the CLI with the launch counters:
    the gates' results as the CLI prints them.  The impl's kernel (if any)
    launches once a force evaluation, 9 S + 4 times (S, S + 1, 3 S + 1, S +
    1 and 3 S + 1 over the five gates), and no other kernel launches."""
    import io
    from nbody_tpu_torch.cli import main as cli_main
    argv = ["validate", "--analytic", "--impl", impl, "--dtype", dtype]
    if steps:
        argv += ["--steps", str(steps)]
    spp = steps or 2048
    before = counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(on_card0(argv))
    text = out.getvalue()
    sys.stdout.write(text)
    delta = {k: v - before[k] for k, v in counts().items()}
    kernel = KEPLER_PAIR_IMPLS.get(impl) if dtype == "float32" else None
    check(all(v == (9 * spp + 4 if k == kernel else 0)
              for k, v in delta.items()),
          f"validate --analytic --impl {impl}: launches "
          f"{ {k: v for k, v in delta.items() if v} }")
    results = [{"gate": m[2], "max_rel_err": float(m[3]), "steps": int(m[4]),
                "tol": float(m[5]), "ok": m[1] == "OK "}
               for m in _GATE_LINE.finditer(text)]
    check(len(results) == 5 and all(r["steps"] == spp for r in results),
          f"validate --analytic --impl {impl}: {len(results)} gate lines")
    ok = all(r["ok"] for r in results)
    check(rc == (0 if ok else 1) and text.rstrip().endswith(
        "Analytic verification " + ("PASSED" if ok else "FAILED")),
        f"validate --analytic --impl {impl}: exit {rc}")
    return results, rc


def check_kepler(counts):
    """The closed-form gates on the card: every impl through ``validate
    --analytic`` at N = 2 (KEPLER_STEPS and the default), float64 once;
    the split form for the pair-symmetric impls through run_steps, and K3
    / K4 through the resident entry points, bit-equal to per-step K2."""
    import torch
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.models.kepler import (gate_cases, gate_result,
                                               split_pair)
    from nbody_tpu_torch.ops import resident
    t0 = time.perf_counter()
    for impl in KEPLER_PAIR_IMPLS:
        for steps in (1024, None):
            spp = steps or 2048
            results, rc = kepler_cli(counts, impl, steps)
            # K9 fails at 1024 steps a period as JAX's does; every other
            # impl passes there.
            check(rc == 0 or steps != 1024 or impl == "pallas_turbo",
                  f"validate --analytic --steps 1024 --impl {impl}: exit "
                  f"{rc}")
            hold_kepler(
                f"pair {impl} (validate --analytic"
                f"{' --steps 1024' if steps else ''}: exit {rc})", results,
                jax_kepler("pair", impl, spp), spp)
    for spp in KEPLER_STEPS:   # 2048 as validate's default
        results, rc = kepler_cli(counts, "xla_nxn", spp if spp != 2048
                                 else None, "float64")
        check(rc == 0, f"validate --analytic --dtype float64: exit {rc}")
        hold_kepler(
            "pair xla_nxn float64", results,
            jax_kepler("pair", "xla_nxn/float64", spp), spp, "float64")
    print(f"[time] validate --analytic, {len(KEPLER_PAIR_IMPLS)} impls x 2 "
          f"+ float64: {time.perf_counter() - t0:.1f} s")

    # The split form: bodies 0 and 256 in two superblocks.
    t0 = time.perf_counter()
    n = KEPLER_SPLIT_AT + 1
    for spp in KEPLER_STEPS:
        per_step = {}
        for impl in KEPLER_SPLIT_IMPLS:
            kernel = KEPLER_PAIR_IMPLS[impl]
            results = []
            before = counts()
            for case in gate_cases("float32", spp, "cuda"):
                cfg = nt.SimConfig(n_bodies=n, dt=case.dt, eps2=case.eps2,
                                   impl=impl, integrator=case.integrator)
                st = split_pair(case.state, KEPLER_SPLIT_AT)
                if case.integrator != "reference":
                    st = nt.ops.step.prime_kdk(st, cfg)
                out = nt.run_steps(st, cfg, spp)
                check(bool(torch.isfinite(out.pos).all()),
                      f"kepler split {impl}: non-finite state")
                if impl == "pallas_sym2":
                    per_step[case.gate] = (st, out)
                results.append(gate_result(
                    case, out.pos[[0, KEPLER_SPLIT_AT]]))
            delta = {k: v - before[k] for k, v in counts().items()}
            check(all(v == (9 * spp + 4 if k == kernel else 0)
                      for k, v in delta.items()),
                  f"kepler split {impl}: launches "
                  f"{ {k: v for k, v in delta.items() if v} }")
            hold_kepler(
                f"split {impl}", results, jax_kepler("split", impl, spp),
                spp)
        # K3 (reference) and K4 (kdk, yoshida4): one launch a gate from
        # the same (primed) split states, bit-equal to per-step K2.
        results = []
        before = counts()
        for case in gate_cases("float32", spp, "cuda"):
            cfg = nt.SimConfig(n_bodies=n, dt=case.dt, eps2=case.eps2,
                               impl="pallas_sym2",
                               integrator=case.integrator)
            st, want = per_step[case.gate]
            got = resident.run_steps_resident(st, cfg, spp)
            check(states_equal(got, want),
                  f"kepler split {case.gate}: {spp} resident steps differ "
                  f"from {spp} per-step K2 steps")
            results.append(gate_result(case, got.pos[[0, KEPLER_SPLIT_AT]]))
        delta = {k: v - before[k] for k, v in counts().items()}
        check(delta["resident"] == 1 and delta["resident_kdk"] == 4
              and all(v == 0 for k, v in delta.items()
                      if k not in ("resident", "resident_kdk")),
              f"kepler split K3/K4: launches "
              f"{ {k: v for k, v in delta.items() if v} }")
        hold_kepler(
            "split K3/K4 (resident, bit-equal to per-step K2)", results,
            jax_kepler("split", "pallas_sym2", spp), spp)
    print(f"[time] kepler split form, {len(KEPLER_SPLIT_IMPLS)} impls and "
          f"K3/K4 x 2: {time.perf_counter() - t0:.1f} s")


# The presets at full width through the CLI: (name, argv, the launches of
# each kernel (others 0)).  validate's dt = 0.01 resolves the virialised
# core (~0.03 scale radii a step; at the default dt = 0.1 the JAX
# package's own validate fails this preset at N = 8192 on the CPU).
PRESET_PHASES = (
    ("plummer-virial", ["run", "--n", "1048576", "--steps", "2",
                        "--energy"], {"forces_sym": 2, "pe_total": 2}),
    ("collision", ["run", "--n", "8192", "--steps", "100"],
     {"resident": 1}),
    ("disk", ["run", "--n", "8192", "--impl", "pallas_fast",
              "--sort-every", "10", "--steps", "100"], {"forces_fast": 100}),
    ("plummer-virial", ["validate", "--n", "8192", "--steps", "10",
                        "--long-steps", "0", "--dt", "0.01",
                        "--oracle", "native"], {"forces_sym": 10}))
VIRIAL_SAMPLE = 8192


def preset_contract(name, state, eps2, max_pos):
    """The statistical contract of ``tests/test_init_presets.py`` on a
    card state: the virial ratio (about 1 for plummer-virial, from at most
    VIRIAL_SAMPLE bodies with their masses scaled by N / n, which keeps
    2K / |W| unbiased), zero momentum, the disk thin and every body
    prograde, the collision's two clusters approaching."""
    import numpy as np
    import torch
    from nbody_tpu_torch.analysis import lagrangian_radii, virial_ratio
    from nbody_tpu_torch.models.state import state_to_numpy
    h = state_to_numpy(state)
    pos, vel, mass = (h[k].astype(np.float64) for k in ("pos", "vel",
                                                         "mass"))
    n = len(mass)
    check(all(np.isfinite(x).all() for x in (pos, vel, mass)),
          f"preset {name}: non-finite state")
    idx = np.arange(n)
    if n > VIRIAL_SAMPLE:
        g = torch.Generator().manual_seed(1)
        idx = torch.randperm(n, generator=g)[:VIRIAL_SAMPLE].numpy()
    q = virial_ratio(pos[idx], vel[idx], mass[idx] * (n / len(idx)), eps2)
    p = np.sum(mass[:, None] * vel, axis=0)
    p_rel = float(np.abs(p).max() / np.sum(mass * np.linalg.norm(vel,
                                                                 axis=1)))
    r_half = lagrangian_radii(pos, mass, (0.5,))[0]
    line = (f"[preset] {name} N={n}: virial ratio 2K/|W| {q:.4f} "
            f"({len(idx)} bodies), |P|/scale {p_rel:.3e}, half-mass "
            f"radius {r_half:.4e}")
    if name == "plummer-virial":
        check(0.7 < q < 1.3, f"preset {name}: virial ratio {q}")
        check(p_rel < 1e-6, f"preset {name}: momentum {p_rel}")
    elif name == "disk":
        a = max_pos / 4.0
        z95 = float(np.percentile(np.abs(pos[:, 2]), 95))
        r_max = float(np.linalg.norm(pos[:, :2], axis=1).max())
        ang = np.sum(mass[:, None] * np.cross(pos, vel), axis=0)
        lz = pos[:, 0] * vel[:, 1] - pos[:, 1] * vel[:, 0]
        line += (f", |z| 95th pct {z95 / a:.4f} a, max R {r_max / a:.6f} "
                 f"a, L_z / max(|L_x|, |L_y|) "
                 f"{abs(ang[2]) / max(abs(ang[0]), abs(ang[1])):.1f}, "
                 f"prograde {int((lz > 0).sum())}/{n}")
        check(z95 < 0.2 * a and r_max <= a * 1.0001, f"preset {name}: "
              f"not thin (|z| 95th pct {z95}, max R {r_max})")
        check(abs(ang[2]) > 50 * max(abs(ang[0]), abs(ang[1]))
              and bool(np.all(lz > 0)), f"preset {name}: not rotating")
    elif name == "collision":
        a = max_pos / 10.0
        left = pos[:, 0] < 0
        xl, xr = pos[left, 0].mean(), pos[~left, 0].mean()
        vl, vr = vel[left, 0].mean(), vel[~left, 0].mean()
        line += (f", left {left.mean():.4f} of the bodies, mean x "
                 f"{xl / a:.3f} a / {xr / a:.3f} a, mean v_x {vl:.4e} / "
                 f"{vr:.4e}")
        check(p_rel < 1e-6, f"preset {name}: momentum {p_rel}")
        check(0.3 < left.mean() < 0.7 and xl < -2 * a and xr > 2 * a
              and vl > 0 and vr < 0, f"preset {name}: not two clusters "
              f"approaching")
    print(line)


# Config #5 (BASELINE.md: N = 65,536, the interactive viz loop, frames/s)
# and the viz phase's other shapes.
VIZ_N = 65536
VIZ_STEPS = 120
VIZ_ROUNDS = ("off", "on", "on", "off")


def png_pixels(path):
    """The (H, W, 3) uint8 pixels of a PNG the port wrote: 8-bit RGB, one
    IDAT stream, filter 0 on every row."""
    import struct
    import zlib
    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    idat, off = b"", 8
    while off < len(data):
        (length,) = struct.unpack(">I", data[off:off + 4])
        if data[off + 4:off + 8] == b"IDAT":
            idat += data[off + 8:off + 8 + length]
        off += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    check(rows.shape[1] == 1 + 3 * w and not rows[:, 0].any(),
          f"{path}: not 8-bit RGB rows with filter 0")
    return rows[:, 1:].reshape(h, w, 3)


def host_render(pos, mass, cfg, view=None):
    """The host's colorized render of a state: the port's raster on the
    CPU, the reference every frame the card renders is held to."""
    import torch
    from nbody_tpu_torch.viz.raster import colorize, render_weights
    mv, cu, cv = view or (cfg.max_view, 0.0, 0.0)
    return colorize(render_weights(
        torch.as_tensor(pos).float().cpu(), torch.as_tensor(mass).float()
        .cpu(), cfg.min_mass, cfg.max_mass, mv, cfg.viz_width,
        cfg.viz_height, 2, cu, cv))


def check_viz(counts):
    """The viz and trajectory I/O through the CLI and the API with the
    launch counters: config #5 (``run --viz`` at N = 65,536, every step
    a frame, K2) timed against the same run headless, its last frame and
    K3's at 8192 equal to the host's render of the checkpointed end state;
    K3's frames against the per-step chain's; the mesh's frames against
    renders of the gathered state; the AVI sink; ``render`` and
    ``analyze`` of a 1M trajectory; the live viewer's frame, camera and
    stop; ``interactive`` with kernels 0 (K1) and 1 (K10)."""
    import builtins
    import contextlib
    import io
    import threading
    import urllib.request
    import numpy as np
    import torch
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.cli import main as cli_main
    from nbody_tpu_torch.models.simulation import Simulation
    from nbody_tpu_torch.ops.step import run_trajectory_frames
    from nbody_tpu_torch.parallel.mesh import make_mesh
    from nbody_tpu_torch.parallel.ring import (render_weights_sharded,
                                               run_steps_sharded)
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    from nbody_tpu_torch.viz import native_png
    from nbody_tpu_torch.viz.png import read_png_size
    from nbody_tpu_torch.viz.raster import colorize, render_weights
    from nbody_tpu_torch.viz.server import LiveViewer
    t_viz = time.perf_counter()
    work = os.path.join(WORK, "viz")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    start = counts()

    def phase(what, argv, expect):
        before = counts()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(on_card0(argv))
        wall = time.perf_counter() - t0
        check(rc == 0, f"{what}: exit {rc}")
        delta = {k: v - before[k] for k, v in counts().items()}
        print(f"[viz] {what}: launches "
              f"{ {k: v for k, v in delta.items() if v} }, {wall:.3f} s")
        for k, v in delta.items():
            check(expect.get(k, lambda v: v == 0)(v),
                  f"{what}: {k} launched {v} times")
        return wall, out.getvalue()

    lib = native_png._load()
    print(f"[viz] PNG encoders: frame files viz/png.py (Python zlib), the "
          f"live viewer "
          + ("native (native/libnbody_native.so)" if lib is not None
             else "viz/png.py (no native library)"))

    # Config #5: every step a frame at 65,536 through K2, against the same
    # run headless, in rounds off, on, on, off after a warm-up run;
    # frames/s counts the PNG drain (the streamer's close) and the set-up,
    # as a user sees them.
    walls, step_ms = {"on": [], "off": []}, []
    for k, mode in enumerate(("off",) + VIZ_ROUNDS):
        d = os.path.join(work, f"c5_{k}")
        end = os.path.join(work, f"c5_{k}.npz")
        argv = ["run", "--n", str(VIZ_N), "--steps", str(VIZ_STEPS),
                "--checkpoint", end]
        if mode == "on":
            argv += ["--viz", "--viz-every", "1", "--viz-dir", d]
        wall, out = phase(f"run --n {VIZ_N} --steps {VIZ_STEPS}"
                          + (" --viz --viz-every 1" if mode == "on" else ""),
                          argv, {"forces_sym": lambda v: v == VIZ_STEPS})
        if k == 0:
            continue                      # the warm-up run
        walls[mode].append(wall)
        if mode == "off":
            step_ms.append(float(re.search(
                r"Simulation complete: \d+ steps, ([\d.]+) ms/step",
                out).group(1)))
        if mode == "on":
            names = sorted(os.listdir(d))
            check(names == [f"frame_{i:06d}.png" for i in range(VIZ_STEPS)],
                  f"config #5: {len(names)} frames")
            check(all(read_png_size(os.path.join(d, f)) == (800, 600)
                      for f in names), "config #5: a frame is not 800x600")
            cfg = nt.SimConfig(n_bodies=VIZ_N)
            with np.load(end) as z:
                want = host_render(z["pos"], z["mass"], cfg)
            got = png_pixels(os.path.join(d, names[-1]))
            check(np.array_equal(got, want), "config #5: the last frame "
                  f"differs from the host's render of the end state on "
                  f"{int((got != want).any(-1).sum())} pixels")
            print(f"[viz] config #5 round {k}: {len(names)} frames 800x600, "
                  f"the last equal to the host's render of the end state "
                  f"({int(want.any(-1).sum())} lit pixels); {out.strip()}")
    fps = {m: [VIZ_STEPS / w for w in ws] for m, ws in walls.items()}
    busy = VIZ_STEPS * statistics.median(step_ms) / 1000.0
    print(f"[viz] config #5, N={VIZ_N}, {VIZ_STEPS} steps, auto (K2 per "
          f"step): frames/s with --viz --viz-every 1 (sim + render + "
          f"stream, PNG drain included) "
          f"{', '.join(f'{f:.2f}' for f in fps['on'])}; steps/s headless "
          f"{', '.join(f'{f:.2f}' for f in fps['off'])}; median "
          f"{statistics.median(fps['on']):.2f} against "
          f"{statistics.median(fps['off']):.2f}; the headless run's "
          f"ms/step {', '.join(f'{t:.4f}' for t in step_ms)}, so the card "
          f"is busy ~{busy:.3f} s of the viz run's median "
          f"{statistics.median(walls['on']):.3f} s (idle share "
          f"~{1 - busy / statistics.median(walls['on']):.3f}) "
          f"({nvidia_smi_line()})")
    viz_host_split(os.path.join(work, "c5_2"),
                   os.path.join(work, "c5_2.npz"))

    # K3 at 8192 under auto: frames from K3 launches of viz_every steps;
    # the last equal to the host's render of the checkpointed end state
    # and to the card's.
    d, end = os.path.join(work, "k3"), os.path.join(work, "k3.npz")
    phase("run --n 8192 --steps 100 --viz --viz-every 10 (auto)",
          ["run", "--n", "8192", "--steps", "100", "--viz", "--viz-every",
           "10", "--viz-dir", d, "--checkpoint", end],
          {"resident": lambda v: v == 10})
    cfg = nt.SimConfig(n_bodies=8192)
    names = sorted(os.listdir(d))
    check(len(names) == 10, f"K3 frames: {len(names)}")
    with np.load(end) as z:
        want = host_render(z["pos"], z["mass"], cfg)
        card = colorize(render_weights(
            torch.as_tensor(z["pos"], device="cuda"),
            torch.as_tensor(z["mass"], device="cuda"), cfg.min_mass,
            cfg.max_mass, cfg.max_view, 800, 600))
    got = png_pixels(os.path.join(d, names[-1]))
    check(np.array_equal(got, want) and np.array_equal(card, want),
          "K3's last frame differs from the host's render of the end state")
    print(f"[viz] K3 at 8192: 10 frames, the last equal to the host's and "
          f"the card's render of the checkpointed end state "
          f"({int(want.any(-1).sum())} lit pixels)")

    # K3 and the per-step chain in lockstep on a second state.
    cfg = nt.SimConfig(n_bodies=8192, seed=7)
    state = nt.init_state(cfg)
    out = {}
    for resident in (True, False):
        before = counts()
        out[resident] = run_trajectory_frames(
            state, cfg, 50, frame_every=10, impl="pallas_sym2", packed=True,
            resident=resident)
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts().items()
                 if v - before[k]}
        check(delta == ({"resident": 5} if resident
                        else {"forces_sym": 50}),
              f"run_trajectory_frames resident={resident}: launches {delta}")
    check(torch.equal(out[True][1], out[False][1])
          and states_equal(out[True][0], out[False][0]),
          "K3's frames differ from the per-step K2 chain's")
    print(f"[viz] K3 and per-step K2 in lockstep at 8192 (seed 7): 5 frames "
          f"bit-equal, end states bit-equal")

    # The mesh: 4 shards on this card, each frame the render of the
    # gathered state.
    d = os.path.join(work, "mesh")
    phase("run --shards 4 --n 8192 --steps 20 --viz --viz-every 5",
          ["run", "--shards", "4", "--n", "8192", "--steps", "20", "--viz",
           "--viz-every", "5", "--viz-dir", d],
          {"forces_sym": lambda v: v == 80,
           "rect_forces_sym_vpu2": lambda v: v == 80,
           "forces_tiled": lambda v: v == 80})
    mesh = make_mesh(4, "cuda:0")
    cfg = nt.SimConfig(n_bodies=8192, shards=4)
    sim = Simulation(cfg, mesh=mesh)
    names = sorted(os.listdir(d))
    check(len(names) == 4, f"mesh frames: {len(names)}")
    for k, name in enumerate(names):
        ref = run_steps_sharded(sim.state, cfg, mesh, 5 * (k + 1),
                                impl=sim.impl)
        w8 = render_weights(ref.pos, ref.mass, cfg.min_mass, cfg.max_mass,
                            cfg.max_view)
        check(torch.equal(render_weights_sharded(ref, cfg, mesh), w8),
              "render_weights_sharded differs from render_weights")
        check(np.array_equal(png_pixels(os.path.join(d, name)),
                             colorize(w8)),
              f"mesh frame {k} differs from the gathered state's render")
    print(f"[viz] mesh, 4 shards on this card ({sim.impl}): 4 frames, each "
          f"equal to the render of the gathered state")

    # The AVI sink: raw DIB frames without Pillow.
    from nbody_tpu_torch.viz.avi import _pil_available
    avi = os.path.join(work, "run.avi")
    phase("run --n 8192 --steps 20 --viz-avi --viz-every 2",
          ["run", "--n", "8192", "--steps", "20", "--viz-avi", avi,
           "--viz-every", "2"], {"resident": lambda v: v == 10})
    codec, sizes = avi_chunks(avi)
    check(codec == ("MJPG" if _pil_available() else "DIB ")
          and len(sizes) == 10
          and (codec == "MJPG" or set(sizes) == {800 * 600 * 3}),
          f"AVI: codec {codec!r}, {len(sizes)} frames")
    print(f"[viz] AVI sink: {len(sizes)} frames, codec {codec!r} "
          f"({'Pillow' if _pil_available() else 'no Pillow on this host'})")

    # render and analyze of a 1M trajectory with velocities.
    traj = os.path.join(work, "t1m.npz")
    phase("run --n 1048576 --steps 2 --save-trajectory --traj-vel",
          ["run", "--n", "1048576", "--steps", "2", "--save-trajectory",
           traj, "--traj-vel"], {"forces_sym": lambda v: v == 2})
    d, gif = os.path.join(work, "r1m"), os.path.join(work, "t1m.gif")
    phase("render (1M, 2 snapshots) --gif",
          ["render", traj, "--out-dir", d, "--gif", gif], {})
    names = sorted(os.listdir(d))
    check(len(names) == 2 and all(read_png_size(os.path.join(d, f))
                                  == (800, 600) for f in names),
          f"render: {names}")
    with np.load(traj) as z:
        want = host_render(z["snapshots"][1], z["mass"],
                           nt.SimConfig(n_bodies=1 << 20))
    check(np.array_equal(png_pixels(os.path.join(d, names[1])), want),
          "render: the card's frame differs from the host's render")
    with open(gif, "rb") as f:
        data = f.read()
    check(data[:6] == b"GIF89a" and data.count(b"\x21\xF9\x04") >= 2,
          "render: GIF")
    _, text = phase("analyze (1M) --json", ["analyze", traj, "--json"], {})
    res = json.loads(text)
    check(res["steps"] == [1, 2] and "energy" not in res
          and "N=1048576" in res.get("energy_note", "")
          and "g_r_note" in res
          and all(np.isfinite(res[k]).all() for k in (
              "com_drift", "lagrangian_radii", "g_r_first", "g_r_last",
              "momentum_drift", "ang_mom_drift")),
          f"analyze 1M: keys {sorted(res)}")
    print(f"[viz] render 1M: 2 frames and a {len(data)}-byte GIF, the last "
          f"frame equal to the host's render; analyze 1M: momentum drift "
          f"{res['momentum_drift'][-1]:.3e}, angular momentum drift "
          f"{res['ang_mom_drift'][-1]:.3e}; energy_note: "
          f"{res['energy_note']}; g_r_note: {res['g_r_note']}")

    # The live viewer on 127.0.0.1: one frame, one view change, then stop
    # ends a long K3 run at its next chunk boundary.
    cfg = nt.SimConfig(n_bodies=8192, viz_every=10)
    viewer = LiveViewer(port=0)
    url = f"http://127.0.0.1:{viewer.port}"
    result = {}

    def serve():
        try:
            result["res"] = Simulation(cfg).run(
                n_steps=1_000_000, log_every=0, frame_streamer=viewer)
        except BaseException as e:        # re-raised in the main thread
            result["err"] = e

    before = counts()
    runner = threading.Thread(target=serve)
    try:
        runner.start()
        png = urllib.request.urlopen(f"{url}/frame.png", timeout=60).read()
        check(png[:8] == b"\x89PNG\r\n\x1a\n", "viewer: /frame.png")
        urllib.request.urlopen(f"{url}/view?op=in", data=b"", timeout=10)
        check(viewer.view_state() == (1.25, 0.0, 0.0), "viewer: /view")
        seen = viewer.frames_written
        while viewer.frames_written < seen + 2 and runner.is_alive():
            time.sleep(0.01)
        urllib.request.urlopen(f"{url}/stop", data=b"", timeout=10)
        runner.join(timeout=120)
        check(not runner.is_alive(), "viewer: /stop did not end the run")
    finally:
        viewer.close()
    if "err" in result:
        raise result["err"]
    steps = result["res"].steps_run
    delta = {k: v - before[k] for k, v in counts().items() if v - before[k]}
    check(0 < steps < 1_000_000 and set(delta) == {"resident"},
          f"viewer: {steps} steps, launches {delta}")
    print(f"[viz] live viewer: /frame.png {len(png)} bytes, /view?op=in -> "
          f"zoom 1.25, /stop ended the run after {steps} of 1,000,000 "
          f"steps ({viewer.frames_written} frames served, launches "
          f"{delta})")

    # interactive, its three answers on stdin: kernel 0 with frames (K1),
    # kernel 1 headless (K10).
    for answers, kernel in ((["0", "y", "20"], "forces_tiled"),
                            (["1", "n", "20"], "forces_tiled_mxu")):
        d = os.path.join(work, f"interactive_{answers[0]}")
        feed = iter(answers)
        saved, builtins.input = builtins.input, lambda prompt: next(feed)
        try:
            _, text = phase(f"interactive {' / '.join(answers)}",
                            ["interactive", "--n", "8192", "--viz-dir", d],
                            {kernel: lambda v: v == 20})
        finally:
            builtins.input = saved
        check(("impl=pallas " if kernel == "forces_tiled"
               else "impl=pallas_mxu ") in text, f"interactive: {text}")
        check(len(os.listdir(d)) == 20 if answers[1] == "y"
              else not os.path.exists(d), "interactive: frames")
    delta = {k: v - start[k] for k, v in counts().items() if v - start[k]}
    print(f"[viz] launches of the viz phase: {delta}")
    print(f"[time] viz phase: {time.perf_counter() - t_viz:.1f} s")


def viz_host_split(frames_dir, end, count=24):
    """The host's share of a streamed frame at 800 x 600: the colorize, the
    PNG encode the frame files take (viz/png.py, zlib level 3, the writer
    thread) and the live viewer's (the native encoder, level 1), a frame
    each over ``count`` of config #5's frames (the colorize over the end
    state's map)."""
    import numpy as np
    import torch
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.viz import native_png, png
    from nbody_tpu_torch.viz.raster import colorize, render_weights
    names = sorted(os.listdir(frames_dir))[-count:]
    rgb = [png_pixels(os.path.join(frames_dir, f)) for f in names]
    cfg = nt.SimConfig(n_bodies=VIZ_N)
    with np.load(end) as z:
        w8 = render_weights(torch.as_tensor(z["pos"]),
                            torch.as_tensor(z["mass"]), cfg.min_mass,
                            cfg.max_mass, cfg.max_view).numpy()
    check(np.array_equal(colorize(w8), rgb[-1]), "viz split: the end map")
    w8 = [w8] * count
    out = {}
    for what, fn, items in (
            ("colorize", colorize, w8),
            ("PNG encode, viz/png.py level 3",
             lambda f: png.encode_png(f, 3), rgb),
            ("PNG encode, native level 1",
             lambda f: native_png.encode_png(f, 1), rgb)):
        t0 = time.perf_counter()
        for x in items:
            fn(x)
        out[what] = (time.perf_counter() - t0) * 1000.0 / len(items)
    print("[viz] the host's ms a frame at 800x600 (config #5's frames): "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))


def avi_chunks(path):
    """(codec fourcc, frame chunk sizes) of an AVI the port wrote."""
    import struct
    with open(path, "rb") as f:
        data = f.read()
    check(data[:4] == b"RIFF" and data[8:12] == b"AVI ", f"{path}: not AVI")
    codec = data[data.index(b"strh") + 12:][:4]     # after "vids"
    cid = b"00dc" if codec == b"MJPG" else b"00db"
    p, sizes = data.index(b"movi") + 4, []
    while data[p:p + 4] == cid:
        (size,) = struct.unpack("<I", data[p + 4:p + 8])
        sizes.append(size)
        p += 8 + size + (size % 2)
    check(data[p:p + 4] == b"idx1", f"{path}: movi does not end at idx1")
    return codec.decode(), sizes


def check_presets(counts):
    """run and validate with each --init preset at full width through the
    CLI with the launch counters, the card's initial state (the maker's,
    from the same seed) held to its contract, every end state finite."""
    import numpy as np
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.cli import main as cli_main
    from nbody_tpu_torch.models.init import INIT_MAKERS
    os.makedirs(WORK, exist_ok=True)
    for name, argv, expect in PRESET_PHASES:
        t0 = time.perf_counter()
        argv = [argv[0], "--init", name, *argv[1:]]
        end = None
        if argv[0] == "run":
            end = os.path.join(WORK, f"preset_{name}.npz")
            argv += ["--checkpoint", end]
        what = " ".join(argv[:-2] if end else argv)
        before = counts()
        rc = cli_main(on_card0(argv))
        check(rc == 0, f"{what}: exit {rc}")
        delta = {k: v - before[k] for k, v in counts().items()}
        print(f"[main path] {what}: launches "
              f"{ {k: v for k, v in delta.items() if v} }")
        for k, v in delta.items():
            want = expect.get(k, 0)
            check(v >= 1 if (k == "resident" and want) else v == want,
                  f"{what}: {k} launched {v} times")
        n = int(argv[argv.index("--n") + 1])
        dt = float(argv[argv.index("--dt") + 1]) if "--dt" in argv else 0.1
        cfg = nt.SimConfig(n_bodies=n, dt=dt)
        preset_contract(
            name, INIT_MAKERS[name](cfg), cfg.eps2, cfg.max_pos)
        if end:
            with np.load(end) as z:
                check(all(np.isfinite(z[k]).all() for k in ("pos", "vel",
                                                             "acc")),
                      f"{what}: non-finite end state")
                print(f"[preset] {what}: end state finite after "
                      f"{int(z['step'])} steps")
        print(f"[time] {what}: {time.perf_counter() - t0:.1f} s")


HUGE_N = 1 << 22
HUGE_FLAT_N = 1 << 24
HUGE_ROWS = 256
# The exact tiers' gate against float64 (TIER_GATES' K7, K11, fold): the
# fraction of components outside 1% with a 1e-4 absolute floor.
HUGE_GATE = 5e-4
# The mesh's energy (parallel/energy.py) in check_huge_n: the 4-shard 4M
# run with --energy takes it past MAX_HOST_ENERGY_N.  Against K8's
# pe_total of the gathered state on the card: the same float32 tile
# partials (the self term in a diagonal tile's partial either way), added
# in other orders and tiles, at check_pe's gate for K8's row-sum total
# against pe_total at 1M.  pe_total's path subtracts the closed-form self
# terms, which at 4M (self terms ~0.75 of the pair sums) moves it by
# ~1e-7 from the sweep's.
MESH_ENERGY_TOL = 2e-6
# At 8192 (seed 5) over P = 1 .. 5 against float64 (pe_total_f64): the
# pair total the sweep implies (self terms included, as pe_total_f64 sums
# them) at check_pe's float64 gate for pe_total.  The energy is what is
# left after the self terms, ~390 times the pair sums there, are taken
# out, so its error is the pair total's over S / |pair sums|: it is held to
# 2^-22 (two float32 ulps) of the self total S, whose float32 tile
# partials carry the pair terms.  On an H100 pe_rows's partials lose
# 1.1e-7 of S there (4.4e-5 of the energy), pe_total's 1.3e-8, the plain
# twin's 3.8e-9; with the self pair masked, float32 rows are 5e-9 off
# (tools/pe_self_bias.py).
MESH_F64_TOL = 1e-5
MESH_SELF_ULPS = 2.0 ** -22
MESH_ENERGY_PS = (1, 2, 3, 4, 5)
# The examples at their defaults (examples/*_torch.py, N and steps).
EXAMPLES = (("demo_torch", ("4096", "200")),
            ("orbit_torch", ("4096", "100000")))


class _Tee:
    """A stdout that also keeps what it is given (the CLI's heartbeat and
    summary lines, read back by check_huge_n)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def huge_cli(counts, what, argv, expect):
    """One CLI call of check_huge_n with the launch counters and its
    standard output kept: returns (its text, seconds).  ``expect``: the
    launches of every kernel in the call (the others must be 0)."""
    from nbody_tpu_torch.cli import main as cli_main
    before = counts()
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = cli_main(on_card0(argv))
    secs = time.perf_counter() - t0
    check(rc == 0, f"{what}: exit {rc}")
    delta = {k: v - before[k] for k, v in counts().items()}
    print(f"[huge] {what}: {secs:.1f} s, launches "
          f"{ {k: v for k, v in delta.items() if v} }")
    for k, v in delta.items():
        check(v == expect.get(k, 0), f"{what}: {k} launched {v} times")
    return "".join(tee.text), secs


def rows_float64(pos, mass, rows, eps2, cols=1 << 22):
    """The accelerations of bodies ``rows`` from every body, float64 on
    the card, in column chunks of ``cols`` bodies: d2 of every (row,
    column) pair by one GEMM of the augmented coordinates [x_i, |x_i|^2,
    1] . [-2 x_j, 1, |x_j|^2 + eps2], the self pair dropped, then
    d2^-1.5 @ [m_j x_j, m_j] and a_i = sum w m x - x_i sum w m."""
    import torch
    xi = pos[rows].double()
    ones = torch.ones_like(xi[:, :1])
    a = torch.cat([xi, (xi * xi).sum(1, keepdim=True), ones], 1)
    acc = torch.zeros_like(xi)
    for s in range(0, pos.shape[0], cols):
        xj, mj = pos[s:s + cols].double(), mass[s:s + cols].double()
        b = torch.cat([-2.0 * xj, torch.ones_like(xj[:, :1]),
                       (xj * xj).sum(1, keepdim=True) + eps2], 1)
        w = (a @ b.T).pow_(-1.5)
        own = ((rows >= s) & (rows < s + xj.shape[0])).nonzero().flatten()
        w[own, rows[own] - s] = 0.0
        mx = torch.cat([mj[:, None] * xj, mj[:, None]], 1)
        part = w @ mx
        acc += part[:, :3] - xi * part[:, 3:]
        del w
    return acc


def check_huge_n(counts, record):
    """Huge N through the CLI with the launch counters: (a) N = 4M under
    auto (K2, bounded: 2 programs an evaluation), one step to a
    checkpoint and a resume of one more with ``--energy`` and a checkpoint
    a step, bit-equal to two steps of ``run_steps`` with the bound off;
    (b) N = 16.7M with the
    flat state and a frame a step: the heartbeat's lines, 256 sampled rows
    of the first evaluation at the exact gate against float64, the frame
    equal to the host's render of the checkpointed end state, s/step and
    peak memory; (c) the 4-shard ring mesh at 4M with ``--prog-cap 2e12``
    bit-equal to the same run without it, its heartbeat shown, and with
    ``--energy`` the mesh's energy (``check_mesh_energy``)."""
    import numpy as np
    import torch
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.ops.forces_sym import sweep_programs
    from nbody_tpu_torch.ops.pe import PE_TILE
    from nbody_tpu_torch.parallel import energy as penergy
    from nbody_tpu_torch.ops.forces_sym_variants import DEFAULT_PROG_CAP
    from nbody_tpu_torch.parallel.mesh import make_mesh
    from nbody_tpu_torch.parallel.multiprog import _ShardedBoundedForces
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    smi = nvidia_smi_line()
    t_all = time.perf_counter()
    os.makedirs(WORK, exist_ok=True)
    path = {k: os.path.join(WORK, f"huge_{k}.npz")
            for k in ("a1", "b1", "flat", "mp", "ring")}
    n = str(HUGE_N)

    # (a) 4M, auto: two bounded programs an evaluation; one step to a
    # checkpoint, then a resume with --energy and a checkpoint a step.
    cfg = nt.SimConfig(n_bodies=HUGE_N)
    check(nt.resolve_impl(cfg) == "pallas_sym2", "auto at 4M is not K2")
    huge_cli(counts, "run --n 4194304 --steps 1 (the step-1 checkpoint)",
             ["run", "--n", n, "--steps", "1", "--checkpoint", path["a1"]],
             {"forces_sym": 1})
    text, secs = huge_cli(
        counts, "run --resume (1 more step) --energy --checkpoint-every 1",
        ["run", "--resume", path["a1"], "--steps", "1", "--energy",
         "--checkpoint-every", "1", "--checkpoint", path["b1"]],
        {"forces_sym": 1, "pe_total": 2})
    print("[huge] 4M: " + [ln for ln in text.splitlines()
                           if ln.startswith("Simulation complete")][0])
    ref = nt.run_steps(nt.init_state(cfg), cfg, 2)
    with np.load(path["b1"]) as z:
        check(int(z["step"]) == 2, "4M resume: checkpoint step")
        for k in ("pos", "vel", "acc"):
            check(np.array_equal(z[k], getattr(ref, k).cpu().numpy()),
                  f"4M bounded and resumed: {k} differs from run_steps "
                  f"unbounded and uninterrupted")
    del ref
    print("[huge] 4M: bounded (2 programs an evaluation) and resumed from "
          "step 1, bit-equal to run_steps unbounded and uninterrupted")

    # (b) 16.7M, flat, a frame a step.
    frames = os.path.join(WORK, "huge_frames")
    shutil.rmtree(frames, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    text, secs = huge_cli(
        counts, "run --n 16777216 --steps 1 --flat-state on --viz",
        ["run", "--n", str(HUGE_FLAT_N), "--steps", "1", "--flat-state",
         "on", "--viz", "--viz-dir", frames, "--viz-every", "1",
         "--checkpoint-every", "1", "--checkpoint", path["flat"]],
        {"forces_sym": 1})
    peak = torch.cuda.max_memory_allocated()
    beats = [ln for ln in text.splitlines() if "force eval:" in ln]
    summary = [ln for ln in text.splitlines()
               if ln.startswith("Simulation complete")][0]
    progs = len(sweep_programs(HUGE_FLAT_N, DEFAULT_PROG_CAP)[1])
    check("(flat)" in text, "16.7M: the run did not take the flat state")
    check(len(beats) >= 2 and beats[-1].strip().startswith(
        f"force eval: {progs}/{progs}"), f"16.7M: heartbeat lines {beats}")
    ms = float(summary.split(", ")[1].split()[0])
    print(f"[huge] 16.7M flat: {len(beats)} heartbeat lines; "
          f"{ms / 1e3:.3f} s/step, "
          f"{float(HUGE_FLAT_N) ** 2 / ms / 1e6:.1f} GInter/s, peak "
          f"{peak / 1e9:.3f} GB allocated (torch.cuda.max_memory_allocated); "
          f"the CLI call {secs:.1f} s ({smi})")
    cfg = nt.SimConfig(n_bodies=HUGE_FLAT_N)
    start = nt.init_state(cfg)
    rows = torch.randperm(HUGE_FLAT_N, generator=torch.Generator()
                          .manual_seed(23))[:HUGE_ROWS].sort()[0].cuda()
    t0 = time.perf_counter()
    want = rows_float64(start.pos, start.mass, rows, cfg.eps2)
    with np.load(path["flat"]) as z:
        check(int(z["step"]) == 1 and z["pos"].shape == (HUGE_FLAT_N, 3),
              "16.7M: checkpoint")
        got = torch.as_tensor(z["acc"][rows.cpu().numpy()])
        end_pos, end_mass = z["pos"], z["mass"]
    p99, frac = gate_numbers(got, want.cpu())
    print(f"[gate] 16.7M first evaluation (K2, {progs} programs), "
          f"{HUGE_ROWS} "
          f"sampled rows vs float64: p99 rel err {p99:.3e}, bad fraction "
          f"at 1% {frac:.3e} (gate {HUGE_GATE}); float64 rows "
          f"{time.perf_counter() - t0:.1f} s")
    check(frac <= HUGE_GATE, f"16.7M rows: bad fraction {frac:.3e}")
    del start, want
    names = sorted(f for f in os.listdir(frames) if f.endswith(".png"))
    check(len(names) == 1, f"16.7M: frames {names}")
    check(np.array_equal(png_pixels(os.path.join(frames, names[0])),
                         host_render(end_pos, end_mass, cfg)),
          "16.7M: the frame differs from the host's render of the end state")
    print("[huge] 16.7M: the frame equals the host's render of the "
          "checkpointed end state")
    del end_pos, end_mass

    # (c) the bounded mesh: 4 shards of this card, a 5e11 share a program,
    # with --energy: past MAX_HOST_ENERGY_N its two energies take the
    # mesh's (parallel/energy.py), 12 programs of 4 K8 row-sum launches.
    mesh_expect = {"forces_sym": 4, "rect_forces_sym_vpu2": 4,
                   "forces_tiled": 4}
    c = HUGE_N // 4
    chunks = penergy._row_chunks(c, PE_TILE, 3e11)
    e_progs = len(penergy.energy_plan(4)) * len(chunks)
    e_launches = 4 * e_progs
    print(f"[mesh energy] 4M on 4 shards: c = {c} rows a shard, "
          f"{len(chunks)} row chunks of {chunks[0][1]}, {e_progs} programs "
          f"and {e_launches} pe_rows launches an energy")
    real, e_secs = penergy.total_energy_sharded, []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        e_secs.append(time.perf_counter() - t0)
        return out
    penergy.total_energy_sharded = timed
    try:
        text, _ = huge_cli(
            counts, "run --shards 4 --n 4194304 --steps 1 --prog-cap 2e12 "
            "--energy",
            ["run", "--shards", "4", "--n", n, "--steps", "1", "--prog-cap",
             "2e12", "--energy", "--checkpoint", path["mp"]],
            {**mesh_expect, "pe": 2 * e_launches})
    finally:
        penergy.total_energy_sharded = real
    check(len(e_secs) == 2, f"mesh energy: {len(e_secs)} sharded calls")
    e_beats = [ln for ln in text.splitlines()
               if "force eval:" in ln and f"/{e_progs} programs" in ln]
    print("[mesh energy] " + "\n[mesh energy] ".join(
        ln.strip() for ln in e_beats))
    check(len(e_beats) == 2 * e_progs and e_beats[-1].strip().startswith(
        f"force eval: {e_progs}/{e_progs}"),
          f"mesh energy: heartbeat lines {e_beats}")
    print(f"[mesh energy] 4M, 4 shards: {e_launches} pe_rows launches an "
          f"energy; "
          + ", ".join(f"{t:.3f} s" for t in e_secs) + f" an energy ({smi}); "
          + [ln for ln in text.splitlines()
             if ln.startswith("Simulation complete")][0])
    progs = _ShardedBoundedForces(nt.SimConfig(n_bodies=HUGE_N),
                                  make_mesh(4, "cuda:0"), "pallas_sym2",
                                  2e12).total_programs
    beats = [ln for ln in text.splitlines()
             if "force eval:" in ln and f"/{progs} programs" in ln]
    check(beats and beats[-1].strip().startswith(
        f"force eval: {progs}/{progs}"),
          f"bounded mesh: heartbeat lines {beats}")
    huge_cli(counts, "run --shards 4 --n 4194304 --steps 1 (the ring)",
             ["run", "--shards", "4", "--n", n, "--steps", "1",
              "--checkpoint", path["ring"]], mesh_expect)
    with np.load(path["mp"]) as za, np.load(path["ring"]) as zb:
        for k in ("pos", "vel", "acc"):
            check(np.array_equal(za[k], zb[k]),
                  f"bounded mesh: {k} differs from the unbounded ring")
    print(f"[huge] 4-shard mesh at 4M: bounded ({len(beats)} heartbeat "
          f"lines, {progs} programs) bit-equal to the unbounded ring")
    state, _, _ = nt.load_checkpoint(path["mp"])
    check_mesh_energy(state, smi, record)
    del state
    for f in path.values():
        if os.path.exists(f):
            os.unlink(f)
    print(f"[time] check_huge_n: {time.perf_counter() - t_all:.1f} s")


def check_mesh_energy(state, smi, record):
    """The mesh's energy on the card beside the paths it is held to: at 4M
    (``state``, the 4-shard run's end state) on 4 shards against K8's
    ``pe_total`` of the gathered state, both timed in the same rounds
    (the order reversed in the second); one ``pe_rows`` launch at the 4M
    shard shape timed; at 8192 (seed 5) on 1 to 5 shards against float64.
    These launches are comparisons, so the counters are put back."""
    import torch
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.models.energy import (kinetic_energy,
                                               total_energy_bounded)
    from nbody_tpu_torch.ops import pe
    from nbody_tpu_torch.parallel import energy as penergy
    from nbody_tpu_torch.parallel.mesh import make_mesh
    from nbody_tpu_torch.utils.timing import time_ms
    saved = pe.pe_rows.launches, pe.pe_total.launches
    eps2 = nt.SimConfig().eps2
    mesh = make_mesh(4, "cuda:0")
    paths = {"sharded": lambda: penergy.total_energy_sharded(state, eps2,
                                                            mesh),
             "gathered pe_total": lambda: total_energy_bounded(state, eps2)}
    secs, vals = {k: [] for k in paths}, {}
    for order in (tuple(paths), tuple(reversed(paths))):
        for k in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e = paths[k]()
            torch.cuda.synchronize()
            secs[k].append(time.perf_counter() - t0)
            check(vals.setdefault(k, e) == e,
                  f"mesh energy: the {k} energy differs from call to call")
    rel = abs(vals["sharded"] - vals["gathered pe_total"]) / abs(
        vals["gathered pe_total"])
    for k in paths:
        print(f"[mesh energy] 4M {k}: {vals[k]:.12e} in "
              + ", ".join(f"{t:.3f}" for t in secs[k]) + f" s ({smi})")
    print(f"[mesh energy] 4M sharded against the gathered pe_total: rel "
          f"{rel:.3e} (gate {MESH_ENERGY_TOL:g})")
    check(rel <= MESH_ENERGY_TOL, "mesh energy: 4M sharded against "
          "pe_total")
    # One program's launch on one shard: its first row chunk against a
    # visiting shard (K8's rows_slices picks the slices as on the path).
    c = state.n // 4
    rows = penergy._row_chunks(c, pe.PE_TILE, 3e11)[0][1]
    pos, mass = state.pos.contiguous(), state.mass.contiguous()
    ms = time_ms(lambda: pe.pe_rows(pos[:rows], mass[:rows], pos[c:2 * c],
                                    mass[c:2 * c], eps2), pos.device,
                 iters=2, warmup=1)
    record["pe"]["ms_4m_shard"] = ms
    record["pe"]["bound_ms_4m_shard"] = bound(
        FLOPS_PE * rows * c, 16 * rows + 16 * c + 8 * rows)[0]
    print(f"[mesh energy] K8 pe_rows at the 4M shard shape ({rows} rows x "
          f"{c} bodies): {ms:.3f} ms a launch, bound "
          f"{record['pe']['bound_ms_4m_shard']:.3f} ms ({smi})")

    # The self term the sweep subtracts is K8's own: one body's row sum
    # against itself, rsqrt(float32 eps2), bit for bit.
    one = torch.ones(1, device=pos.device)
    zero = torch.zeros(1, 3, device=pos.device)
    r_self = torch.rsqrt(torch.tensor(eps2, dtype=torch.float32,
                                      device=pos.device))
    check(float(pe.pe_rows(zero, one, zero, one, eps2)) == float(r_self),
          "K8's self term differs from torch.rsqrt(float32(eps2))")
    print(f"[mesh energy] K8's self term rsqrt(float32(eps2)) = "
          f"{float(r_self)!r} = torch.rsqrt's on the card; 1/sqrt(eps2) = "
          f"{1 / eps2 ** 0.5!r}")

    s8 = nt.init_state(nt.SimConfig(n_bodies=8192, seed=5))
    pair64 = pe_total_f64(s8.pos, s8.mass, eps2)
    ke = float(kinetic_energy(s8.vel.double(), s8.mass.double()))
    self_total = float(torch.sum(s8.mass.double() ** 2)) / eps2 ** 0.5
    e64 = ke - 0.5 * (pair64 - self_total)
    e_tol = MESH_SELF_ULPS * self_total / abs(pair64 - self_total)
    for p in MESH_ENERGY_PS:
        e = penergy.total_energy_sharded(s8, eps2, make_mesh(p, "cuda:0"))
        pair = 2.0 * (ke - e) + self_total
        rp, re = abs(pair - pair64) / abs(pair64), abs(e - e64) / abs(e64)
        print(f"[mesh energy] 8192, seed 5, {p} shards, against float64: "
              f"pair total rel {rp:.3e} (gate {MESH_F64_TOL:g}), energy rel "
              f"{re:.3e} (gate 2^-22 x S / |pair sums| = {e_tol:.3e})")
        check(rp <= MESH_F64_TOL and re <= e_tol,
              f"mesh energy at 8192 on {p} shards against float64")
    pe.pe_rows.launches, pe.pe_total.launches = saved


def check_examples(counts):
    """The examples (``examples/*_torch.py``) through their ``main`` on
    the card, each in the work directory, timed; each must exit 0."""
    import importlib.util
    t_all = time.perf_counter()
    for name, argv in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        before = counts()
        t0 = time.perf_counter()
        with contextlib.chdir(WORK):
            rc = mod.main([*argv, "cuda"])
        secs = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in counts().items() if
                 v != before[k]}
        print(f"[examples] {name} {' '.join(argv)}: exit {rc}, {secs:.1f} "
              f"s, launches {delta}")
        check(rc == 0, f"examples/{name}.py: exit {rc}")
    print(f"[time] check_examples: {time.perf_counter() - t_all:.1f} s")


def share_oracle_runs(seconds=None):
    """validate's oracles are pure functions of their inputs and take ~50 s
    (numpy, 10 steps) or minutes (native, serial on the card's host, 1000
    steps) a run at N = 8192: the phases that start from one state (the
    validate phases at seed 5; each route of ``--long-horizon``) share
    each distinct run of either oracle, computed once, keyed by a hash of
    its arrays and its other arguments, each caller handed its own copy.
    The (name, seconds) of every run computed are appended to ``seconds``
    where it is a list.  Returns a function that puts the unshared oracles
    back."""
    import hashlib
    import numpy as np
    from nbody_tpu_torch.oracle import native, numpy_oracle
    runs, undo = {}, []

    def share(module, name):
        run = getattr(module, name)

        def shared(pos, vel, mass, *args, **kw):
            h = hashlib.sha256()
            for a in (pos, vel, mass):
                h.update(np.ascontiguousarray(a).tobytes())
            key = (name, h.hexdigest(), args, tuple(sorted(kw.items())))
            if key not in runs:
                t0 = time.perf_counter()
                runs[key] = run(pos, vel, mass, *args, **kw)
                if seconds is not None:
                    seconds.append((name, time.perf_counter() - t0))
            return tuple(a.copy() for a in runs[key])
        setattr(module, name, shared)
        undo.append(lambda: setattr(module, name, run))

    share(numpy_oracle, "oracle_run")
    share(native, "native_run")
    return lambda: [u() for u in undo]


# Config #2's long-horizon gate (``--long-horizon EPS2``): validate's own
# long phase, 1000 steps at N = 8192 from validate's defaults (seed 0, dt
# 0.1), one call a route, against one native float64 oracle run shared by
# every route.  A route: (label, the CLI verb and its options, the counter
# that must launch, its launches, the lock-step allowance (a kernel of
# TIER_GATES, the gate of a tier's fraction, or None for validate's)).
# ``evals`` counts a validate's force evaluations: 10 lock-step steps and
# the long phase's.  validate steps with ``run_steps`` in both packages,
# so K3 and K4 are reached through ``run`` (auto in the resident window),
# their end state held to the per-step K2 run's bit for bit: their drifts
# are then the numbers of the per-step K2 route (LONG_K2), which runs
# before them.
LONG_N = 8192
LONG_STEPS = 1000
LONG_EPS2_GATED = 1e7
LONG_KNAMES = {"forces_tiled": "K1", "forces_tiled_kahan": "K11",
               "forces_fast": "K12", "forces_tiled_turbo": "K9",
               "forces_tiled_mxu": "K10", "forces_sym_vpu": "K7",
               "forces_sym_turbo": "K5", "forces_sym_mxu": "K6",
               "forces_sym_turbo2": "K14a"}
LONG_K2 = "--resident off pallas_sym2 (K2)"


def long_routes(integrator):
    """The routes of ``--long-horizon`` for ``integrator``: (label, argv,
    {kernel: launches}, lock-step allowance)."""
    evals = 10 + LONG_STEPS
    k2 = (LONG_K2, ["validate", "--resident", "off", "--impl", "pallas_sym2"])
    if integrator == "kdk":
        # A KDK prime, then one evaluation a step.
        return ((*k2, {"forces_sym": 1 + evals}, None),
                ("auto (K4 resident)", ["run"],
                 {"resident_kdk": None, "forces_sym": 1}, None),
                ("--shards 4 --comm rdma (K13)",
                 ["validate", "--shards", "4", "--comm", "rdma"],
                 {"rdma_ring": 1 + evals}, None),
                ("xla (the plain path)", ["validate", "--impl", "xla"], {},
                 None))
    routes = [(*k2, {"forces_sym": evals}, None),
              ("auto (K3 resident)", ["run"], {"resident": None}, None)]
    for impl, kernel, allow in (
            ("pallas", "forces_tiled", None),
            ("pallas_kahan", "forces_tiled_kahan", None),
            ("pallas_fast", "forces_fast", MESH_FAST_FRAC),
            ("pallas_turbo", "forces_tiled_turbo", None),
            ("pallas_mxu", "forces_tiled_mxu", None),
            ("pallas_sym", "forces_sym_vpu", None),
            ("pallas_sym_turbo", "forces_sym_turbo", None),
            ("pallas_sym_mxu", "forces_sym_mxu", None),
            ("pallas_sym_turbo2", "forces_sym_turbo2", None)):
        if allow is None and kernel in TIER_IMPLS:
            allow = TIER_GATES[kernel][1]
        routes.append((f"{impl} ({LONG_KNAMES[kernel]})",
                       ["validate", "--impl", impl], {kernel: evals}, allow))
    routes += [("--shards 4 --comm ring pallas_sym2 (K2, K2-rect, K1)",
                ["validate", "--shards", "4", "--comm", "ring", "--impl",
                 "pallas_sym2"],
                {"forces_sym": 4 * evals, "rect_forces_sym_vpu2": 4 * evals,
                 "forces_tiled": 4 * evals}, None),
               ("--shards 4 --comm rdma (K13)",
                ["validate", "--shards", "4", "--comm", "rdma"],
                {"rdma_ring": evals}, None),
               ("xla (the plain path)", ["validate", "--impl", "xla"], {},
                None)]
    return tuple(routes)


_LONG_LINES = {
    "chaos": re.compile(r"oracle self-conservation \|dE\|/\|E0\| = (\S+)"),
    "drift": re.compile(r"energy: device vs oracle drift (\S+)"),
    "p": re.compile(r"momentum: \|P-P0\|_max/scale = (\S+)"),
    "l": re.compile(r"angular momentum: \|L-L0\|_max/scale = (\S+)"),
}


def long_horizon(eps2, integrator, counts, smi):
    """``--long-horizon EPS2``: every route of ``long_routes`` through
    the CLI, each route's line (the oracle's self-conservation and whether
    it is well-posed, the device-vs-oracle energy drift with its verdict,
    |P - P0| and |L - L0|, the launches, the seconds).  At eps2 =
    ``LONG_EPS2_GATED`` every verdict of a route is gated: validate's exit
    code 0 (the lock-step phase, both invariants, the energy where the
    oracle is well-posed), and the device-vs-oracle energy drift within
    the gate whether or not validate calls the oracle well-posed (K3/K4:
    their end state bit-equal to LONG_K2's, whose numbers they report); at
    another eps2 the energy drift
    is gated where the oracle is well-posed and the rest is reported.
    Any failure raises.  Returns the routes' numbers."""
    import torch
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.cli import main as cli_main
    gate, inv_gate = 1e-3, 1e-3
    gated = eps2 == LONG_EPS2_GATED
    base = ["--n", str(LONG_N), "--eps2", repr(eps2), "--integrator",
            integrator]
    from nbody_tpu_torch.ops.step import prime_kdk
    cfg = nt.SimConfig(n_bodies=LONG_N, eps2=eps2, integrator=integrator)
    state0 = nt.init_state(cfg)
    out, numbers = [], {}
    os.makedirs(WORK, exist_ok=True)
    for label, argv, expect, allow in long_routes(integrator):
        verb, opts = argv[0], argv[1:]
        before = counts()
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        if verb == "validate":
            extra = ["--long-steps", str(LONG_STEPS), "--oracle", "native"]
            if allow is not None:
                extra += ["--max-bad-frac", str(allow),
                          "--max-bad-frac-acc", str(max(allow, 5e-4))]
            with contextlib.redirect_stdout(tee):
                rc = cli_main(on_card0(["validate", *base, *opts, *extra]))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            text = "".join(tee.text)
            found = {k: rx.search(text) for k, rx in _LONG_LINES.items()}
            check(all(found.values()),
                  f"long {label}: validate printed no long-phase line "
                  f"(exit {rc})")
            nums = {k: float(m.group(1)) for k, m in found.items()}
        else:
            end_path = os.path.join(WORK, "long_end.npz")
            with contextlib.redirect_stdout(tee):
                rc = cli_main(on_card0(["run", *base, "--steps",
                                        str(LONG_STEPS), "--checkpoint",
                                        end_path]))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            end, step, _ = nt.load_checkpoint(end_path, device="cuda")
            check(step == LONG_STEPS and rc == 0,
                  f"long {label}: run exit {rc}, checkpoint step {step}")
            nums = dict(numbers[LONG_K2])
        numbers[label] = nums
        delta = {k: v - before[k] for k, v in counts().items()}
        for k, v in delta.items():
            want = expect.get(k, 0)
            check(v > 0 if want is None else v == want,
                  f"long {label}: {k} launched {v} times (want "
                  f"{'some' if want is None else want})")
        if verb == "run":
            # K3/K4's end state: bit-equal to the per-step K2 run, so
            # LONG_K2's numbers are its own.
            ref = nt.run_steps(
                prime_kdk(state0, cfg, impl="pallas_sym2")
                if integrator != "reference" else state0, cfg, LONG_STEPS,
                impl="pallas_sym2")
            check(states_equal(end, ref),
                  f"long {label}: end state differs from per-step K2's")
        well = nums["chaos"] <= gate
        e_ok = nums["drift"] <= gate
        e_gated = gated or well
        p_ok, l_ok = nums["p"] <= inv_gate, nums["l"] <= inv_gate
        launched = {k: v for k, v in delta.items() if v}
        print(f"[long] eps2={eps2:g} {integrator} {label}: oracle "
              f"|dE|/|E0| {nums['chaos']:.3e} "
              f"({'well-posed' if well else 'chaos-dominated'}); device vs "
              f"oracle {nums['drift']:.3e} "
              + (("OK" if e_ok else "FAIL") if e_gated else "not gated")
              + f" (gate {gate:.0e}); |P-P0| {nums['p']:.3e} "
              f"{'OK' if p_ok else 'over'}, |L-L0| {nums['l']:.3e} "
              f"{'OK' if l_ok else 'over'} (gate {inv_gate:.0e}); exit {rc}; "
              f"launches {launched}; {secs:.1f} s"
              + (f"; the numbers of {LONG_K2}, its end state bit-equal"
                 if verb == "run" else "") + f" ({smi})")
        if gated:
            check(rc == 0 and e_ok and p_ok and l_ok,
                  f"long {label} at eps2={eps2:g}: a gate failed")
        elif well:
            check(e_ok, f"long {label} at eps2={eps2:g}: energy drift "
                  f"{nums['drift']:.3e} past the gate on a well-posed run")
        out.append({"route": label, "secs": secs, "rc": rc,
                    "launches": launched, "well_posed": bool(well),
                    **{k: float(v) for k, v in nums.items()}})
    if gated and integrator == "reference":
        k1 = [r for r in out if r["route"].startswith("pallas (K1)")][0]
        check(k1["drift"] <= gate, "pallas (K1) drift past 1e-3 at eps2=1e7")
    return out


def main_path(counts, reset, record):
    """The CLI's main paths with the launch counters: validate at N = 8192
    (K1, K2, K7, K11, and the tensor-core tiers K9, K10, K5, K6, K14a), the
    entry point ``forces_pallas_sym`` at N = 8192 (K14b, K14c, K14d), the
    run verb (K3, K4, auto, K8 at 1M, K5 and K14a at 1M, K12 with
    --sort-every at 8192 and 1M, resume), the closed-form gates and the
    presets.  Returns the launches of every kernel over all of them."""
    import numpy as np
    from nbody_tpu_torch.cli import main as cli_main

    def phase(what, argv, expect=None):
        before = counts()
        rc = cli_main(on_card0(argv))
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
    # The same rows against the plain version at the main path's shape (two
    # row blocks: pe.rows_slices's plan for it, not 8192 x 8192's).
    compare("K8 pe_rows 1024 x 8192 (the main path's) vs plain", rows,
            pe.pe_rows_plain(state.pos[:1024].contiguous(),
                             state.mass[:1024].contiguous(), state.pos,
                             state.mass, cfg.eps2))

    # The sharded path: validate through the mesh at N = 8192 (P = 4:
    # the self shards, one cross rotation through K2-rect, the antipodal
    # rotation through K1; P = 3: the self shards and one cross rotation;
    # P = 2 with the all-gather: K1 only; pallas_mxu on 4 shards, the
    # one-sided ring: K10's rect form on each of the P rotations, masked at
    # the first (each shard's own) and disjoint after it; pallas_turbo on 2
    # shards with the all-gather: K9's masked rect form), 10 steps of P
    # shards each.  Launches per run: P x 10 of each kernel of the schedule,
    # P x P x 10 for the one-sided ring.  A tier's name after the comm
    # options gives validate the tier's allowances.
    for shards, impl, extra, expect in (
            (4, "pallas_sym2", [], {"forces_sym": 40,
                                    "rect_forces_sym_vpu2": 40,
                                    "forces_tiled": 40}),
            (3, "pallas_sym_turbo2", ["forces_sym_turbo2"],
             {"forces_sym_turbo2": 30, "rect_forces_sym_turbo2": 30}),
            (3, "pallas_sym", [], {"forces_sym_vpu": 30,
                                   "rect_forces_sym_vpu": 30}),
            (3, "pallas_sym_turbo", ["forces_sym_turbo"],
             {"forces_sym_turbo": 30, "rect_forces_sym_turbo": 30}),
            (3, "pallas_sym_mxu", ["forces_sym_mxu"],
             {"forces_sym_mxu": 30, "rect_forces_sym_mxu": 30}),
            (2, "pallas", ["--comm", "allgather"], {"forces_tiled": 20}),
            (4, "pallas_mxu", ["forces_tiled_mxu"],
             {"forces_tiled_mxu": 160}),
            (2, "pallas_turbo", ["--comm", "allgather", "forces_tiled_turbo"],
             {"forces_tiled_turbo": 20})):
        if extra and extra[-1] in TIER_GATES:
            frac = str(TIER_GATES[extra[-1]][1])
            extra = extra[:-1] + ["--max-bad-frac", frac,
                                  "--max-bad-frac-acc", frac]
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
    # The closed-form gates through every impl, and the --init presets.
    check_kepler(counts)
    check_presets(counts)
    check_viz(counts)
    check_huge_n(counts, record)
    check_examples(counts)
    probe_scripts(counts)
    launches = counts()
    print(f"[main path] launch counts: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path did not launch: {launches}")
    return launches


# The mesh across cards (check_cross_card, ``--cross-card``).  Every (impl,
# comm) pair that ``run_steps_sharded`` takes on a card: the one-sided
# family and the pair-symmetric ladder through the ring and the all-gather
# (parallel/ring.py: _RECT_VARIANTS; the ladder's ring is the N3L ring,
# _SYM_VARIANTS), and K13's two families under both rdma comms
# (_SYM_VARIANTS, parallel/rdma_ring.py: _RDMA_ONE_SIDED).
# tests/test_torch_cross_card.py holds these tuples to the port's tables.
CROSS_N = 8192
CROSS_SEED = 5
CROSS_STEPS = 3
CROSS_ONE_SIDED = ("pallas", "pallas_kahan", "pallas_fast", "pallas_mxu",
                   "pallas_turbo")
CROSS_SYM = ("pallas_sym", "pallas_sym2", "pallas_sym_turbo",
             "pallas_sym_mxu", "pallas_sym_turbo2")
CROSS_RDMA = ("pallas", "pallas_turbo", *CROSS_SYM)
CROSS_PAIRS = (*((impl, comm) for comm in ("ring", "allgather")
                 for impl in CROSS_ONE_SIDED + CROSS_SYM),
               *((impl, comm) for comm in ("rdma", "rdma_overlap")
                 for impl in CROSS_RDMA))
# Each impl's gate on its first evaluation against float64 (p99 of the
# relative error or None, the largest fraction of components outside 1%):
# validate's allowances, --max-bad-frac-acc's default for the exact tiers,
# the tier's own for the tensor-core tiers (TIER_GATES).  K12's tier gate
# (1e-3) holds for Morton-sorted bodies, and the mesh does not sort: on
# the box of seed 5 it put 1.099e-3 of the components outside (P = 4,
# the ring, an H100), so the mesh's K12 is held at the JAX package's gate
# for its fast tier on the ring, on unsorted bodies (tests/test_ring.py,
# test_sharded_masked_variants_interpret: 2e-3 outside 1% + 1e-4).
VALIDATE_ACC_FRAC = 5e-4
MESH_FAST_FRAC = 2e-3
CROSS_GATES = {"pallas": (None, VALIDATE_ACC_FRAC),
               "pallas_sym2": (None, VALIDATE_ACC_FRAC),
               "pallas_sym": TIER_GATES["forces_sym_vpu"],
               "pallas_kahan": TIER_GATES["forces_tiled_kahan"],
               "pallas_fast": (None, MESH_FAST_FRAC),
               **{impl: TIER_GATES[k] for k, impl in TIER_IMPLS.items()}}
# The KDK-composed integrators, primed on the mesh: (integrator, impl,
# comm).
CROSS_INTEGRATORS = (("kdk", "pallas_sym2", "ring"),
                     ("yoshida4", "pallas_sym2", "ring"),
                     ("kdk", "pallas_sym_turbo2", "ring"),
                     ("yoshida4", "pallas_sym_turbo2", "ring"),
                     ("kdk", "pallas_sym2", "rdma"),
                     ("yoshida4", "pallas_sym2", "rdma"))
# The bounded mesh (parallel/multiprog.py) takes the pair-symmetric ladder.
CROSS_BOUNDED = CROSS_SYM
CROSS_PROG_CAP = 4e6
# Config #4's N on four cards: one step of each (impl, comm) against the
# same step on cuda:0 and the impl's one-card step.
CROSS_4M_N = 1 << 22
CROSS_4M = (("pallas_sym2", "ring"), ("pallas_sym2", "rdma"),
            ("pallas_sym", "ring"), ("pallas_sym_turbo", "ring"),
            ("pallas_sym_mxu", "ring"), ("pallas_sym_turbo2", "ring"),
            ("pallas_sym_turbo2", "rdma"))
# run --shards 4 through Simulation on a tensor-core tier.
CROSS_CLI_IMPL = "pallas_sym_turbo2"


def smi_by_card():
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``,
    one line a card (none without nvidia-smi)."""
    if shutil.which("nvidia-smi") is None:
        return []
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    return [line.strip() for line in proc.stdout.splitlines()
            if line.strip()]


def sync_cards():
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def check_cross_card(counts, record, smi):
    """The mesh across the host's cards, where it has two or more: the
    placement and peer-access lines; at N = 8192 (seed 5) on P = the card
    count shards (and 5 on four cards), every (impl, comm) pair of
    ``CROSS_PAIRS`` for 3 steps against the same run pinned to cuda:0 bit
    for bit, with each card's kernel launches (every card must launch),
    and its first evaluation at its tier's float64 gate; kdk and yoshida4
    primed on the mesh (``CROSS_INTEGRATORS``), the bounded mesh on every
    tier of the ladder (against cuda:0's and the unbounded ring), and
    ``validate --shards P --comm ...`` across the cards; then
    ``cross_card_cli`` and ``cross_card_4m``.  On one card it prints the
    skip line."""
    import dataclasses
    import torch
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.cli import main as cli_main
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    from nbody_tpu_torch.parallel.mesh import make_mesh
    from nbody_tpu_torch.parallel.multiprog import run_steps_sharded_multiprog
    from nbody_tpu_torch.parallel.rdma_ring import check_errors
    from nbody_tpu_torch.parallel.ring import (prime_kdk_sharded,
                                               run_steps_sharded)
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[cross-card] skipped: {cards} card")
        return
    t0 = time.perf_counter()
    names = [torch.cuda.get_device_name(i) for i in range(cards)]
    print(f"[cross-card] {cards} cards: {names}")
    lines = smi_by_card()
    for i, line in enumerate(lines):
        print(f"[cross-card] nvidia-smi name, power.limit, card {i}: {line}")
    if lines:
        smi = f"{'; '.join(dict.fromkeys(lines))}: each of {len(lines)} cards"
    for a in range(cards):
        print(f"[cross-card] peer access from card {a}: " + ", ".join(
            f"{b}: {torch.cuda.can_device_access_peer(a, b)}"
            for b in range(cards) if b != a))
    shard_counts = sorted({cards, 5} if cards == 4 else {cards})

    def per_card(before):
        return {i: _build.DEVICE_LAUNCHES[i] - before.get(i, 0)
                for i in range(cards)}

    def equal(a, b):
        return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))

    def on_every_card(what, launches):
        check(all(launches[i] > 0 for i in range(min(cards, p))),
              f"{what}: a card launched nothing: {launches}")

    cfg = nt.SimConfig(n_bodies=CROSS_N, seed=CROSS_SEED, device="cuda")
    start = nt.init_state(cfg)
    ref = rect_forces(start.pos.double(), start.pos.double(),
                      start.mass.double(), cfg.eps2)
    res = {"pairs": 0}
    for p in shard_counts:
        mesh, mesh0 = make_mesh(p, "cuda"), make_mesh(p, "cuda:0")
        print(f"[cross-card] {mesh.describe()}")
        for impl, comm in CROSS_PAIRS:
            what = f"{CROSS_N}, P={p}, {impl} --comm {comm}"
            before = dict(_build.DEVICE_LAUNCHES)
            got = run_steps_sharded(start, cfg, mesh, CROSS_STEPS, impl,
                                    comm)
            launches = per_card(before)
            want = run_steps_sharded(start, cfg, mesh0, CROSS_STEPS, impl,
                                     comm)
            check(equal(got, want), f"cross-card {what}: differs from the "
                  f"same run on cuda:0")
            on_every_card(what, launches)
            first = prime_kdk_sharded(start, cfg, mesh, impl, comm).acc
            p99, frac = gate_numbers(first, ref)
            p99_gate, frac_gate = CROSS_GATES[impl]
            check(p99_gate is None or p99 < p99_gate,
                  f"cross-card {what}: p99 {p99:.3e} against float64")
            check(frac <= frac_gate, f"cross-card {what}: bad fraction "
                  f"{frac:.3e} against float64")
            res["pairs"] += 1
            print(f"[cross-card] {what}: {CROSS_STEPS} steps bit-equal to "
                  f"cuda:0's; launches by card {launches}; the first "
                  f"evaluation against float64: p99 rel err {p99:.3e} (gate "
                  f"{p99_gate}), bad fraction at 1% {frac:.3e} (gate "
                  f"{frac_gate})")
        check_errors()
        for integrator, impl, comm in CROSS_INTEGRATORS:
            icfg = dataclasses.replace(cfg, integrator=integrator)
            before = dict(_build.DEVICE_LAUNCHES)
            got = run_steps_sharded(
                prime_kdk_sharded(start, icfg, mesh, impl, comm), icfg, mesh,
                2, impl, comm)
            launches = per_card(before)
            want = run_steps_sharded(
                prime_kdk_sharded(start, icfg, mesh0, impl, comm), icfg,
                mesh0, 2, impl, comm)
            what = f"{CROSS_N}, P={p}, {integrator} {impl} --comm {comm}"
            check(equal(got, want), f"cross-card {what}: differs from "
                  f"cuda:0's")
            on_every_card(what, launches)
            print(f"[cross-card] {what}: primed on the mesh, 2 steps "
                  f"bit-equal to cuda:0's; launches by card {launches}")
        for impl in CROSS_BOUNDED:
            before = dict(_build.DEVICE_LAUNCHES)
            got = run_steps_sharded_multiprog(
                start, cfg, mesh, 2, impl,
                max_prog_interactions=CROSS_PROG_CAP)
            launches = per_card(before)
            want = run_steps_sharded_multiprog(
                start, cfg, mesh0, 2, impl,
                max_prog_interactions=CROSS_PROG_CAP)
            what = f"{CROSS_N}, P={p}, the bounded mesh, {impl}"
            check(equal(got, want), f"cross-card {what}: differs from "
                  f"cuda:0's")
            check(equal(got, run_steps_sharded(start, cfg, mesh, 2, impl,
                                               "ring")),
                  f"cross-card {what}: differs from the unbounded ring")
            on_every_card(what, launches)
            print(f"[cross-card] {what} ({CROSS_PROG_CAP:g} a program): "
                  f"2 steps bit-equal to cuda:0's and to the unbounded "
                  f"ring; launches by card {launches}")
        check_errors()
        for comm in ("ring", "allgather", "rdma", "rdma_overlap"):
            before = dict(_build.DEVICE_LAUNCHES)
            argv = ["validate", "--n", str(CROSS_N), "--seed",
                    str(CROSS_SEED), "--long-steps", "0", "--shards", str(p),
                    "--comm", comm]
            rc = cli_main(argv)   # not on_card0: across the cards
            check(rc == 0, f"cross-card validate P={p} --comm {comm}: exit "
                  f"{rc}")
            print(f"[cross-card] validate --shards {p} --comm {comm}: "
                  f"launches by card {per_card(before)}")
    check_errors()
    print(f"[time] cross-card at {CROSS_N}: {time.perf_counter() - t0:.1f} "
          f"s")
    cross_card_cli(cards, per_card)
    res.update(cross_card_4m(cards, per_card, equal, smi))
    record["rdma_ring"]["cross_card"] = {"cards": cards, **res}
    print(f"[time] cross-card phases: {time.perf_counter() - t0:.1f} s")


def cross_card_cli(cards, per_card):
    """``run --shards 4`` through ``Simulation`` on a tensor-core tier
    across the cards: --energy, --checkpoint, --viz every 2 steps, against
    the same run on cuda:0 (checkpoint and frames bit for bit), and 2 steps
    checkpointed then resumed for 2 more across the cards, against the
    uninterrupted 4."""
    import numpy as np
    from nbody_tpu_torch.cli import main as cli_main
    from nbody_tpu_torch.ops import _build
    t0 = time.perf_counter()
    work = os.path.join(WORK, "cross")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    base = ["--n", str(CROSS_N), "--seed", str(CROSS_SEED), "--shards", "4",
            "--impl", CROSS_CLI_IMPL, "--energy"]

    def run(tag, argv):
        before = dict(_build.DEVICE_LAUNCHES)
        rc = cli_main(["run", *argv])
        check(rc == 0, f"cross-card run {tag}: exit {rc}")
        launches = per_card(before)
        print(f"[cross-card] run {' '.join(argv)}: launches by card "
              f"{launches}")
        return launches

    def ck(tag):
        return os.path.join(work, f"{tag}.npz")

    def frames(tag):
        return os.path.join(work, f"frames_{tag}")

    for tag, extra in (("cards", []), ("card0", ["--device", "cuda:0"])):
        launches = run(tag, [*base, "--steps", "4", "--checkpoint", ck(tag),
                             "--viz", "--viz-every", "2", "--viz-dir",
                             frames(tag), *extra])
        if tag == "cards":
            check(all(launches[i] > 0 for i in range(min(cards, 4))),
                  f"cross-card run: a card launched nothing: {launches}")
    run("half", [*base, "--steps", "2", "--checkpoint", ck("half")])
    run("resumed", ["--resume", ck("half"), "--steps", "2", "--shards", "4",
                    "--energy", "--checkpoint", ck("resumed")])
    a, b, r = (np.load(ck(t)) for t in ("cards", "card0", "resumed"))
    for k in ("pos", "vel", "acc"):
        check(np.array_equal(a[k], b[k]), f"cross-card run: {k} differs "
              f"from cuda:0's")
        check(np.array_equal(a[k], r[k]), f"cross-card run: the resumed "
              f"{k} differs from the uninterrupted run's")
    names = sorted(os.listdir(frames("cards")))
    check(len(names) == 2 and names == sorted(os.listdir(frames("card0"))),
          f"cross-card run: frames {names}")
    for name in names:
        check(np.array_equal(png_pixels(os.path.join(frames("cards"), name)),
                             png_pixels(os.path.join(frames("card0"),
                                                     name))),
              f"cross-card run: frame {name} differs from cuda:0's")
    print(f"[cross-card] run --shards 4 --impl {CROSS_CLI_IMPL} --energy "
          f"--viz across the cards: the checkpoint and {len(names)} frames "
          f"equal to cuda:0's; 2 steps resumed from a step-2 checkpoint "
          f"equal to the uninterrupted 4 ({time.perf_counter() - t0:.1f} s)")


def cross_card_4m(cards, per_card, equal, smi):
    """Config #4's N on the host's cards (the JAX package's config is 8
    devices; this is the port on ``cards`` cards): for each (impl, comm)
    of ``CROSS_4M`` one step across the cards (after an untimed one)
    against the same step on cuda:0 bit for bit, with s/step, the
    efficiency against the impl's one-card step and every card's peak
    memory (after a reset on each);
    the mesh's energy and a sharded frame against cuda:0's, and ``run
    --shards P --n 4194304 --energy`` through the ring and K13."""
    import torch
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.cli import main as cli_main
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops.step import run_steps
    from nbody_tpu_torch.parallel import energy as penergy
    from nbody_tpu_torch.parallel.mesh import make_mesh
    from nbody_tpu_torch.parallel.rdma_ring import check_errors
    from nbody_tpu_torch.parallel.ring import (render_weights_sharded,
                                               run_steps_sharded)
    p = min(cards, 4)
    cfg = nt.SimConfig(n_bodies=CROSS_4M_N, device="cuda")
    state = nt.init_state(cfg)
    mesh, mesh0 = make_mesh(p, "cuda"), make_mesh(p, "cuda:0")
    print(f"[cross-card] {mesh.describe()}")

    def timed(fn):
        sync_cards()
        t = time.perf_counter()
        out = fn()
        sync_cards()
        return out, time.perf_counter() - t

    res, single = {}, {}
    for impl, comm in CROSS_4M:
        if impl not in single:
            single[impl] = timed(lambda: run_steps(state, cfg, 1, impl))[1]
        # Untimed: each card's first buffers at this shape.
        run_steps_sharded(state, cfg, mesh, 1, impl, comm)
        for i in range(cards):
            torch.cuda.reset_peak_memory_stats(i)
        before = dict(_build.DEVICE_LAUNCHES)
        got, secs = timed(lambda: run_steps_sharded(state, cfg, mesh, 1, impl,
                                                    comm))
        launches = per_card(before)
        peak = [torch.cuda.max_memory_allocated(i) / 1e9
                for i in range(cards)]
        want, secs0 = timed(lambda: run_steps_sharded(state, cfg, mesh0, 1,
                                                      impl, comm))
        check(equal(got, want), f"cross-card 4M {impl} --comm {comm}: "
              f"differs from cuda:0")
        del got, want
        eff = single[impl] / (p * secs)
        res[f"{impl} {comm}"] = {
            "s_step": secs, "s_step_card0": secs0,
            "s_step_one_card": single[impl], "efficiency": eff,
            "peak_gb_by_card": peak, "launches_by_card": launches}
        print(f"[cross-card] 4M on {p} cards, {impl} --comm {comm}: "
              f"{secs:.4f} s a step (the same step on cuda:0 alone "
              f"{secs0:.4f} s), bit-equal; {impl} on one card "
              f"{single[impl]:.4f} s, efficiency {eff:.3f}; peak memory by "
              f"card {', '.join(f'{g:.3f}' for g in peak)} GB; launches by "
              f"card {launches} ({smi})")
        check_errors()
    before = dict(_build.DEVICE_LAUNCHES)
    e, e_s = timed(lambda: penergy.total_energy_sharded(state, cfg.eps2,
                                                        mesh))
    e_launches = per_card(before)
    e0, e0_s = timed(lambda: penergy.total_energy_sharded(state, cfg.eps2,
                                                          mesh0))
    check(e == e0, f"cross-card 4M energy {e!r} != cuda:0's {e0!r}")
    frame = render_weights_sharded(state, cfg, mesh)
    check(torch.equal(frame, render_weights_sharded(state, cfg, mesh0)),
          "cross-card 4M frame differs from cuda:0's")
    print(f"[cross-card] 4M energy on {p} cards: {e_s:.4f} s (cuda:0 alone "
          f"{e0_s:.4f} s), equal; pe_rows launches by card {e_launches}; "
          f"the sharded frame equal to cuda:0's")
    res["energy_s"] = e_s
    for comm in ("ring", "rdma"):
        before = dict(_build.DEVICE_LAUNCHES)
        t = time.perf_counter()
        rc = cli_main(["run", "--shards", str(p), "--n", str(CROSS_4M_N),
                       "--steps", "2", "--energy", "--comm", comm])
        check(rc == 0, f"cross-card run 4M --comm {comm}: exit {rc}")
        print(f"[cross-card] run --shards {p} --n 4194304 --steps 2 --energy "
              f"--comm {comm}: {time.perf_counter() - t:.1f} s; launches by "
              f"card {per_card(before)}")
    check_errors()
    return res


def ring_1m(dev, smi, record):
    """One N3L-ring step at N = RING_N on 4 shards of this card and one
    K13 step (``--comm rdma``) against the single-device K2 step, in rounds
    of K2, ring, K13, K13, ring, K2 (one card moves no bytes between
    shards: the rings' extra time is their schedules), and the ring's parts
    at the shard shape: K2 on one 262,144-body shard, K2-rect vpu2 on one
    262,144 x 262,144 rotation and K1 on one antipodal sweep; K13's phases
    by partial launches."""
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
    mesh = make_mesh(p, "cuda:0")
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
    order = [("single", one), ("ring", ring_step), ("rdma", rdma_step)]
    order += order[::-1]
    turns = {k: [] for k, _ in order}
    for _ in range(RING_ROUNDS):
        for k, f in order:
            turns[k].append(time_ms(f, dev, iters=1, warmup=0))
    single, ring, rdma = turns["single"], turns["ring"], turns["rdma"]
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
    part_rect = time_ms(lambda: k2.rect_forces_sym_vpu2(
        state.pos[:c], state.mass[:c], state.pos[c:2 * c],
        state.mass[c:2 * c], cfg.eps2), dev, iters=2)
    med = {k: statistics.median(v) for k, v in turns.items()}
    print(f"[ring 1M] ms/step, rounds of K2, ring, ring, K2: single K2 "
          f"{', '.join(f'{t:.3f}' for t in single)}; 4-shard ring "
          f"{', '.join(f'{t:.3f}' for t in ring)}; median single "
          f"{med['single']:.3f}, ring {med['ring']:.3f} "
          f"({med['ring'] / med['single']:.4f}x); parts: K2 on a "
          f"{c}-body shard {part_k2:.3f} ms, K2-rect vpu2 on a {c} x {c} "
          f"rotation {part_rect:.3f} ms, K1 on a {c} x {c} antipodal sweep "
          f"{part_k1:.3f} ms ({smi})")
    record["rect_forces_sym_vpu2"].update(
        {"ring_ms_1m": med["ring"], "k2_ms_1m": med["single"]})


def ring_parts(state, cfg, p, ring_acc, diff_rows, dev):
    """Pin the ring's error on the rows where it differs from K2 and on
    RING_PART_ROWS sampled rows: the ring's four parts for those rows (K2
    on the row's own shard, the a side of K2-rect with the shard before,
    the b side of K2-rect with the shard after, K1's one-sided antipodal
    sweep), each against a float64 direct sum of the same pairs, as a
    share of the row's |a|.  Added in the ring's order the parts must give
    the ring's rows bit for bit.  K11 on the same antipodal sweep (four
    slices of 512 tiles, merged) is measured beside."""
    import torch
    from nbody_tpu_torch.ops import forces_tiled as k1
    from nbody_tpu_torch.ops.forces_sym_variants import (forces_pallas_sym,
                                                         rect_forces_sym)
    from nbody_tpu_torch.ops.forces_torch import rect_forces
    eps2, c = cfg.eps2, state.n // p
    sh = [(state.pos[i * c:(i + 1) * c], state.mass[i * c:(i + 1) * c])
          for i in range(p)]
    sampled = torch.randperm(state.n, generator=torch.Generator()
                             .manual_seed(5))[:RING_PART_ROWS]
    rows = set(diff_rows) | set(sampled.tolist())
    print(f"[ring 1M parts] {len(rows)} rows: {len(diff_rows)} where ring "
          f"and K2 differ past rel {REL_TOL:g}, {RING_PART_ROWS} sampled")
    names = ("self K2", "rect a side", "rect b side", "antipodal K1",
             "antipodal K11", "ring")
    errs = {k: [] for k in names}
    for s in sorted({r // c for r in rows}):
        local = torch.tensor([r - s * c for r in sorted(rows) if r // c == s],
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
        gate = RING_PART_GATES.get(k)
        print(f"[ring 1M parts] {k}: |err| / |a| against float64 on the "
              f"{len(e)} rows: max {e[-1]:.3e}, median {e[len(e) // 2]:.3e}"
              + (f" (gate {gate:g})" if gate is not None else ""))
        if gate is not None:
            check(e[-1] <= gate, f"ring 1M: {k} off by {e[-1]:.3e} of |a|")


# The sampler (check_sampler on the card; tests/test_torch_sampler.py on
# the CPU against the JAX package): seeded draws of the routes a user
# reaches, both from ``sampler_draws`` (numpy.random.default_rng
# (SAMPLER_SEED)) at their own sizes.  On the card each route is read from
# the launch counters against the one ``simulation_route`` names, its
# first evaluation held to float64 rows and, up to SAMPLER_PLAIN_MAX_N, to
# the same call on the CPU (the kernels' plain versions); there every
# draw is a combination the port runs (the refusals are the CPU's).
SAMPLER_SEED = 27
SAMPLER_DRAWS = 24
SAMPLER_FIXED_N = (1535, 1536, 1537, 16384, 16385)
SAMPLER_MAX_N = 40000
SAMPLER_PER_DEVICE = 8000
SAMPLER_SHARDS = (None, None, 1, 2, 3, 4, 5)
SAMPLER_DTYPES = ("float32",) * 4 + ("float64",)
SAMPLER_ROWS = 1024
# A tier's float64 gate is a statistic (a p99, a fraction of components):
# it is held where the sampled rows give at least this many components;
# below, the draw is held to its plain version, and the exact gate (no
# component outside 1%) at any N.
SAMPLER_GATE_MIN = 3072
SAMPLER_PLAIN_MAX_N = 8192
SAMPLER_IMPLS = ("auto", "xla", "xla_nxn", "pallas", "pallas_kahan",
                 "pallas_mxu", "pallas_fast", "pallas_turbo", "pallas_sym",
                 "pallas_sym2", "pallas_sym_turbo", "pallas_sym_turbo2",
                 "pallas_sym_mxu")
SAMPLER_PALLAS = SAMPLER_IMPLS[3:]
SAMPLER_SYM = ("pallas_sym2", "pallas_sym", "pallas_sym_turbo",
               "pallas_sym_turbo2", "pallas_sym_mxu")
SAMPLER_RDMA = ("auto", "pallas", "pallas_turbo", *SAMPLER_SYM)
SAMPLER_INTEGRATORS = ("reference", "kdk", "yoshida4")
SAMPLER_COMMS = ("ring", "allgather", "rdma", "rdma_overlap")
SAMPLER_INITS = ("uniform", "plummer", "plummer-virial", "disk", "collision")
SAMPLER_NXN_MAX_N = 16384
IMPL_KERNELS = {"pallas": "forces_tiled", "pallas_kahan":
                "forces_tiled_kahan", "pallas_fast": "forces_fast",
                "pallas_turbo": "forces_tiled_turbo",
                "pallas_mxu": "forces_tiled_mxu",
                "pallas_sym": "forces_sym_vpu", "pallas_sym2": "forces_sym",
                "pallas_sym_turbo": "forces_sym_turbo",
                "pallas_sym_turbo2": "forces_sym_turbo2",
                "pallas_sym_mxu": "forces_sym_mxu"}
ONE_SIDED_KERNELS = {"vpu": "forces_tiled", "vpu_kahan": "forces_tiled_kahan",
                     "fast": "forces_fast", "turbo": "forces_tiled_turbo",
                     "mxu": "forces_tiled_mxu"}
SAMPLER_GATES = {**{impl: (None, VALIDATE_ACC_FRAC) for impl in (
    "auto", "xla", "xla_nxn", "pallas", "pallas_sym2")},
    "pallas_sym": TIER_GATES["forces_sym_vpu"],
    "pallas_kahan": TIER_GATES["forces_tiled_kahan"],
    "pallas_fast": (None, MESH_FAST_FRAC),
    **{impl: TIER_GATES[k] for k, impl in TIER_IMPLS.items()}}


def sampler_cycle(rng, values, k):
    """``k`` values, each of ``values`` as often as the others (± 1), in
    the order of consecutive permutations drawn from ``rng``."""
    out = []
    while len(out) < k:
        out += [values[i] for i in rng.permutation(len(values))]
    return out[:k]


@functools.lru_cache(maxsize=None)
def sampler_primes(lo, hi):
    return [p for p in range(max(2, lo), hi + 1)
            if all(p % d for d in range(2, int(p ** 0.5) + 1))]


def sampler_n(rng, lo, hi):
    """N in [lo, hi], weighted towards odd N, primes and tile ± 1."""
    kind = rng.choice(["prime", "odd", "tile", "any"], p=[.3, .2, .3, .2])
    pool = {"prime": lambda: sampler_primes(lo, hi),
            "tile": lambda: [t + d for t in range(128, hi + 2, 128)
                             for d in (-1, 0, 1) if lo <= t + d <= hi],
            "odd": lambda: range(lo | 1, hi + 1, 2),
            "any": lambda: range(lo, hi + 1)}[kind]()
    pool = pool or range(lo, hi + 1)
    return int(pool[rng.integers(len(pool))])


def sampler_fit(d, rng):
    """Make a draw's options fit one another: a forced resident mode takes
    an exact sym tier on one device in float32, a forced flat state a sym
    tier on one device, K13's comms an impl they serve."""
    one = d["shards"] is None
    if d["flat_state"] and (not one or d["resident"]):
        d["flat_state"] = None
    if d["resident"]:
        if one and d["dtype"] == "float32":
            if d["impl"] not in SAMPLER_SYM[:2]:
                d["impl"] = SAMPLER_SYM[rng.integers(2)]
        else:
            d["resident"] = None
    if d["flat_state"]:
        if d["dtype"] == "float32":
            if d["impl"] not in SAMPLER_SYM:
                d["impl"] = SAMPLER_SYM[rng.integers(len(SAMPLER_SYM))]
        else:
            d["flat_state"] = None
    if d["comm"] in ("rdma", "rdma_overlap") and d["impl"] not in SAMPLER_RDMA:
        d["comm"] = ("ring", "allgather")[rng.integers(2)]


def sampler_draws(k=SAMPLER_DRAWS, n_max=SAMPLER_MAX_N,
                  per_device=SAMPLER_PER_DEVICE, shards=SAMPLER_SHARDS,
                  dtypes=SAMPLER_DTYPES, fixed_n=SAMPLER_FIXED_N, every=True):
    """``k`` draws from numpy.random.default_rng(SAMPLER_SEED) of (N,
    impl, integrator, dtype, JAX's x64, resident, flat_state, prog_cap,
    JAX's block_i / block_j / block_u, shards, comm, steps, the --init
    preset, a checkpoint-resume): N in [2, ``n_max``] on one device and
    [P, ``per_device`` P] on P ``shards``, weighted towards odd N, primes
    and tile ± 1; each axis cycled so that its values come alike; a cap
    binding (a third of a step's pairs) or not (twice them).  Two draws of
    three are made to fit (``sampler_fit``) and the third keeps its
    combination, a refusal, unless ``every``: then every draw fits, and
    takes only what the port runs (the kernels float32, a forced resident
    mode no binding cap).  The first draws take ``fixed_n`` under auto on
    one device in float32.  Each draw's ``id`` spells it out."""
    import numpy as np
    rng = np.random.default_rng(SAMPLER_SEED)
    dtypes = sampler_cycle(rng, list(dtypes), k)
    f32_impls = iter(sampler_cycle(rng, list(SAMPLER_IMPLS), k))
    # A state of another dtype takes the plain paths, or a kernel's refusal.
    other_impls = iter(sampler_cycle(rng, ["auto", "xla", "xla_nxn",
                                           SAMPLER_PALLAS[rng.integers(
                                               len(SAMPLER_PALLAS))]], k))
    columns = {"integrator": sampler_cycle(rng, list(SAMPLER_INTEGRATORS), k),
               "shards": sampler_cycle(rng, list(shards), k),
               "comm": sampler_cycle(rng, list(SAMPLER_COMMS), k),
               "resident": sampler_cycle(rng, [None, None, True, False], k),
               "flat_state": sampler_cycle(rng, [None, None, None, True,
                                                 False], k),
               "prog_cap": sampler_cycle(rng, [None, None, "binding",
                                               "non-binding"], k),
               "init": sampler_cycle(rng, list(SAMPLER_INITS), k),
               "block_i": sampler_cycle(rng, [128, 256, 512], k),
               "block_j": sampler_cycle(rng, [128, 256, 512, 2048], k),
               "block_u": sampler_cycle(rng, [None, 256, 512, 1024], k),
               "resume": sampler_cycle(rng, [False, True], k)}
    out = []
    for i in range(k):
        d = {key: col[i] for key, col in columns.items()}
        fixed = i < len(fixed_n)
        d["dtype"] = "float32" if fixed else dtypes[i]
        d["impl"] = "auto" if fixed else next(
            f32_impls if d["dtype"] == "float32" else other_impls)
        d["x64"] = bool(d["dtype"] == "float64" and rng.integers(2))
        if rng.integers(3) or every:
            sampler_fit(d, rng)
        if every:
            if d["dtype"] != "float32":
                if d["impl"] in SAMPLER_PALLAS:
                    d["impl"] = "auto"
                if d["comm"] in ("rdma", "rdma_overlap"):
                    d["comm"] = "allgather"
            if d["resident"]:
                d["prog_cap"] = None
        if fixed:
            d.update(impl="auto", shards=None, resident=None,
                     flat_state=None, prog_cap=None)
        p = d["shards"]
        if p is None:
            d["comm"] = None
            d["n"] = sampler_n(rng, 2, n_max)
            d["steps"] = int(rng.integers(1, 4))
        else:
            d["n"] = sampler_n(rng, max(2, p), per_device * p)
            d["steps"] = int(rng.integers(1, 3))
        if fixed:
            d["n"] = fixed_n[i]
        if d["impl"] == "xla_nxn":
            d["n"] = min(d["n"], SAMPLER_NXN_MAX_N)
        if d["block_u"] is not None:
            d["block_u"] = max(d["block_u"], d["block_i"])
        cap = d["prog_cap"]
        if cap is not None:
            n2 = float(d["n"]) ** 2 / (p or 1)
            d["prog_cap"] = (max(1.0, n2 / 3) if cap == "binding"
                             else 2.0 * n2)
        d["seed"] = int(rng.integers(1000))
        d["id"] = "-".join(str(x) for x in (
            f"{i:02d}", f"n{d['n']}", d["impl"], d["integrator"], d["dtype"]
            + ("-x64" if d["x64"] else ""), f"res{d['resident']}",
            f"flat{d['flat_state']}",
            "cap" + ("None" if cap is None else cap),
            f"bi{d['block_i']}", f"bj{d['block_j']}", f"bu{d['block_u']}",
            f"p{p}" + (f"-{d['comm']}" if p else ""), f"s{d['steps']}",
            d["init"], "resume" if d["resume"] else "once"))
        out.append(d)
    return out


def sampler_start(d, device):
    """The draw's seeded start state on ``device`` (its preset)."""
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.models.init import INIT_MAKERS
    cfg = nt.SimConfig(n_bodies=d["n"], dtype=d["dtype"], seed=d["seed"],
                       device=device)
    return INIT_MAKERS.get(d["init"], nt.init_state)(cfg)


def sampler_sim(d, device, start, first_only=False, path=None,
                progress=None):
    """The draw through ``Simulation`` on ``device`` (a mesh of its shards
    there) from ``start``: its end state, or its first force evaluation
    (the KDK prime's, or the first reference step's), or with ``path``
    half the steps, a checkpoint, a resume and the rest.  Returns
    (Simulation, state)."""
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.parallel.mesh import make_mesh
    cfg = nt.SimConfig(n_bodies=d["n"], impl=d["impl"],
                       integrator=d["integrator"], dtype=d["dtype"],
                       resident=d["resident"], flat_state=d["flat_state"],
                       prog_cap=d["prog_cap"], seed=d["seed"], device=device)
    start = nt.SimState(*(t.to(device) for t in start))
    mesh = make_mesh(d["shards"], device) if d["shards"] else None
    kw = {"mesh": mesh, "comm": d["comm"] or "ring"}
    sim = nt.Simulation(cfg, start, **kw)
    sim.progress = progress
    if first_only:
        if d["integrator"] == "reference":
            sim.run(1)
        return sim, sim.state
    if path is None:
        sim.run(d["steps"])
        return sim, sim.state
    half = max(1, d["steps"] // 2)
    sim.run(half)
    nt.save_checkpoint(path, sim.state, half, cfg)
    sim = nt.Simulation.resume(path, device=device, **kw)
    sim.progress = progress
    if d["steps"] > half:
        sim.run(d["steps"] - half)
    return sim, sim.state


def sampler_route(d, device):
    """The route ``Simulation`` takes for the draw on ``device``
    (``simulation_route``) and the kernels whose counters must move on it
    and no others: (route, kernels)."""
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.models.simulation import simulation_route
    from nbody_tpu_torch.parallel.mesh import make_mesh
    from nbody_tpu_torch.parallel.ring import _RECT_VARIANTS, _SYM_VARIANTS
    cfg = nt.SimConfig(n_bodies=d["n"], impl=d["impl"],
                       integrator=d["integrator"], dtype=d["dtype"],
                       resident=d["resident"], flat_state=d["flat_state"],
                       prog_cap=d["prog_cap"], device=device)
    p, comm = d["shards"], d["comm"] or "ring"
    route = simulation_route(cfg, make_mesh(p, device) if p else None, comm)
    impl = route.impl
    if p and comm.startswith("rdma"):
        kernels = {"rdma_ring"}
    elif p and not impl.startswith("pallas"):
        kernels = set()
    elif p and comm == "ring" and impl in _SYM_VARIANTS:
        v = _SYM_VARIANTS[impl]
        kernels = ({IMPL_KERNELS[impl]}
                   | ({f"rect_forces_sym_{v}"} if p >= 3 else set())
                   | ({ONE_SIDED_KERNELS[_RECT_VARIANTS[impl]]}
                      if p % 2 == 0 else set()))
    elif p:
        kernels = {ONE_SIDED_KERNELS[_RECT_VARIANTS[impl]]}
    elif route.resident:
        kernels = {"resident" if d["integrator"] == "reference"
                   else "resident_kdk"}
        if d["integrator"] != "reference":
            kernels.add("forces_sym")     # the KDK prime, on K2's sums
    else:
        kernels = {IMPL_KERNELS[impl]} if impl in IMPL_KERNELS else set()
    return route, kernels


def check_sampler(counts, smi):
    """SAMPLER_DRAWS seeded draws on one card (``sampler_draws``): for
    each, the launch counters of the run (and of its resume) name the
    route that ``simulation_route`` names, the bounded runs call their
    heartbeat and the others do not, a flat route ends in a flat state, a
    resumed run ends bit-equal to the uninterrupted one, the first
    evaluation meets the
    tier's float64 gate on SAMPLER_ROWS sampled rows (``rows_float64``)
    and, up to SAMPLER_PLAIN_MAX_N, the same call on the CPU (the plain
    versions) at the kernel-vs-twin tolerance."""
    import torch
    from nbody_tpu_torch.models.state import is_flat, state_from_flat
    t_all = time.perf_counter()
    os.makedirs(WORK, exist_ok=True)

    def rows_of(state):
        return state_from_flat(state) if is_flat(state) else state
    for d in sampler_draws():
        t0 = time.perf_counter()
        route, kernels = sampler_route(d, "cuda:0")
        impl = route.impl
        beats = []
        start = sampler_start(d, "cuda:0")
        before = counts()
        sim, end = sampler_sim(d, "cuda:0", start,
                               progress=lambda done, total, acc:
                               beats.append(total))
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in counts().items()}
        moved = {k for k, v in delta.items() if v}
        check(moved == kernels, f"sampler {d['id']}: launched {moved}, the "
              f"route ({impl}) names {kernels}")
        check(bool(beats) == route.bounded and is_flat(end) == route.flat,
              f"sampler {d['id']}: heartbeat {len(beats)}, flat "
              f"{is_flat(end)} against the route's {route}")
        end = rows_of(end)
        check(all(bool(torch.isfinite(getattr(end, k)).all())
                  for k in ("pos", "vel", "acc")),
              f"sampler {d['id']}: non-finite state")
        if d["resume"]:
            before = counts()
            _, resumed = sampler_sim(d, "cuda:0", start,
                                     path=os.path.join(WORK, "sampler.npz"))
            torch.cuda.synchronize()
            moved = {k for k, v in counts().items() if v - before[k]}
            check(moved == kernels and states_equal(rows_of(resumed), end),
                  f"sampler {d['id']}: the resumed run (launched {moved}) "
                  f"differs from the uninterrupted one")
        # The first evaluation is the force at the start positions.
        _, first = sampler_sim(d, "cuda:0", start, first_only=True)
        first = rows_of(first)
        gen = torch.Generator().manual_seed(d["seed"])
        rows = torch.randperm(d["n"], generator=gen)[:SAMPLER_ROWS].cuda()
        want = rows_float64(start.pos, start.mass, rows, 0.002)
        p99, frac = gate_numbers(first.acc[rows], want)
        p99_gate, frac_gate = SAMPLER_GATES[impl]
        held = (3 * rows.numel() >= SAMPLER_GATE_MIN
                or (p99_gate, frac_gate) == (None, VALIDATE_ACC_FRAC))
        check(not held or ((p99_gate is None or p99 < p99_gate)
                           and frac <= frac_gate),
              f"sampler {d['id']}: p99 {p99:.3e}, bad fraction {frac:.3e} "
              f"against the gate ({p99_gate}, {frac_gate})")
        plain = ""
        if d["n"] <= SAMPLER_PLAIN_MAX_N:
            # The kernels' plain versions: the resolved impl on the CPU
            # (where auto would take the plain paths).
            _, cpu = sampler_sim(dict(d, impl=impl), "cpu", start,
                                 first_only=True)
            rel, floor = ((FAST_REL_TOL, TC_ABS_FLOOR)
                          if impl == "pallas_fast" else
                          (TC_REL_TOL, TC_ABS_FLOOR)
                          if IMPL_KERNELS.get(impl) in TIER_IMPLS
                          else (REL_TOL, ABS_FLOOR))
            _, max_rel, _ = compare(f"sampler {d['id']} first evaluation "
                                    f"vs the plain versions", first.acc,
                                    rows_of(cpu).acc, rel, floor)
            plain = f"; plain max rel {max_rel:.3e}"
        print(f"[sampler] {d['id']}: route {impl}"
              + (" resident" if route.resident else "")
              + (f" bounded ({max(beats)} programs)" if route.bounded
                 else "")
              + (" flat" if route.flat else "")
              + f", launches { {k: delta[k] for k in sorted(kernels)} }; "
              f"vs float64 rows p99 {p99:.3e}, bad fraction {frac:.3e}"
              + ("" if held else " (too few components for the tier's "
                 "gate)") + f"{plain}; {time.perf_counter() - t0:.1f} s")
    print(f"[time] check_sampler: {time.perf_counter() - t_all:.1f} s "
          f"({smi})")


def kernel_wrappers():
    """Every kernel's wrapper by name: each counts its launches in
    ``.launches``."""
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_tiled as k1
    from nbody_tpu_torch.ops import forces_sym_tc as k56
    from nbody_tpu_torch.ops import forces_tiled_tc as k910
    from nbody_tpu_torch.ops import forces_fast as k12
    from nbody_tpu_torch.ops import pe, resident
    from nbody_tpu_torch.ops import ablation_sym
    from nbody_tpu_torch.parallel import rdma_ring as k13
    return {"forces_tiled": k1.forces_tiled, "forces_sym": k2.forces_sym,
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
               for v, w in ablation_sym.RECT_WRAPPERS.items()},
            **probe_wrappers()}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 1
    t_main = time.perf_counter()
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
            "forces_tiled_tc", "forces_sym_tc", "forces_fast", "rdma_ring",
            "probes")
    from nbody_tpu_torch.utils import compcache
    print(f"[build] build root {compcache.build_root()} (NBODY_COMPCACHE="
          f"{os.environ.get('NBODY_COMPCACHE', '')!r})")
    shutil.rmtree(compcache.build_root(), ignore_errors=True)
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.perf_counter()
    _build.build_all(libs)
    print(f"[build] all {len(libs)} libraries: "
          f"{time.perf_counter() - t0:.2f} s")
    if sys.argv[1:2] == ["--long-horizon"]:
        # Config #2's long-horizon gate alone: one eps2 a call.
        args = sys.argv[2:]
        check(len(args) in (1, 3) and (len(args) == 1 or args[1:] == [
            "--integrator", "kdk"]), "usage: chip_smoke.py --long-horizon "
              "EPS2 [--integrator kdk]")
        eps2 = float(args[0])
        integrator = args[2] if len(args) == 3 else "reference"
        wrappers = kernel_wrappers()
        oracle_s = []
        share_oracle_runs(oracle_s)
        routes = long_horizon(
            eps2, integrator, lambda: {k: w.launches
                                       for k, w in wrappers.items()}, smi)
        for oracle, secs in oracle_s:
            print(f"[long] oracle run ({oracle}): {secs:.1f} s on the host, "
                  f"shared by {len(routes)} routes")
        print(f"[time] --long-horizon {eps2:g} {integrator} total, the "
              f"build included: {time.perf_counter() - t_main:.1f} s")
        print(json.dumps({"long_horizon": {
            "eps2": eps2, "integrator": integrator, "n": LONG_N,
            "steps": LONG_STEPS, "oracle_s": oracle_s,
            "routes": routes}}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:2] == ["--ladder"]:
        # The JAX rounds' ladder alone, every row by default, on every card
        # of the host (row 5's shards).
        from nbody_tpu_torch.bench_suite import CONFIGS
        keys = sys.argv[2].split(",") if len(sys.argv) > 2 else list(CONFIGS)
        check(len(sys.argv) <= 3 and all(k in CONFIGS for k in keys),
              "usage: chip_smoke.py --ladder [KEY,KEY,...] (keys 1-8)")
        wrappers = kernel_wrappers()

        def reset():
            for w in wrappers.values():
                w.launches = 0
        records = check_ladder(
            keys, lambda: {k: w.launches for k, w in wrappers.items()},
            reset, smi)
        print(f"[time] --ladder {','.join(keys)} total, the build included: "
              f"{time.perf_counter() - t_main:.1f} s")
        print(json.dumps({"ladder": records}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--cross-card"]:
        # The cross-card phases alone, on a host of several cards.
        share_oracle_runs()
        record = {"rdma_ring": {}}
        check_cross_card(None, record, smi)
        print(f"[time] --cross-card total, the build included: "
              f"{time.perf_counter() - t_main:.1f} s")
        print(json.dumps(record["rdma_ring"]))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    for lib in libs:
        _build.load(lib)
        print(f"[build] {lib}.cu: done at {_build.BUILD_SECONDS[lib]:.2f} s")
        for line in _build.BUILD_LOG[lib].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    check(not sys.argv[1:], f"unknown arguments {sys.argv[1:]}")

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
    check_fold(dev, 0.002)
    check_ablations(dev, 0.002, record, smi)
    check_rdma(dev, 0.002, record, smi)
    check_resident(dev, record)
    check_pe(dev, record, smi)
    check_probes(dev, record, smi)
    for kname, r in record.items():
        print(f"[time] {kname} ({r['shape']}): kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
              f"({r['bound'][1]}) ({smi})")

    # 4. K2 at the 1M headline.
    check_k2_1m(dev)

    # 5. The main paths, through the CLI, with the launch counters.
    wrappers = kernel_wrappers()

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    launches = main_path(counts, reset, record)
    check_cross_card(counts, record, smi)
    check_sampler(counts, smi)
    ladder_smoke()

    # 6. Invariants over 200 device-only steps.
    from nbody_tpu_torch.analysis import invariant_drifts
    cfg = nt.SimConfig(n_bodies=8192, device="cuda")
    start = nt.init_state(cfg)
    host0 = nt.state_to_numpy(start)
    host = nt.state_to_numpy(nt.run_steps(start, cfg, 200))
    import numpy as np
    check(np.isfinite(host["pos"]).all(), "non-finite state after 200 steps")
    p_drift, l_drift = invariant_drifts(host["pos"], host["vel"],
                                        host["mass"], host0["pos"],
                                        host0["vel"])
    print(f"[invariants] 200 steps N=8192 ({nt.resolve_impl(cfg)}): "
          f"|P-P0|/scale {p_drift:.3e}, |L-L0|/scale {l_drift:.3e} "
          f"(gate 1e-3)")
    check(p_drift <= 1e-3 and l_drift <= 1e-3, "invariant gate")

    # 7. Crossovers, and the 4-shard ring step at 1M against K2's.
    crossovers(dev, smi)
    ring_1m(dev, smi, record)

    # 8. Bench lines.
    from nbody_tpu_torch.bench_lib import run_benchmark
    for kw in ({"n": 8192}, {"n": 8192, "resident": False},
               {"n": 8192, "resident": True}, {"n": 8192, "impl": "pallas"},
               # The plain path: 100 steps (1000 take ~10 s on an H100).
               {"n": 8192, "impl": "xla", "steps": 100},
               {"n": 1 << 20, "energy": True},
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
               {"n": 1 << 20, "shards": 4, "comm": "rdma"},
               # The JAX ladder's scale row: auto at 4M, bounded; one trial
               # (check_huge_n's CLI runs time the same step three times).
               {"n": 1 << 22, "steps": 2, "trials": 1}):
        t0 = time.perf_counter()
        res = run_benchmark(**({"device": "cuda:0"} if "shards" in kw
                                  else {}), **kw)
        check(res["finite"], f"bench {kw}: non-finite")
        print("[bench] " + json.dumps(res))
        print(f"[time] bench {kw}: {time.perf_counter() - t0:.1f} s")

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
              for v in ABLATIONS),
            *((k, "nbody_tpu_torch/csrc/probes.cu", repl)
              for k, (repl, _) in PROBE_KERNELS.items())):
        r = dict(record[kname])
        bound_ms, bound_by = r.pop("bound")
        # No single PyTorch call computes any of the force or energy
        # kernels' functions; the probes' records carry theirs.
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[kname],
                        "max_abs_err": r.pop("max_abs_err"),
                        "ms": r.pop("ms"), "plain_ms": r.pop("plain_ms"),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": r.pop("library_ms", None), **r})
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
        elif k["name"] in PROBE_KERNELS:
            k["also_replaces"] = PROBE_KERNELS[k["name"]][1]
    print(f"[time] chip_smoke.py total, the build included: "
          f"{time.perf_counter() - t_main:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
