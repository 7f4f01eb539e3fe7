#!/usr/bin/env python3
"""Time source-edited variants of a tensor-core tier's pair pass on the card.

    python3 tools/sym_tc_variants.py [--variant turbo|turbo2|turbof|mxu|tmm]
        [--n N] [--rounds R]

Copies ``nbody_tpu_torch/csrc`` once per variant into
``build/sym_tc_variants/<name>/``, applies the variant's text edits, builds
``forces_sym_tc.cu`` from each copy with the port's nvcc flags (one nvcc
each, all at once), and times one evaluation of the tier (K5 for
``--variant turbo``, the default; K14a for ``turbo2``; K14b for
``turbof``; K6 for ``mxu``: the wrapper's sweep, the pair passes and the
reduce passes) at N bodies
(default 1,048,576) for every variant in alternating rounds (the order
reversed every other round).  Prints each variant's registers and spills
for the tier's pair kernel and its CTAs per SM as it launches, whether
its output is bit-equal to the unedited source's, the rounds and their
median.  The variants are the levers the redesigns weighed, K5's:

- ``base``: the sources as they are (the 16-column loop of K5's tile
  unrolled twice, 80 registers, three CTAs an SM);
- ``unroll1``, ``unroll4``: the loop rolled, or unrolled four times;
- ``ctas4``, ``ctas4_unroll1``: K5's pair kernels held to 64 registers,
  four CTAs an SM, with the loop unrolled twice or rolled;
- ``trunc_bf16``: a diagnostic, not a candidate: the bf16 weights by
  truncation through one byte permute in place of the rounding convert
  (F2FP), which prices the convert; its output differs by design;

and K14a's (``--variant turbo2``), each edit confined to turbo2's kernels:

- ``base``: the sources as they are (turbo2 trimmed, the loop unrolled
  twice, as K5's);
- ``untrimmed``: turbo2 back on pair_inv with the loop rolled, the
  design before its redesign (its output differs by design);
- ``unroll1``, ``unroll4``, ``ctas4``, ``ctas4_unroll1``: as K5's, for
  turbo2 alone;
- ``trunc_bf16``: the diagnostic above;

and K14b's (``--variant turbof``), each edit confined to turbof's kernels:

- ``base``: the sources as they are (turbof trimmed, the loop unrolled
  twice, the two weights of a register rounded by one bf16x2 convert,
  pack2_rn);
- ``untrimmed``: turbof back on pair_inv with the loop rolled and
  pack_rn, the design before its redesign (its output differs by
  design);
- ``pack1``: the trimmed tile with pack_rn (two converts and the
  packing), which must give pack2_rn's bits;
- ``unroll1``, ``unroll4``, ``ctas3``, ``ctas4``, ``ctas4_unroll1``: as
  K5's and K6's, for turbof alone;

and K6's (``--variant mxu``), each edit confined to mxu's tile (the
split's, the j side's, K13's mxu tile too, which this tool does not
time):

- ``base``: the sources as they are (mxu trimmed, the loop unrolled
  twice, the hi/lo split of two weights at once by split2_rn,
  tc_common.cuh: one bf16x2 convert a limb, hi back to float32 by a
  shift and a mask);
- ``untrimmed``: mxu back on pair_inv and split_rn with the loop rolled,
  the design before its redesign (its output differs by design);
- ``split1``: the trimmed tile with split_rn (two converts a limb and
  the packing), which must give split2_rn's bits;
- ``unroll1``, ``unroll4``: as K5's, for mxu alone;
- ``ctas3``, ``ctas4``, ``ctas4_unroll1``: mxu's pair kernels held to
  three or four CTAs an SM (at most 85 or 64 registers), the last with
  the loop rolled;
- ``nolot``: a diagnostic, not a candidate: the j side without the lo
  limb (no lo transposes, one j-side mma a block), which prices the
  second movmatrix set and its product; its output differs by design;

and K15's ``tmm_noj`` and ``tmm_nomm`` (``--variant tmm``), each edit
confined to those two: for every variant it times both forms' triangular
sweep (their pair passes and forces_sym.cu's none reduce) free and pinned
at K5's CTAs an SM (``nbt_sym_tc_abl_pin``), and base's K5 beside them,
and prints each pair kernel's registers, CTAs an SM free and pinned and
issue slots a pair (the instructions of its column loop over its MUFU,
one rsqrt a pair: ``tools/ptxas_compare.py``'s ``main_loop``):

- ``base``: the sources as they are (K5's trimmed tile, the loop
  unrolled twice; ``tmm_nomm`` adds the halves of K5's two weight
  registers into its row sums by a shift or a mask and one add a
  weight, ``nomm_add``);
- ``parent``: the design before: both on pair_inv with the loop rolled,
  ``tmm_nomm`` rounding each weight by a convert of its own, converting
  it back and adding it (their outputs differ by design);
- ``unroll1``: the loop rolled;
- ``cvt1``: ``tmm_nomm``'s consumer as before (a convert, a convert
  back and an add a weight) on the trimmed pair;
- ``pack1``: ``tmm_nomm``'s weight registers by ``pack_rn``, not
  ``pack2_rn`` (the same bits; the compiler then rounds each weight
  with integer operations, no F2FP);
- ``sink``: a diagnostic, not a candidate: ``tmm_nomm`` with its
  consumer cut to one XOR of each weight register into the row's
  accumulator (a LOP3, which ptxas may give three inputs), the least
  that keeps K5's two weight registers live, which prices the consumer
  (its row sums are bit patterns, not sums).

Needs a CUDA card and nvcc; takes a few minutes on one H100.
"""

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "nbody_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "build", "sym_tc_variants")
_KERNEL = ("template <int V>\n__global__ void __launch_bounds__(SYM_TILE)\n"
           "sym_tc_pairs_kernel(")
_UNROLL = "#pragma unroll (TRIM ? 2 : 1)"


def _ctas4(cond, ctas=4):
    return ("forces_sym_tc.cu", _KERNEL,
            "template <int V>\n__global__ void __launch_bounds__(SYM_TILE, "
            f"{cond} ? {ctas} : 1)\nsym_tc_pairs_kernel(")


def _unroll(times, only=None):
    if only:
        times = f"(V == {only} ? {times} : 2)"
    return ("sym_tc_tile.cuh", _UNROLL,
            f"#pragma unroll (TRIM ? {times} : 1)")


_TRUNC_BF16 = (
    "tc_common.cuh",
    "    return bf16x2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));",
    "    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), "
    "0x7632);")
# turbo2, turbof or mxu back on pair_inv: tc_trimmed without it.
_UNTRIMMED = {"turbo2": ("sym_tc_tile.cuh", "v == TURBO2 || v == TURBOF",
                         "v == TURBOF"),
              "turbof": ("sym_tc_tile.cuh", " || v == TURBOF || ", " || "),
              "mxu": ("sym_tc_tile.cuh", " || v == MXU;", ";")}
_PACK1 = ("sym_tc_tile.cuh",
          "a[r] = pack2_rn(wa, wb);",
          "a[r] = pack_rn(wa, wb);")
_SPLIT1 = ("sym_tc_tile.cuh",
           "split2_rn(inv[2 * r], inv[2 * r + 1], a[r], lo[r]);",
           "split_rn(inv[2 * r], inv[2 * r + 1], a[r], lo[r]);")
_NOLOT = ("sym_tc_tile.cuh",
          "                transpose_a(lo, lot);\n"
          "                mma_bf16(dj, at, bi[rb][0], bi[rb][1]);\n"
          "                mma_bf16(dj, lot, bi[rb][0], bi[rb][1]);",
          "                (void)lot;\n"
          "                mma_bf16(dj, at, bi[rb][0], bi[rb][1]);")

# K15's tmm_noj / tmm_nomm: back on pair_inv and rolled (tc_trimmed
# without them); tmm_nomm's consumer as before, a convert of each weight of
# its own; no consumer (the diagnostic).
_TMM_UNTRIMMED = ("sym_tc_tile.cuh",
                  "v == TMM_NOSCAT ||\n           v == TMM_NOJ || "
                  "v == TMM_NOMM ||\n", "v == TMM_NOSCAT ||\n")
_TMM_NOMM_PACK = (
    "                    a[r] = pack2_rn(__fmul_rn(q[qa].w, inv[2 * r]),\n"
    "                                    __fmul_rn(q[qa + 1].w, "
    "inv[2 * r + 1]));\n"
    "                    const uint32_t aj = pack2_rn(\n"
    "                        __fmul_rn(mi, inv[2 * r]),\n"
    "                        __fmul_rn(mi, inv[2 * r + 1]));\n")
_TMM_PACK1 = ("sym_tc_tile.cuh", _TMM_NOMM_PACK,
              _TMM_NOMM_PACK.replace("pack2_rn(", "pack_rn(", 2))
_TMM_CVT1 = (
    "sym_tc_tile.cuh",
    _TMM_NOMM_PACK +
    "                    nomm_add(wi_sum[rb][r & 1], a[r]);\n"
    "                    nomm_add(wj_sum[rb][r & 1], aj);\n",
    "#pragma unroll\n"
    "                    for (int e = 0; e < 2; ++e) {\n"
    "                        const float f = inv[2 * r + e];\n"
    "                        wi_sum[rb][r & 1] += __bfloat162float(\n"
    "                            __float2bfloat16_rn(__fmul_rn(q[qa + e].w, "
    "f)));\n"
    "                        wj_sum[rb][r & 1] += __bfloat162float(\n"
    "                            __float2bfloat16_rn(__fmul_rn(mi, f)));\n"
    "                    }\n")
NOMM_SINK = ("sym_tc_tile.cuh",
             "    s += __fadd_rn(__uint_as_float(w << 16),\n"
             "                   __uint_as_float(w & 0xffff0000u));",
             "    s = __uint_as_float(__float_as_uint(s) ^ w);")

VARIANTS = {
    "turbo": {
        "base": [],
        "unroll1": [_unroll(1)],
        "unroll4": [_unroll(4)],
        "ctas4": [_ctas4("tc_trimmed(V)")],
        "ctas4_unroll1": [_ctas4("tc_trimmed(V)"), _unroll(1)],
        "trunc_bf16": [_TRUNC_BF16],
    },
    "turbo2": {
        "base": [],
        "untrimmed": [_UNTRIMMED["turbo2"]],
        "unroll1": [_unroll(1, "TURBO2")],
        "unroll4": [_unroll(4, "TURBO2")],
        "ctas4": [_ctas4("V == TURBO2")],
        "ctas4_unroll1": [_ctas4("V == TURBO2"), _unroll(1, "TURBO2")],
        "trunc_bf16": [_TRUNC_BF16],
    },
    "turbof": {
        "base": [],
        "untrimmed": [_UNTRIMMED["turbof"], _PACK1],
        "pack1": [_PACK1],
        "unroll1": [_unroll(1, "TURBOF")],
        "unroll4": [_unroll(4, "TURBOF")],
        "ctas3": [_ctas4("V == TURBOF", 3)],
        "ctas4": [_ctas4("V == TURBOF")],
        "ctas4_unroll1": [_ctas4("V == TURBOF"), _unroll(1, "TURBOF")],
    },
    "mxu": {
        "base": [],
        "untrimmed": [_UNTRIMMED["mxu"]],
        "split1": [_SPLIT1],
        "unroll1": [_unroll(1, "MXU")],
        "unroll4": [_unroll(4, "MXU")],
        "ctas3": [_ctas4("V == MXU", 3)],
        "ctas4": [_ctas4("V == MXU")],
        "ctas4_unroll1": [_ctas4("V == MXU"), _unroll(1, "MXU")],
        "nolot": [_NOLOT],
    },
    "tmm": {
        "base": [],
        "parent": [_TMM_UNTRIMMED, _TMM_CVT1],
        "unroll1": [_unroll(1, "TMM_NOJ || V == TMM_NOMM")],
        "cvt1": [_TMM_CVT1],
        "pack1": [_TMM_PACK1],
        "sink": [NOMM_SINK],
    },
}
# The tier's id in SymTcVariant (csrc/sym_tc_tile.cuh), and its pair
# kernel, sym_tc_pairs_kernel<V>, by its mangled name.
_VARIANT_ID = {"turbo": 0, "mxu": 1, "turbo2": 2, "turbof": 3,
               "tmm_noj": 7, "tmm_nomm": 8}
_MANGLED = {k: f"_Z19sym_tc_pairs_kernelILi{v}E"
            for k, v in _VARIANT_ID.items()}
# The reduce pass of the tier: turbof's slots are mass-scaled.
_REDUCE = {"turbof": "nbt_sym_tc_descale_reduce"}


def build(name, edits):
    """Start nvcc on the edited copy; returns (library path, process)."""
    from nbody_tpu_torch.ops import _build
    src = os.path.join(WORK, name)
    shutil.copytree(CSRC, src)
    for fname, old, new in edits:
        path = os.path.join(src, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit of {fname} does not apply")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    so = os.path.join(src, "libforces_sym_tc.so")
    return so, subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
         os.path.join(src, "forces_sym_tc.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def main():
    from nbody_tpu_torch.ops import _build
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", choices=sorted(VARIANTS), default="turbo")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sym_tc_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch.ops import ablation_sym as ab
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_sym_tc as k5
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    from nbody_tpu_torch.utils.timing import time_ms
    from tools.ptxas_compare import loop_slots
    smi = nvidia_smi_line()
    shutil.rmtree(WORK, ignore_errors=True)
    tier = args.variant
    # The pair kernels timed, each with its C pair entry and the package's
    # reduce entry: the tier's own, or tmm_noj / tmm_nomm with K15's none
    # reduce (forces_sym.cu, which no variant edits).
    if tier == "tmm":
        kernels = ("tmm_noj", "tmm_nomm")
        reduce = {k: ab._entries(k)[1] for k in kernels}
    else:
        kernels = (tier,)
        reduce = {tier: getattr(k5._lib(), _REDUCE.get(
            tier, "nbt_sym_tc_reduce"))}
    jobs = {name: build(name, edits)
            for name, edits in VARIANTS[tier].items()}
    ref = k5._lib()
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        lib = ctypes.CDLL(so)
        for fn in ("nbt_sym_tc_pairs_ctas", "nbt_sym_tc_abl_pin"):
            getattr(lib, fn).argtypes = [ctypes.c_int]
            getattr(lib, fn).restype = ctypes.c_int
        for k in kernels + (("turbo",) if tier == "tmm" else ()):
            fn = f"nbt_sym_{k}_pairs"
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        for k in kernels:
            report = []
            for i, line in enumerate(lines):
                if f"Compiling entry function '{_MANGLED[k]}" in line:
                    report = [x.strip() for x in lines[i + 1:i + 4]
                              if "registers" in x or "spill" in x]
            ctas = _build.query("cuda", lib.nbt_sym_tc_pairs_ctas,
                                _VARIANT_ID[k])
            if tier == "tmm":
                _build.query("cuda", lib.nbt_sym_tc_abl_pin, 1)
                pinned = _build.query("cuda", lib.nbt_sym_tc_pairs_ctas,
                                      _VARIANT_ID[k])
                ctas = f"{ctas}, pinned {pinned}"
                _build.query("cuda", lib.nbt_sym_tc_abl_pin, 0)
            slots = loop_slots(so, _MANGLED[k])
            print(f"[variants] {name}: {k} pairs kernel: "
                  + "; ".join(report) + f"; {ctas} CTAs an SM; "
                  + ("slots a pair not found" if slots is None else
                     f"{slots[0]:.3f} issue slots a pair, {slots[1]:.3f} "
                     f"of them LOP3 (column loop)"))
        libs[name] = lib
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.n + 10)
    pos = torch.empty(args.n, 3, device=dev).uniform_(-1e5, 1e5, generator=g)
    mass = torch.empty(args.n, device=dev).uniform_(1e5, 1e9, generator=g)

    def form(lib, k, pinned=False, reduce_fn=None):
        def run():
            if pinned:
                _build.query("cuda", lib.nbt_sym_tc_abl_pin, 1)
            try:
                return k2.sweep("sym_tc_variants", pos, mass, 0.002,
                                k2.SLOT_BUDGET_BYTES,
                                getattr(lib, f"nbt_sym_{k}_pairs"),
                                reduce_fn or reduce[k])
            finally:
                if pinned:
                    _build.query("cuda", lib.nbt_sym_tc_abl_pin, 0)
        return run
    # What is timed, by label: each variant's kernels (free and pinned for
    # tmm), and for tmm base's K5.
    runs = {}
    for name, lib in libs.items():
        for k in kernels:
            label = name if tier != "tmm" else f"{name} {k}"
            runs[label] = form(lib, k)
            if tier == "tmm":
                runs[f"{label} pinned"] = form(lib, k, True)
    if tier == "tmm":
        runs["base turbo (K5)"] = form(libs["base"], "turbo",
                                       reduce_fn=ref.nbt_sym_tc_reduce)
    for k in kernels:
        base = form(libs["base"], k)()
        for name, lib in libs.items():
            out = form(lib, k)()
            print(f"[variants] {name}: {k} output bit-equal to base: "
                  f"{bool(torch.equal(out, base))}"
                  + (f", pinned to itself: "
                     f"{bool(torch.equal(form(lib, k, True)(), out))}"
                     if tier == "tmm" else ""))
        del base
    names = list(runs)
    times = {k: [] for k in names}
    for r in range(args.rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(time_ms(runs[k], dev, iters=1, warmup=1))
    for k, v in times.items():
        print(f"[variants] {tier} N={args.n} {k}: median "
              f"{statistics.median(v):.3f} ms (rounds "
              + ", ".join(f"{t:.3f}" for t in v) + f") ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
