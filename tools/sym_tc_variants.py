#!/usr/bin/env python3
"""Time source-edited variants of K5's pair pass on the card.

    python3 tools/sym_tc_variants.py [--n N] [--rounds R]

Copies ``nbody_tpu_torch/csrc`` once per variant into
``build/sym_tc_variants/<name>/``, applies the variant's text edits, builds
``forces_sym_tc.cu`` from each copy with the port's nvcc flags (one nvcc
each, all at once), and times one K5 evaluation (``forces_sym_turbo``'s
sweep: the pair passes and the reduce passes) at N bodies (default
1,048,576) for every variant in alternating rounds (the order reversed
every other round).  Prints each variant's registers and spills for
K5's pair kernel, whether its output is bit-equal to the unedited
source's, the rounds and their median.  The variants are the levers the
redesign of K5's geometry weighed:

- ``base``: the sources as they are (the 16-column loop of K5's tile
  unrolled twice, 80 registers, three CTAs an SM);
- ``unroll1``, ``unroll4``: the loop rolled, or unrolled four times;
- ``ctas4``, ``ctas4_unroll1``: K5's pair kernels held to 64 registers,
  four CTAs an SM, with the loop unrolled twice or rolled;
- ``trunc_bf16``: a diagnostic, not a candidate: the bf16 weights by
  truncation through one byte permute in place of the rounding convert
  (F2FP), which prices the convert; its output differs by design.

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
_CTAS4 = ("forces_sym_tc.cu", _KERNEL,
          "template <int V>\n__global__ void __launch_bounds__(SYM_TILE, "
          "tc_trimmed(V) ? 4 : 1)\nsym_tc_pairs_kernel(")
_UNROLL = "#pragma unroll (TRIM ? 2 : 1)"


def _unroll(times):
    return ("sym_tc_tile.cuh", _UNROLL,
            f"#pragma unroll (TRIM ? {times} : 1)")


VARIANTS = {
    "base": [],
    "unroll1": [_unroll(1)],
    "unroll4": [_unroll(4)],
    "ctas4": [_CTAS4],
    "ctas4_unroll1": [_CTAS4, _unroll(1)],
    "trunc_bf16": [(
        "tc_common.cuh",
        "    return bf16x2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));",
        "    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), "
        "0x7632);")],
}


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
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sym_tc_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.ops import forces_sym_tc as k5
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    from nbody_tpu_torch.utils.timing import time_ms
    smi = nvidia_smi_line()
    shutil.rmtree(WORK, ignore_errors=True)
    jobs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    ref = k5._lib()
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function '_Z19sym_tc_pairs_kernelILi0E" in line:
                report = [x.strip() for x in lines[i + 1:i + 4]
                          if "registers" in x or "spill" in x]
                print(f"[variants] {name}: K5 pairs kernel: "
                      + "; ".join(report))
        lib = ctypes.CDLL(so)
        for fn in ("nbt_sym_turbo_pairs", "nbt_sym_tc_reduce"):
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.n + 10)
    pos = torch.empty(args.n, 3, device=dev).uniform_(-1e5, 1e5, generator=g)
    mass = torch.empty(args.n, device=dev).uniform_(1e5, 1e9, generator=g)

    def run(lib):
        return k2.sweep("sym_tc_variants", pos, mass, 0.002,
                        k2.SLOT_BUDGET_BYTES, lib.nbt_sym_turbo_pairs,
                        lib.nbt_sym_tc_reduce)
    base = run(libs["base"])
    for name, lib in libs.items():
        print(f"[variants] {name}: output bit-equal to base: "
              f"{bool(torch.equal(run(lib), base))}")
    names = list(libs)
    times = {k: [] for k in names}
    for r in range(args.rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(time_ms(lambda: run(libs[k]), dev, iters=1,
                                    warmup=1))
    for k, v in times.items():
        print(f"[variants] N={args.n} {k}: median "
              f"{statistics.median(v):.3f} ms (rounds "
              + ", ".join(f"{t:.3f}" for t in v) + f") ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
