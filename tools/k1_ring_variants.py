#!/usr/bin/env python3
"""Time source-edited variants of K1 and of K13's exact tiles on the card.

    python3 tools/k1_ring_variants.py [--parent CSRC] [--rounds R]

Copies ``nbody_tpu_torch/csrc`` once per variant into
``build/k1_ring_variants/<name>/``, applies the variant's text edits,
builds ``forces_tiled.cu`` and ``rdma_ring.cu`` from each copy with the
port's nvcc flags (one nvcc each, all at once), prints the registers and
spills of K1's tile kernel and of K13's exact kernels (vpu2, vpu), checks
each variant's output against the unedited sources' (bit for bit where
the variant keeps the association) and times, in alternating rounds (the
order reversed every other round; medians):

- K1 (``forces_tiled``) at N = 8192 and on the 1M ring's 262,144 x 262,144
  antipodal sweep: ``base`` (four rows a lane, 128-thread blocks),
  ``rows8`` (eight rows a lane, 64-thread blocks: the same rows a block,
  tiles and slices, so the same sums bit for bit), and ``items1024`` /
  ``items4096`` (the base kernel with ``K1_ITEMS`` halved or doubled, so
  other slice counts: the same sums up to rounding);
- K13 (``rdma_ring``, vpu2 and vpu on 4 shards) at N = 8192 and
  1,048,576: ``base`` (vpu2 at two CTAs an SM, 128 registers; vpu at
  one), ``ctas1``, ``ctas2`` and ``ctas3`` (both exact variants built for
  one, two or three CTAs an SM; the tensor-core variants keep two), and
  with ``--parent`` the K13 of those sources (an earlier design, same C
  interface).

Needs a CUDA card and nvcc; about two minutes on one H100.
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
WORK = os.path.join(ROOT, "build", "k1_ring_variants")
_RING = "    return v == RING_VPU ? 1 : 2;"


def _ctas(k):
    return ("rdma_ring.cu", _RING, f"    return ring_is_tc(v) ? 2 : {k};")


# name -> (source edits, K1_ITEMS or None for the package's).
K1_VARIANTS = {
    "base": ([], None),
    "rows8": ([("forces_tiled.cu", "#define K1_ROWS 4",
                "#define K1_ROWS 8")], None),
    "items1024": ([], 1024),
    "items4096": ([], 4096),
}
RING_VARIANTS = {"base": [], "ctas1": [_ctas(1)], "ctas2": [_ctas(2)],
                 "ctas3": [_ctas(3)]}
# ptxas entries reported: K1's tile kernel, K13's vpu2 and vpu kernels.
_ENTRIES = ("k1_tile_kernel", "rdma_ring_kernelILi0E",
            "rdma_ring_kernelILi1E")


def build(name, src_dir, edits, libs):
    """Start nvcc on a copy of src_dir with ``edits``, one process a
    library; returns {lib: (path, process)}."""
    from nbody_tpu_torch.ops import _build
    src = os.path.join(WORK, name)
    shutil.copytree(src_dir, src)
    for fname, old, new in edits:
        path = os.path.join(src, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit of {fname} does not apply")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    jobs = {}
    for lib in libs:
        so = os.path.join(src, f"lib{lib}.so")
        jobs[lib] = (so, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
             os.path.join(src, f"{lib}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return jobs


def finish(name, jobs):
    """Wait for the builds of one variant, print its kernels' registers and
    spills; returns {lib: CDLL}."""
    out = {}
    for lib, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name} {lib}.cu: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            hit = [e for e in _ENTRIES if e in line and "Compiling" in line]
            if hit:
                report = [x.strip() for x in lines[i + 1:i + 4]
                          if "registers" in x or "spill" in x]
                print(f"[variants] {name}: {hit[0]}: " + "; ".join(report))
        out[lib] = ctypes.CDLL(so)
    return out


def rounds(fns, dev, iters, n_rounds, what, smi):
    from nbody_tpu_torch.utils.timing import time_ms
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(n_rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            times[k].append(time_ms(fns[k], dev, iters=iters, warmup=1))
    for k, v in times.items():
        print(f"[variants] {what} {k}: median {statistics.median(v):.4f} ms "
              f"(rounds " + ", ".join(f"{t:.4f}" for t in v) + f") ({smi})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="csrc of an earlier K13 to time too")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_ring_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch.ops import forces_tiled as k1
    from nbody_tpu_torch.parallel import rdma_ring as k13
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    smi = nvidia_smi_line()
    shutil.rmtree(WORK, ignore_errors=True)
    jobs = {f"k1_{n}": build(f"k1_{n}", CSRC, e, ("forces_tiled",))
            for n, (e, items) in K1_VARIANTS.items() if items is None}
    jobs.update({f"ring_{n}": build(f"ring_{n}", CSRC, e, ("rdma_ring",))
                 for n, e in RING_VARIANTS.items()})
    if args.parent:
        jobs["ring_parent"] = build("ring_parent", args.parent, [],
                                    ("rdma_ring",))
    built = {name: finish(name, j) for name, j in jobs.items()}
    dev = torch.device("cuda")
    eps2 = 0.002

    def bodies(n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        pos = torch.empty(n, 3, device=dev).uniform_(-1e5, 1e5, generator=g)
        mass = torch.empty(n, device=dev).uniform_(1e5, 1e9, generator=g)
        return pos, mass

    # K1.
    def k1_call(name, pi, pj, mj):
        edits, items = K1_VARIANTS[name]
        lib = k1.bind(built[f"k1_{'base' if items else name}"]
                      ["forces_tiled"])
        keep = k1.K1_ITEMS
        k1.K1_ITEMS = items or keep
        try:
            return k1._launch(pi, pj, mj, eps2, False, lib=lib)
        finally:
            k1.K1_ITEMS = keep
    pa, ma = bodies(1 << 18, 41)
    pb, mb = bodies(1 << 18, 42)
    p8, m8 = bodies(8192, 8192)
    for what, (pi, pj, mj), iters in (
            ("K1 N=8192", (p8, p8, m8), 20),
            ("K1 262,144 x 262,144", (pa, pb, mb), 1)):
        base = k1_call("base", pi, pj, mj)
        for name, (_, items) in K1_VARIANTS.items():
            got = k1_call(name, pi, pj, mj)
            diff = float((got - base).abs().max() / base.abs().max())
            slices = (f"K1_ITEMS={items}" if items else
                      k1.k1_slices(pi.shape[0], pj.shape[0])[0])
            print(f"[variants] {what} {name}: slices {slices}, bit-equal to "
                  f"base {bool(torch.equal(got, base))}, largest difference "
                  f"{diff:.3e} of max |a|")
        rounds({name: (lambda n=name: k1_call(n, pi, pj, mj))
                for name in K1_VARIANTS}, dev, iters, args.rounds, what,
               smi)
    del pa, ma, pb, mb

    # K13.
    ring_libs = {name.removeprefix("ring_"): k13.bind(libs["rdma_ring"])
                 for name, libs in built.items() if name.startswith("ring_")}
    for name, lib in ring_libs.items():
        print(f"[variants] K13 {name}: co-resident CTAs vpu2 "
              f"{k13.max_blocks('vpu2', lib)}, vpu "
              f"{k13.max_blocks('vpu', lib)}")
    for n, iters in ((8192, 20), (1 << 20, 1)):
        pos, mass = bodies(n, 3)
        for variant in ("vpu2", "vpu"):
            def call(lib, variant=variant):
                return k13._launch(pos, mass, 4, eps2, variant, False, False,
                                   k13.SLOT_BUDGET_BYTES, lib=lib)
            base = call(ring_libs["base"])
            for name, lib in ring_libs.items():
                got = call(lib)
                diff = float((got - base).abs().max() / base.abs().max())
                print(f"[variants] K13 {variant} N={n} P=4 {name}: bit-equal "
                      f"to base {bool(torch.equal(got, base))}, largest "
                      f"difference {diff:.3e} of max |a|")
            rounds({name: (lambda lib=lib: call(lib))
                    for name, lib in ring_libs.items()}, dev, iters,
                   args.rounds, f"K13 {variant} N={n} P=4", smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
