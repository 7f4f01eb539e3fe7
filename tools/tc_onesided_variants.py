#!/usr/bin/env python3
"""Time source-edited variants of K9 / K10 (the one-sided tensor-core
tiers) on the card.

    python3 tools/tc_onesided_variants.py [--parent CSRC] [--rounds R]

Copies ``nbody_tpu_torch/csrc`` once per variant into
``build/tc_onesided_variants/<name>/``, applies the variant's text edits
to ``forces_tiled_tc.cu``, builds each copy with the port's nvcc flags (one
nvcc each, all at once), prints the registers and spills of the item
kernels, checks each variant against the package's twin at N = 1000 (the
square form and both rect forms) and against the unedited sources' output
(bit for bit where the slice count is the same, since the rows' sums are
then the same sequence of tile results), and times K9 and K10 at N = 8192
(the card's time alone) and 1,048,576 in alternating rounds (the order
reversed every other round; medians):

- ``base``: the sources (``TC_WARPS`` 4 warps a block, ``TC_RB`` two
  16-row mma blocks a warp, the 16-column loop unrolled twice for mxu and
  rolled for turbo);
- ``warps8``: eight warps a block; ``rb1`` / ``rb4``: one or four row
  blocks a warp; ``roll`` / ``unroll2``: the column loop rolled or
  unrolled twice for both tiers;
- ``items1024`` / ``items4096``: the base kernel with ``TC_ITEMS`` halved
  or doubled (other slice counts at 8192; one slice at 1M either way);
- with ``--parent``, the K9 / K10 of those sources (the design before
  (row block, j slice) items: one launch, ``nbt_forces_tiled_tc(pos_i,
  ni, pos_j, mass_j, nj, eps2, mxu, mask_self, acc, stream)``).

Needs a CUDA card and nvcc; about a minute on one H100.
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
WORK = os.path.join(ROOT, "build", "tc_onesided_variants")
_SRC = "forces_tiled_tc.cu"
_LOOP = "#pragma unroll (MXU ? 2 : 1)\n    for (int k0"

# name -> (edits of forces_tiled_tc.cu, TC_ITEMS or None for the package's).
VARIANTS = {
    "base": ([], None),
    "warps8": ([("#define TC_WARPS 4", "#define TC_WARPS 8")], None),
    "rb1": ([("#define TC_RB 2", "#define TC_RB 1")], None),
    "rb4": ([("#define TC_RB 2", "#define TC_RB 4")], None),
    "roll": ([(_LOOP, _LOOP.replace("(MXU ? 2 : 1)", "1"))], None),
    "unroll2": ([(_LOOP, _LOOP.replace("(MXU ? 2 : 1)", "2"))], None),
    "items1024": ([], 1024),
    "items4096": ([], 4096),
}


def build(name, src_dir, edits):
    """Start nvcc on a copy of src_dir with ``edits``; returns (path,
    process)."""
    from nbody_tpu_torch.ops import _build
    src = os.path.join(WORK, name)
    shutil.copytree(src_dir, src)
    path = os.path.join(src, _SRC)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the edit of {_SRC} does not apply")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(src, "libforces_tiled_tc.so")
    return so, subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(name, job):
    """Wait for a build, print its kernels' registers and spills; returns
    the CDLL."""
    so, proc = job
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"{name} {_SRC}: nvcc failed\n{log}")
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "reduce" not in line:
            report = [x.strip() for x in lines[i + 1:i + 4]
                      if "registers" in x or "spill" in x]
            print(f"[variants] {name}: {line.split('entry function')[-1]}: "
                  + "; ".join(report))
    return ctypes.CDLL(so)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="csrc of an earlier K9 / K10 to time")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tc_onesided_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import forces_tiled_tc as k910
    from nbody_tpu_torch.ops.forces_tiled import slice_plan
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    from nbody_tpu_torch.utils.timing import time_ms
    sys.path.insert(0, ROOT)
    from chip_smoke import TC_ABS_FLOOR, TC_REL_TOL, compare, device_ms
    smi = nvidia_smi_line()
    shutil.rmtree(WORK, ignore_errors=True)
    jobs = {n: build(n, CSRC, e) for n, (e, items) in VARIANTS.items()
            if items is None}
    if args.parent:
        jobs["parent"] = build("parent", args.parent, [])
    libs = {n: finish(n, j) for n, j in jobs.items()}
    for n, lib in libs.items():
        if n != "parent":
            k910.bind(lib)
    if args.parent:
        fn = libs["parent"].nbt_forces_tiled_tc
        c_ll, c_p = ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [c_p, c_ll, c_p, c_p, c_ll, ctypes.c_float,
                       ctypes.c_int, ctypes.c_int, c_p, c_p]
        fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    eps2 = 0.002

    def bodies(n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        pos = torch.empty(n, 3, device=dev).uniform_(-1e5, 1e5, generator=g)
        mass = torch.empty(n, device=dev).uniform_(1e5, 1e9, generator=g)
        return pos, mass

    def plan(name, ni, nj):
        items = VARIANTS.get(name, ([], None))[1]
        lib = libs["base" if items else name]
        rows = _build.query(None, lib.nbt_tiled_tc_geometry, 1)
        return lib, slice_plan(ni, nj, k910.TC_TILE_J, rows,
                               items or k910.TC_ITEMS, 12)

    def call(name, pi, pj, mj, variant, self_tile):
        acc = torch.empty_like(pi)
        if name == "parent":
            _build.launch(f"{name} {variant}", acc,
                          libs["parent"].nbt_forces_tiled_tc, pi.data_ptr(),
                          pi.shape[0], pj.data_ptr(), mj.data_ptr(),
                          pj.shape[0], eps2, int(variant == "mxu"),
                          int(self_tile), acc.data_ptr())
        else:
            lib, (slices, tps) = plan(name, pi.shape[0], pj.shape[0])
            slots = (pi.new_empty(slices * pi.shape[0] * 3) if slices > 1
                     else None)
            _build.launch(f"{name} {variant}", acc, lib.nbt_forces_tiled_tc,
                          pi.data_ptr(), pi.shape[0], pj.data_ptr(),
                          mj.data_ptr(), pj.shape[0], tps, slices, eps2,
                          int(variant == "mxu"), int(self_tile),
                          slots.data_ptr() if slots is not None else None,
                          acc.data_ptr())
        return acc

    names = [n for n in VARIANTS] + (["parent"] if args.parent else [])
    # Every variant against the twin: square, rect with self_tile (i a
    # prefix of j) and rect of disjoint sets.
    p1, m1 = bodies(1000, 1000)
    p2, _ = bodies(300, 300)
    for variant in k910.VARIANTS:
        for form, (pi, pj, mj, st) in (
                ("square", (p1, p1, m1, True)),
                ("rect self_tile", (p1[:300].contiguous(), p1, m1, True)),
                ("rect disjoint", (p2, p1, m1, False))):
            want = k910.rect_forces_tiled_tc_plain(pi, pj, mj, eps2, variant,
                                                   st)
            for name in names:
                compare(f"{name} {variant} {form} N=1000 vs twin",
                        call(name, pi, pj, mj, variant, st), want,
                        rel_tol=TC_REL_TOL, abs_floor=TC_ABS_FLOOR)
    for n, iters in ((8192, 20), (1 << 20, 1)):
        pos, mass = bodies(n, 41)
        for variant in k910.VARIANTS:
            what = f"{variant} N={n}"
            base = call("base", pos, pos, mass, variant, True)
            for name in names:
                got = call(name, pos, pos, mass, variant, True)
                diff = float((got - base).abs().max() / base.abs().max())
                slices = ("one launch" if name == "parent" else
                          plan(name, n, n)[1][0])
                print(f"[variants] {what} {name}: slices {slices}, "
                      f"bit-equal to base {bool(torch.equal(got, base))}, "
                      f"largest difference {diff:.3e} of max |a|")
            fns = {name: (lambda k=name: call(k, pos, pos, mass, variant,
                                              True)) for name in names}
            times = {k: [] for k in names}
            for r in range(args.rounds):
                for k in (names if r % 2 == 0 else names[::-1]):
                    times[k].append(device_ms(fns[k], iters) if n <= 8192
                                    else time_ms(fns[k], dev, iters=iters,
                                                 warmup=1))
            for k, v in times.items():
                print(f"[variants] {what} {k}: median "
                      f"{statistics.median(v):.4f} ms (rounds "
                      + ", ".join(f"{t:.4f}" for t in v)
                      + f"{'; the card' if n <= 8192 else ''}) ({smi})")
        del pos, mass
    return 0


if __name__ == "__main__":
    sys.exit(main())
