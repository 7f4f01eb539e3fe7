#!/usr/bin/env python3
"""Time source-edited variants of K8's row sums (``pe_rows``) on the card.

    python3 tools/pe_variants.py [--parent CSRC] [--rounds R]

Copies ``nbody_tpu_torch/csrc`` once per variant into
``build/pe_variants/<name>/``, applies the variant's text edits, builds
``pe.cu`` from each copy with the port's nvcc flags (one nvcc each, all at
once), prints the registers and spills of ``pe_rows_kernel`` and its CTAs
per SM, checks each variant's row sums against the unedited sources' (bit
for bit where the variant keeps the rows a block and the slices), against
the plain twin and against a float64 direct sum at 8192 x 8192, and
times, in alternating rounds (the order reversed every other round;
medians), the main path's 1024 rows against 8192 bodies and 8192 x 8192
(the card's time alone, ``chip_smoke.device_ms``), 262,144 x 262,144 and
1,048,576 x 1,048,576 (CUDA events):

- ``base``: the sources as they are (four rows a lane, 128-thread blocks,
  512 rows a block, ``PE_ITEMS`` work items);
- ``rows8``: eight rows a lane in 64-thread blocks, the same rows a
  block, tiles and slices, so the same sums bit for bit;
- ``r8b1024``: eight rows a lane in 128-thread blocks (1024 rows a block,
  half the row blocks, other slice counts: the same sums up to the
  float64 association of the slices);
- ``r4b256``: four rows a lane in 64-thread blocks, 256 rows a block;
- ``r2b256``: two rows a lane in 128-thread blocks, 256 rows a block;
- ``unroll4``, ``unroll16``: the column loop unrolled four or sixteen
  times, not eight (the same sums);
- ``items8192``, ``items32768``: the base kernel with ``PE_ITEMS`` halved
  or doubled, so other slice counts;
- with ``--parent``, the pe_rows of those sources (the one-thread-a-row
  design before the redesign, its own C entry).

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
WORK = os.path.join(ROOT, "build", "pe_variants")
_ROWS = "#define PR_ROWS 4"
_THREADS = "#define PR_THREADS 128"
_UNROLL = "#pragma unroll 8\n        for (int k = 0; k < PE_TILE; ++k) {"


def _rows(r):
    return ("pe.cu", _ROWS, f"#define PR_ROWS {r}")


def _threads(t):
    return ("pe.cu", _THREADS, f"#define PR_THREADS {t}")


def _unroll(u):
    return ("pe.cu", _UNROLL, _UNROLL.replace("unroll 8", f"unroll {u}"))


# name -> (source edits, PE_ITEMS or None for the package's).
VARIANTS = {
    "base": ([], None),
    "rows8": ([_rows(8), _threads(64)], None),
    "r8b1024": ([_rows(8)], None),
    "r4b256": ([_threads(64)], None),
    "r2b256": ([_rows(2)], None),
    "unroll4": ([_unroll(4)], None),
    "unroll16": ([_unroll(16)], None),
    "items8192": ([], 8192),
    "items32768": ([], 32768),
}
# (rows, bodies, seed, iters, the card's time alone).
SHAPES = ((1024, 8192, 81, 20, True), (8192, 8192, 81, 20, True),
          (1 << 18, 1 << 18, 83, 3, False), (1 << 20, 1 << 20, 84, 1, False))


def build(name, src_dir, edits):
    """Start nvcc on a copy of src_dir with ``edits``; returns (library
    path, process)."""
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
    so = os.path.join(src, "libpe.so")
    return so, subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so,
         os.path.join(src, "pe.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def finish(name, so, proc):
    """Wait for one build, print pe_rows_kernel's registers and spills;
    returns the library."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"{name} pe.cu: nvcc failed\n{log}")
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "pe_rows_kernel" in line:
            report = [x.strip() for x in lines[i + 1:i + 4]
                      if "registers" in x or "spill" in x]
            print(f"[variants] {name}: pe_rows_kernel: " + "; ".join(report))
    return ctypes.CDLL(so)


def pe_rows_parent(lib, pos_r, mass_r, pos_a, mass_a, eps2):
    """pe_rows through an earlier pe.cu (one thread a row): its C entry
    nbt_pe_rows(pos_r, mass_r, nr, pos_a, mass_a, na, eps2, out, stream)."""
    import torch
    from nbody_tpu_torch.ops import _build
    fn = lib.nbt_pe_rows
    if fn.argtypes is None:
        c_ll, c_ptr = ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [c_ptr, c_ptr, c_ll, c_ptr, c_ptr, c_ll,
                       ctypes.c_float, c_ptr, c_ptr]
        fn.restype = ctypes.c_int
    out = torch.empty(pos_r.shape[0], dtype=torch.float64,
                      device=pos_r.device)
    _build.launch("the parent's pe_rows", out, fn, pos_r.data_ptr(),
                  mass_r.data_ptr(), pos_r.shape[0], pos_a.data_ptr(),
                  mass_a.data_ptr(), pos_a.shape[0], float(eps2),
                  out.data_ptr())
    return out


def main():
    from nbody_tpu_torch.ops import _build
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="csrc of an earlier pe.cu to time too")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pe_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch.ops import pe
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    from nbody_tpu_torch.utils.timing import time_ms
    from chip_smoke import bodies, device_ms
    smi = nvidia_smi_line()
    shutil.rmtree(WORK, ignore_errors=True)
    jobs = {name: build(name, CSRC, edits)
            for name, (edits, items) in VARIANTS.items() if items is None}
    if args.parent:
        jobs["parent"] = build("parent", args.parent, [])
    built = {name: finish(name, *job) for name, job in jobs.items()}
    for name, lib in built.items():
        if name != "parent":
            pe.bind(lib)
            geo = [_build.query("cuda", lib.nbt_pe_geometry, k)
                   for k in (1, 2, 3)]
            print(f"[variants] {name}: {geo[0]} rows a block, {geo[1]} "
                  f"threads, {geo[2]} CTAs an SM")
    dev = torch.device("cuda")
    eps2 = 0.002

    def call(name, pr, mr, pa, ma):
        if name == "parent":
            return pe_rows_parent(built["parent"], pr, mr, pa, ma, eps2)
        items = VARIANTS[name][1]
        lib = built["base" if items else name]
        keep = pe.PE_BLOCK_ROWS, pe.PE_ITEMS
        pe.PE_BLOCK_ROWS, pe.PE_ITEMS = (
            _build.query(None, lib.nbt_pe_geometry, 1), items or keep[1])
        try:
            return pe.rows_sweep(lib, pr, mr, pa, ma, eps2)
        finally:
            pe.PE_BLOCK_ROWS, pe.PE_ITEMS = keep

    names = list(VARIANTS) + (["parent"] if args.parent else [])
    for nr, n, seed, iters, small in SHAPES:
        pa, ma = bodies(n, seed, dev)
        pr, mr = pa[:nr].contiguous(), ma[:nr].contiguous()
        what = f"pe_rows {nr} x {n}"
        base = call("base", pr, mr, pa, ma)
        ref = None
        if n <= 8192:
            twin = pe.pe_rows_plain(pr, mr, pa, ma, eps2)
            p64, m64 = pa.double(), ma.double()
            ref = m64[:nr] * (m64[None, :] / torch.sqrt(
                ((p64[None, :, :] - p64[:nr, None, :]) ** 2).sum(-1)
                + eps2)).sum(1)
        for name in names:
            got = call(name, pr, mr, pa, ma)
            line = (f"[variants] {what} {name}: bit-equal to base "
                    f"{bool(torch.equal(got, base))}, largest difference "
                    f"{float(((got - base) / base).abs().max()):.3e} of the "
                    f"row")
            if ref is not None:
                line += (f"; against the twin "
                         f"{float(((got - twin) / twin).abs().max()):.3e}, "
                         f"against float64 max / median "
                         f"{float(((got - ref) / ref).abs().max()):.3e} / "
                         f"{float(((got - ref) / ref).abs().median()):.3e}")
            print(line)
        fns = {name: (lambda k=name: call(k, pr, mr, pa, ma))
               for name in names}
        times = {k: [] for k in names}
        for r in range(args.rounds):
            for k in (names if r % 2 == 0 else names[::-1]):
                times[k].append(device_ms(fns[k], iters) if small else
                                time_ms(fns[k], dev, iters=iters, warmup=1))
        for k, v in times.items():
            print(f"[variants] {what}{', the card' if small else ''} {k}: "
                  f"median {statistics.median(v):.4f} ms (rounds "
                  + ", ".join(f"{t:.4f}" for t in v) + f") ({smi})")
        del pa, ma, pr, mr
    return 0


if __name__ == "__main__":
    sys.exit(main())
