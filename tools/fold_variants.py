#!/usr/bin/env python3
"""Time variants of K14d (the fold schedule, K2's and K7's math) and the
K2-rect folds on the card.

    python3 tools/fold_variants.py [--parent CSRC] [--rounds R]

Copies ``nbody_tpu_torch/csrc`` once per variant into
``build/fold_variants/<name>/``, applies the variant's text edits to
``forces_sym.cu``, builds each copy with the port's nvcc flags (one nvcc
each, all at once), prints the registers, stack and spills of the fold
kernels and their CTAs an SM, checks each variant against the package's
twins at N = 2500 and at 2144 x 1536 (A padded to whole superblocks) at
U = 1024, and times the square folds at N = 8192 (the card's time alone)
and 1,048,576 and the rect folds at 2048 x 2048 (the card's time) and
262,144 x 262,144, in alternating rounds (the order reversed every other
round; medians), then each variant's pair pass and reduce pass apart at
N = 8192 and 1M by partial launches (chip_smoke.py fold_sweep):

- ``auto``: the sources (a cluster of ``sub`` CTAs an item where one CTA
  an item would leave CTA slots of the card empty, else one CTA an item;
  the diagonal superblocks on K1's one-sided tile);
- ``cluster``: the sources with every item on a cluster (``FOLD_CLUSTER``);
- ``cta``: the sources with one CTA an item everywhere (``FOLD_CTA``), the
  grid of the design before the clusters, on the pair tile;
- ``olddiag``: ``auto`` with the reduce's former diagonal superblock, one
  body a thread over the superblock's u bodies with rsqrtf (fold_diag);
- with ``--parent``, the sources of an earlier commit with the same C
  entries (the design before this one).

The first three give the same bits.  Needs a CUDA card and nvcc; about
two minutes on one H100.
"""

import argparse
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "nbody_tpu_torch", "csrc")
WORK = os.path.join(ROOT, "build", "fold_variants")
_SRC = "forces_sym.cu"

# The olddiag variant: the former diagonal superblock in the
# reduce (one body a thread, rsqrtf, a massless row of K2's math over all
# N bodies), and no fold_diag_kernel launch.
_OLD_DIAG = """__device__ __forceinline__ float3 fold_diag(
        const float* __restrict__ pos, const float* __restrict__ mass,
        long long n, long long b, long long u, float eps2, float4* tile,
        bool row_if_massless) {
    const int t = threadIdx.x;
    const long long base = (b / u) * u;
    const float4 bi = load_body(pos, mass, b, n);
    const bool row = row_if_massless && b < n && bi.w == 0.f;
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (long long c0 = 0; c0 < u; c0 += SYM_TILE) {
        __syncthreads();
        tile[t] = load_body(pos, mass, base + c0 + t, n);
        __syncthreads();
        if (row) continue;
#pragma unroll 8
        for (int k = 0; k < SYM_TILE; ++k) {
            const float4 q = tile[k];
            const float dx = q.x - bi.x;
            const float dy = q.y - bi.y;
            const float dz = q.z - bi.z;
            const float d2 = dx * dx + dy * dy + dz * dz + eps2;
            const float f = q.w * rsqrtf(d2 * d2 * d2);
            ax += f * dx;
            ay += f * dy;
            az += f * dz;
        }
    }
    if (row) {
        for (long long jj = 0; jj < n; ++jj) {
            const float dx = pos[3 * jj] - bi.x;
            const float dy = pos[3 * jj + 1] - bi.y;
            const float dz = pos[3 * jj + 2] - bi.z;
            const float d2 = dx * dx + dy * dy + dz * dz + eps2;
            const float f = mass[jj] * rsqrtf(d2 * d2 * d2);
            ax += f * dx;
            ay += f * dy;
            az += f * dz;
        }
    }
    return make_float3(ax, ay, az);
}

"""
_REDUCE_HEAD = """    const long long u = (long long)sub * SYM_TILE;
    const long long n_pad = nb * u;
    const long long b = (long long)blockIdx.x * SYM_TILE + threadIdx.x;
    const long long I = b / u;
"""
_REDUCE_TAIL = """    if (b >= n) return;
    const float3 d = make_float3(out[3 * b], out[3 * b + 1], out[3 * b + 2]);
    float3 a;
    if (K7)
        a = make_float3(d.x + s.x, d.y + s.y, d.z + s.z);
    else if (mass[b] == 0.f)
        a = rect_finish(s, 0.f, load_body(pos, mass, b, n), pos, mass, n, 1,
                        eps2);
    else
        a = sym_descale(d, s, mass[b]);
"""
_OLD_TAIL = """    const float3 d = fold_diag(pos, mass, n, b, u, eps2, tile, !K7);
    if (b >= n) return;
    const float3 a = K7 ? make_float3(d.x + s.x, d.y + s.y, d.z + s.z)
                        : sym_descale(d, s, mass[b]);
"""
_DIAG_LAUNCH = re.compile(r"    if \(last\) \{\n        fold_diag_kernel<<<.*?"
                          r"\n    \}\n", re.S)

# name -> ([(old text or compiled pattern, new text)] edits of
# forces_sym.cu, the FoldMode set on the library).
VARIANTS = {
    "auto": ([], 0),
    "cluster": ([], 1),
    "cta": ([], 2),
    "olddiag": ([
        ("// One thread a body (nb * sub CTAs of SYM_TILE)",
         _OLD_DIAG + "// One thread a body (nb * sub CTAs of SYM_TILE)"),
        (_REDUCE_HEAD, "    __shared__ float4 tile[SYM_TILE];\n"
         + _REDUCE_HEAD),
        (_REDUCE_TAIL, _OLD_TAIL),
        (_DIAG_LAUNCH, "")], 0),
}


def variant_source(src_dir, edits):
    """forces_sym.cu of ``src_dir`` with ``edits`` applied; each must match
    exactly once."""
    with open(os.path.join(src_dir, _SRC)) as f:
        text = f.read()
    for old, new in edits:
        if isinstance(old, str):
            count = text.count(old)
            text = text.replace(old, new)
        else:
            text, count = old.subn(lambda _: new, text)
        if count != 1:
            raise SystemExit(f"the edit {str(old)[:60]!r} of {_SRC} matches "
                             f"{count} times")
    return text


def build(name, src_dir, edits):
    """Start nvcc on a copy of src_dir with ``edits``; returns (path,
    process)."""
    from nbody_tpu_torch.ops import _build
    src = os.path.join(WORK, name)
    shutil.copytree(src_dir, src)
    path = os.path.join(src, _SRC)
    text = variant_source(src_dir, edits)
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(src, "libforces_sym.so")
    return so, subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(name, job):
    """Wait for a build, print its fold kernels' registers and spills;
    returns the CDLL."""
    so, proc = job
    log, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"{name} {_SRC}: nvcc failed\n{log}")
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "fold" in line:
            report = [x.strip() for x in lines[i + 1:i + 4]
                      if "registers" in x or "spill" in x or "stack" in x]
            print(f"[variants] {name}: {line.split('entry function')[-1]}: "
                  + "; ".join(report))
    return ctypes.CDLL(so)


def main():
    from nbody_tpu_torch.ops import _build
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="csrc of an earlier fold to time")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fold_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from nbody_tpu_torch.ops import forces_sym as k2
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    from nbody_tpu_torch.utils.timing import time_ms
    from chip_smoke import (FOLD_KERNELS, RECT_1M, bodies, compare,
                            device_ms, fold_sweep)
    smi = nvidia_smi_line()
    shutil.rmtree(WORK, ignore_errors=True)
    jobs = {n: build(n, CSRC, e) for n, (e, _) in VARIANTS.items()}
    if args.parent:
        jobs["parent"] = build("parent", args.parent, [])
    libs = {n: finish(n, j) for n, j in jobs.items()}
    for name, lib in libs.items():
        k2.bind(lib)
        if name in VARIANTS:
            _build.query(None, lib.nbt_sym_fold_mode, VARIANTS[name][1])
            print(f"[variants] {name}: CTAs an SM, fold pairs K2 / K7, "
                  f"rect K2 / K7: " + ", ".join(
                      str(_build.query("cuda", lib.nbt_sym_fold_per_sm, k7,
                                       rect))
                      for rect in (0, 1) for k7 in (0, 1)))
    dev = torch.device("cuda")
    eps2 = 0.002
    u = k2.FOLD_BLOCK_U
    names = list(libs)

    # Every variant against the twins.
    pos, mass = bodies(2500, 2513, dev)
    pa, ma = bodies(2144, 2165, dev)
    pb, mb = bodies(1536, 1558, dev)
    for kname, (k7, rect) in FOLD_KERNELS.items():
        if rect:
            want = k2.rect_forces_sym_plain(pa, ma, pb, mb, eps2, k7, u)
            for name in names:
                got = fold_sweep(libs[name], kname, (pa, ma, pb, mb), eps2)
                for side, g, w in zip("ab", got, want):
                    compare(f"{name} {kname} acc_{side} 2144x1536 vs twin",
                            g, w)
        else:
            plain = k2.forces_sym_vpu_plain if k7 else k2.forces_sym_plain
            want = plain(pos, mass, eps2, block_u=u)
            for name in names:
                compare(f"{name} {kname} N=2500 vs twin",
                        fold_sweep(libs[name], kname, (pos, mass), eps2),
                        want)

    def flat(out):
        return torch.cat(out) if isinstance(out, tuple) else out

    for kname, (k7, rect) in FOLD_KERNELS.items():
        shapes = (((2048, 20), (RECT_1M, 1)) if rect
                  else ((8192, 20), (1 << 20, 1)))
        for n, iters in shapes:
            args_ = ((*bodies(n, 41, dev), *bodies(n, 42, dev)) if rect
                     else bodies(n, 41, dev))
            what = f"{kname} {f'{n}x{n}' if rect else f'N={n}'}"
            base = flat(fold_sweep(libs["auto"], kname, args_, eps2))
            for name in names:
                got = flat(fold_sweep(libs[name], kname, args_, eps2))
                diff = float((got - base).abs().max() / base.abs().max())
                print(f"[variants] {what} {name}: bit-equal to auto "
                      f"{bool(torch.equal(got, base))}, largest difference "
                      f"{diff:.3e} of max |a|")
            del got, base
            small = n <= 8192
            fns = {name: (lambda k=name: fold_sweep(libs[k], kname, args_,
                                                    eps2))
                   for name in names}
            times = {k: [] for k in names}
            for r in range(args.rounds):
                for k in (names if r % 2 == 0 else names[::-1]):
                    times[k].append(device_ms(fns[k], iters) if small
                                    else time_ms(fns[k], dev, iters=iters,
                                                 warmup=1))
            for k, v in times.items():
                print(f"[variants] {what} {k}: median "
                      f"{statistics.median(v):.4f} ms (rounds "
                      + ", ".join(f"{t:.4f}" for t in v)
                      + f"{'; the card' if small else ''}) ({smi})")
            if not rect:
                for name in names:
                    ms = {}
                    for part in ("pairs", "reduce"):
                        def fn(lib=libs[name], part=part):
                            return fold_sweep(lib, kname, args_, eps2, part)
                        ms[part] = (device_ms(fn, iters) if small else
                                    time_ms(fn, dev, iters=iters, warmup=1))
                    print(f"[variants] {what} {name} by pass"
                          f"{'; the card' if small else ''}: pairs "
                          f"{ms['pairs']:.4f} ms, reduce {ms['reduce']:.4f} "
                          f"ms ({smi})")
            del args_
    return 0


if __name__ == "__main__":
    sys.exit(main())
