#!/usr/bin/env python3
"""Time source-edited variants of K3's (and K4's) schedule on the card, and
split a step of the schedule before it by phase.

    python3 tools/resident_variants.py [--n N ...] [--rounds R]
        [--steps S]

Copies ``nbody_tpu_torch/csrc`` once per variant into
``build/resident_variants/<name>/``, applies the variant's text edits,
appends the bench-only split kernel below to the copy's ``resident.cu``,
builds it with the port's nvcc flags (one nvcc each, all at once), and
then:

- runs S steps (default 1000) of K3 at each N (default 8192, 12288 and
  16384) and 100 Yoshida4 steps of K4 at 8192 through every variant in
  alternating rounds (the order reversed every other round), and prints
  whether each variant's pos, vel and acc are bit-equal to ``base``'s and
  the rounds with their median;
- splits a step at N = 8192 by phase, one launch of S steps of each mode
  of the split kernel on the schedule before the dataflow (its grid: a
  step's items with the half offset's skipped ones, at most the
  co-resident blocks), every phase followed by one grid sync: phase (a)
  alone, phase (b) as it ran there (blocks 0 .. nb - 1, one thread a
  body), phase (b) as the variant's finish groups run it (spread over the
  grid; the counts they wait for set to a step's worth), and the two
  grid syncs alone; medians of three.  Phase (b) runs on zero slots.

The variants are the finish groups' two ways of adding a body's slots:

- ``base``: the sources as they are: the warp stages its 32 bodies' slots
  in the block's shared memory (``SymPairSmem::part``, split among the
  warps that take groups) with asynchronous 16-byte copies, as many
  offsets a round as its share holds, waits once a round, and adds in
  ``sym_slot_sum``'s order;
- ``direct``: each lane adds its body's slots with K2's own
  ``sym_slot_sum``, its loads from L2 as the compiler schedules them.

Needs a CUDA card and nvcc; takes about two minutes on one H100.
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
WORK = os.path.join(ROOT, "build", "resident_variants")

_STAGING = ("__device__ __forceinline__ void cp_async16(",
            "// What a body's integrator reads")
_GROUPS = ("// Phase (b) of step k for this warp:",
           "__global__ void __launch_bounds__(SYM_TILE, 2)\nresident_kernel(")
_GROUPS_DIRECT = r'''// Phase (b) of step k for this warp: its groups (group q: row tile q / 8,
// bodies 32 (q mod 8) .. of it), each once its tile's nb contributions of
// step k are in.  For body b < n: pre(b) loads its position and velocity
// before the wait (a group runs on the same warp every step, so these are
// the lane's own stores of the step before, or the launch's inputs); the
// lane adds b's slots with K2's sym_slot_sum (its order, its code), and
// body(b, a, p) does the integrator with acceleration a.  Then one count
// of the tile's done groups.
template <class Pre, class Body>
__device__ __forceinline__ void step_groups_of_warp(
        int k, const float* __restrict__ mass, long long n, long long nb,
        const float* diag, const float* si, const float* sj, const u64* cnt,
        u64* done, Pre pre, Body body) {
    const int wa = group_warps(nb, gridDim.x);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= wa) return;
    const u64 in = (u64)nb * (k + 1);
    for (long long q = blockIdx.x + (long long)gridDim.x * warp;
         q < SYM_WARPS * nb; q += (long long)gridDim.x * wa) {
        const long long T = q / SYM_WARPS;
        const long long b = T * SYM_TILE + 32 * (q % SYM_WARPS) + lane;
        BodyState p = {};
        float m = 0.f;
        if (b < n) {
            p = pre(b);
            m = mass[b];
        }
        if (lane == 0) wait_at_least(cnt + T, in);
        __syncwarp();
        if (b < n) {
            const float3 s = sym_slot_sum(make_float3(0.f, 0.f, 0.f), nb, T,
                                          b, 1, nb / 2, si, sj);
            const float3 dg = make_float3(__ldcg(diag + 3 * b),
                                          __ldcg(diag + 3 * b + 1),
                                          __ldcg(diag + 3 * b + 2));
            body(b, sym_descale(dg, s, m), p);
        }
        __syncwarp();
        if (lane == 0) release_add(done + T);
    }
}

'''
_CALL = "k, mass, n, nb, diag, si, sj, cnt, done, sm,\n"

# name: the edits of resident.cu, each (old, new, count) of text or
# ((start, end), new) of the region from start up to end.
VARIANTS = {
    "base": [],
    "direct": [(_STAGING, ""), (_GROUPS, _GROUPS_DIRECT),
               (_CALL, "k, mass, n, nb, diag, si, sj, cnt, done,\n", 2)],
}

# The schedule before the dataflow, one phase at a time, each followed by
# a grid sync, n_steps times: mode 0 phase (a), the grid-stride sweep over
# the diagonal items and every (row tile, offset) item (the half offset's
# skipped ones included); mode 1 phase (b) as it ran, one thread a body
# over blocks 0 .. nb - 1, sym_slot_sum and the reference update in place;
# mode 2 phase (b) as the variant's finish groups, into pos_tmp (flags:
# the counts at a step's worth of contributions); mode 3 the step's two
# grid syncs alone.
_SPLIT = r'''
__global__ void __launch_bounds__(SYM_TILE)
resident_split_kernel(int mode, const float* __restrict__ mass, long long n,
                      long long nb, float eps2, float h, float dt,
                      int n_steps, float* pos, float* vel, float* pos_tmp,
                      float* diag, float* si, float* sj, u64* flags) {
    __shared__ SymPairSmem sm;
    cg::grid_group grid = cg::this_grid();
    const long long n_off = nb / 2;
    for (int k = 0; k < n_steps; ++k) {
        if (mode == 0) {
            for (long long w = blockIdx.x; w < nb * (1 + n_off);
                 w += gridDim.x) {
                if (w < nb) {
                    const long long b = w * SYM_TILE + threadIdx.x;
                    const float3 d = sym_diag(pos, mass, n, b, eps2, sm.tile);
                    if (b < n) {
                        diag[3 * b] = d.x;
                        diag[3 * b + 1] = d.y;
                        diag[3 * b + 2] = d.z;
                    }
                    __syncthreads();
                    continue;
                }
                const long long dk = (w - nb) / nb;
                const long long I = (w - nb) - dk * nb;
                if (2 * (1 + dk) == nb && 2 * I >= nb) continue;
                sym_pair_tile(pos, mass, n, nb, I, 1 + dk, dk, eps2, si, sj,
                              sm);
            }
        } else if (mode == 1) {
            for (long long b = (long long)blockIdx.x * SYM_TILE + threadIdx.x;
                 b < n; b += (long long)gridDim.x * SYM_TILE) {
                const float3 s = sym_slot_sum(make_float3(0.f, 0.f, 0.f), nb,
                                              b / SYM_TILE, b, 1, n_off, si,
                                              sj);
                const float3 a = sym_descale(
                    make_float3(diag[3 * b], diag[3 * b + 1], diag[3 * b + 2]),
                    s, mass[b]);
                const float ac[3] = {a.x, a.y, a.z};
                for (int c = 0; c < 3; ++c) {
                    const float v = __fadd_rn(vel[3 * b + c],
                                              __fmul_rn(h, ac[c]));
                    pos[3 * b + c] = __fadd_rn(pos[3 * b + c],
                                               __fmul_rn(dt, v));
                    vel[3 * b + c] = v;
                }
            }
        } else if (mode == 2) {
            step_groups_of_warp(
                0, mass, n, nb, diag, si, sj, flags, flags + nb, {sm}
                [&](long long b) { return body_state(pos, vel, b); },
                [&](long long b, float3 a, const BodyState& p) {
                const float ac[3] = {a.x, a.y, a.z};
                for (int c = 0; c < 3; ++c) {
                    const float v = __fadd_rn(p.v[c], __fmul_rn(h, ac[c]));
                    pos_tmp[3 * b + c] = __fadd_rn(p.x[c], __fmul_rn(dt, v));
                    vel[3 * b + c] = v;
                }
            });
        } else {
            grid.sync();
        }
        grid.sync();
    }
}

extern "C" int nbt_resident_split(int mode, const float* mass, long long n,
                                  long long nb, float eps2, float h, float dt,
                                  int n_steps, float* pos, float* vel,
                                  float* pos_tmp, float* diag, float* si,
                                  float* sj, u64* flags, void* stream) {
    if (n_steps <= 0 || n <= 0 || mode < 0 || mode > 3) return 0;
    const int cap = coresident_blocks((const void*)resident_split_kernel);
    const long long work = nb * (1 + nb / 2);
    if (cap <= 0) return (int)cudaErrorInvalidConfiguration;
    const unsigned grid = (unsigned)(work < cap ? work : cap);
    void* args[] = {&mode, &mass, &n, &nb, &eps2, &h, &dt, &n_steps, &pos,
                    &vel, &pos_tmp, &diag, &si, &sj, &flags};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)resident_split_kernel, dim3(grid), dim3(SYM_TILE), args,
        0, (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
'''
# The kernels, by their mangled names' prefixes.
_KERNELS = ("_Z15resident_kernel", "_Z19resident_kdk_kernel",
            "_Z21resident_split_kernel")


def build(name, edits):
    """Start nvcc on the edited copy; returns (library path, process)."""
    from nbody_tpu_torch.ops import _build
    src = os.path.join(WORK, name)
    shutil.copytree(CSRC, src)
    path = os.path.join(src, "resident.cu")
    with open(path) as f:
        text = f.read()
    for old, new, *count in edits:
        if isinstance(old, tuple):
            a, b = text.index(old[0]), text.index(old[1])
            text = text[:a] + new + text[b:]
            continue
        if text.count(old) != count[0]:
            raise SystemExit(f"{name}: an edit of resident.cu does not apply")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text + _SPLIT.replace("{sm}", "" if name == "direct"
                                      else "sm,"))
    so = os.path.join(src, "libresident.so")
    return so, subprocess.Popen(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[8192, 12288, 16384])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps", type=int, default=1000)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("resident_variants: needs a CUDA card", file=sys.stderr)
        return 1
    import nbody_tpu_torch as nt
    from nbody_tpu_torch.models.integrators import KDK_WEIGHTS
    from nbody_tpu_torch.ops import _build, resident
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    from nbody_tpu_torch.utils.timing import time_ms
    smi = nvidia_smi_line()
    shutil.rmtree(WORK, ignore_errors=True)
    jobs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    ref = resident._lib()
    c_ptr, c_ll, c_int, c_f = (ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_float)
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            for k in _KERNELS:
                if f"Compiling entry function '{k}" in line:
                    report = [x.strip() for x in lines[i + 1:i + 4]
                              if "registers" in x or "spill" in x]
                    print(f"[variants] {name}: {k[k.index('r'):]}: "
                          + "; ".join(report))
        lib = ctypes.CDLL(so)
        for fn in ("nbt_resident", "nbt_resident_kdk"):
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = c_int
        lib.nbt_resident_split.argtypes = [
            c_int, c_ptr, c_ll, c_ll, c_f, c_f, c_f, c_int] + [c_ptr] * 8
        lib.nbt_resident_split.restype = c_int
        libs[name] = lib
    dev = torch.device("cuda")

    def k3(lib, st, cfg, steps):
        nb, pos_tmp, diag, si, sj, flags = resident._scratch(st.pos)
        out = [torch.empty_like(st.pos) for _ in range(3)]
        _build.launch("resident (K3)", st.pos, lib.nbt_resident,
                      st.pos.data_ptr(), st.vel.data_ptr(),
                      st.mass.data_ptr(), st.pos.shape[0], nb, cfg.eps2,
                      0.5 * cfg.dt, cfg.dt, steps,
                      *(o.data_ptr() for o in out), pos_tmp.data_ptr(),
                      diag.data_ptr(), si.data_ptr(), sj.data_ptr(),
                      flags.data_ptr())
        return out

    def k4(lib, st, cfg, steps):
        nb, pos_tmp, diag, si, sj, flags = resident._scratch(st.pos)
        w = KDK_WEIGHTS[cfg.integrator]
        h = (c_f * 3)(*[0.5 * (x * cfg.dt) for x in w])
        wdt = (c_f * 3)(*[x * cfg.dt for x in w])
        out = [torch.empty_like(st.pos) for _ in range(3)]
        _build.launch("resident (K4)", st.pos, lib.nbt_resident_kdk,
                      st.pos.data_ptr(), st.vel.data_ptr(),
                      st.acc.data_ptr(), st.mass.data_ptr(),
                      st.pos.shape[0], nb, cfg.eps2, h, wdt, len(w), steps,
                      *(o.data_ptr() for o in out), pos_tmp.data_ptr(),
                      diag.data_ptr(), si.data_ptr(), sj.data_ptr(),
                      flags.data_ptr())
        return out

    runs = [("K3", "reference", n, args.steps) for n in args.n]
    runs.append(("K4", "yoshida4", 8192, 100))
    for kname, integrator, n, steps in runs:
        cfg = nt.SimConfig(n_bodies=n, impl="pallas_sym2",
                           integrator=integrator)
        st = nt.init_state(cfg)
        fn = k3
        if integrator != "reference":
            st, fn = nt.ops.step.prime_kdk(st, cfg), k4
        base = fn(libs["base"], st, cfg, steps)
        what = f"{kname} N={n}, {steps} {integrator} steps"
        for name, lib in libs.items():
            same = all(torch.equal(a, b)
                       for a, b in zip(fn(lib, st, cfg, steps), base))
            print(f"[variants] {what}: {name} pos, vel, acc bit-equal to "
                  f"base: {same}")
        names = list(libs)
        times = {k: [] for k in names}
        for r in range(args.rounds):
            for k in (names if r % 2 == 0 else names[::-1]):
                times[k].append(time_ms(lambda: fn(libs[k], st, cfg, steps),
                                        dev, iters=1, warmup=1))
        for k, v in times.items():
            print(f"[variants] {what} {k}: median "
                  f"{statistics.median(v):.4f} ms (rounds "
                  + ", ".join(f"{t:.4f}" for t in v) + f") ({smi})")

    # The split at N = 8192.
    cfg = nt.SimConfig(n_bodies=8192, impl="pallas_sym2")
    st = nt.init_state(cfg)
    n, steps = st.pos.shape[0], args.steps
    nb, pos_tmp, diag, si, sj, flags = resident._scratch(st.pos)
    pos, vel = st.pos.clone(), st.vel.clone()
    diag.zero_()
    si.zero_()
    sj.zero_()
    flags[:nb] = nb      # mode 2's groups find their tiles' contributions
    modes = ("phase (a) + 1 sync", "phase (b) as it ran + 1 sync",
             "phase (b) as the finish groups + 1 sync", "2 syncs")
    for name, lib in libs.items():
        def split(mode):
            _build.launch(f"split {mode}", pos, lib.nbt_resident_split,
                          mode, st.mass.data_ptr(), n, nb, cfg.eps2,
                          0.5 * cfg.dt, cfg.dt, steps, pos.data_ptr(),
                          vel.data_ptr(), pos_tmp.data_ptr(), diag.data_ptr(),
                          si.data_ptr(), sj.data_ptr(), flags.data_ptr())
        us = {}
        for mode, what in enumerate(modes):
            us[what] = 1e3 * statistics.median(
                time_ms(lambda: split(mode), dev, iters=2, warmup=1)
                for _ in range(3)) / steps
        sync = us[modes[3]] / 2
        print(f"[split] {name} N=8192, us a step: phase (a) "
              f"{us[modes[0]] - sync:.3f}, phase (b) as it ran "
              f"{us[modes[1]] - sync:.3f}, phase (b) as the finish groups "
              f"{us[modes[2]] - sync:.3f}, one grid sync {sync:.3f}; the "
              f"schedule before, summed {us[modes[0]] + us[modes[1]]:.3f} "
              f"({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
