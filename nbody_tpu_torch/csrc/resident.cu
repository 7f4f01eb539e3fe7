// K3 and K4: the resident multi-step kernels for Hopper (sm_90a).
//
// Replace nbody_tpu/ops/resident.py:
//   K3 _make_resident_kernel      (reference scheme, launched at :447)
//   K4 _make_resident_kernel_kdk  (KDK / Yoshida4 sub-steps, :488)
// with _load_resident_state, _sweep_superblock and _diag_tile_vpu2.
//
// One launch runs n_steps whole steps with no host round trip between them.
// On the TPU the state sits in VMEM across a sequential grid.  Here the
// launch is cooperative (cudaLaunchCooperativeKernel): the grid is sized to
// the number of blocks the card can hold at once, the state stays in device
// memory (at N = 8192 it is about 320 KB, well inside the 50 MB L2), and the
// phases of a step are separated by cooperative_groups grid syncs.
//
// K3, one step:
//   (a) a grid-stride sweep over K2's (row tile, offset) work items, every
//       offset's i-side and j-side slots held at once (one chunk in
//       forces_sym.cu's terms), and one work item per row tile for its
//       one-sided diagonal tile (the whole row of a real zero-mass body),
//       stored per body;
//   grid sync;
//   (b) a grid-stride pass over bodies: the slots added in K2's fixed
//       order, the 1/m descale with the diagonal sum, then
//       v += (dt/2) a; x += dt v;
//   grid sync.
// Phase (b) reads no other body's position, so positions are updated in
// place: step 0 reads pos_in and writes pos_out, later steps update
// pos_out; pos_in is never written.  K2 computes the diagonal tiles in its
// reduce pass, which on N = 8192 keeps only 32 blocks busy; here they run
// beside the pair tiles and (b) spreads over every block.
//
// K4, sub-steps s of weights w_s (h_s = w_s dt / 2, wdt_s = w_s dt):
//   (p) before the first: v += h_0 a; x += wdt_0 v on the seeded a;
//   grid sync;
//   then per sub-step: (a) as K3; grid sync; (b) the acceleration as K3,
//   v += h_s a and a is carried, then the next sub-step's v += h a;
//   x += wdt v; grid sync.
// The order of operations is that of ops/step.py::step's KDK branch.
//
// Rounding.  The forces are sym_common.cuh's code, the same as K2's, and the
// integrator rounds as PyTorch's separate multiply and add kernels do,
// __fadd_rn(v, __fmul_rn(h, a)) with h and wdt rounded to float on the host
// from double, so n_steps of K3 are bit-equal to n_steps of K2 plus the
// per-step integrator (checked on the card by chip_smoke.py).
//
// What bounds it on the card: the same FP32 and MUFU issue as K2 in phase
// (a), plus two grid syncs a step (a sub-step for K4).  What it removes is
// the host's share of the per-step path: four launches a step, the
// wrapper's checks and allocations, and K2's narrow reduce pass.
//
// Scratch: the slots take 2 * (nb/2) * N_pad * 12 bytes (3 MB at N = 8192),
// the diagonal sums N_pad * 12; the wrapper refuses an N whose slots
// exceed forces_sym's budget.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include <cooperative_groups.h>

#include "sym_common.cuh"

namespace cg = cooperative_groups;

// Sub-step weights of K4: h[s] = (float)(0.5 * w_s * dt),
// wdt[s] = (float)(w_s * dt), s < count <= 3.
struct KdkWeights {
    float h[3];
    float wdt[3];
    int count;
};

// Phase (a): the diagonal tile of every row tile, then every (row tile,
// offset) work item of one force evaluation.
__device__ __forceinline__ void sweep(const float* pos,
                                      const float* __restrict__ mass,
                                      long long n, long long nb, float eps2,
                                      float* diag, float* si, float* sj,
                                      SymPairSmem& sm) {
    const long long n_off = nb / 2;
    for (long long w = blockIdx.x; w < nb * (1 + n_off); w += gridDim.x) {
        if (w < nb) {
            const long long b = w * SYM_TILE + threadIdx.x;
            const float3 d = sym_diag(pos, mass, n, b, eps2, sm.tile);
            if (b < n) {
                diag[3 * b] = d.x;
                diag[3 * b + 1] = d.y;
                diag[3 * b + 2] = d.z;
            }
            __syncthreads();   // sm.tile is restaged by the next item
            continue;
        }
        const long long dk = (w - nb) / nb;
        const long long I = (w - nb) - dk * nb;
        const long long d = 1 + dk;
        if (2 * d == nb && 2 * I >= nb) continue;   // even nb: half offset
        sym_pair_tile(pos, mass, n, nb, I, d, dk, eps2, si, sj, sm);
    }
}

// Phase (b)'s force part: body b's acceleration from its diagonal sum and
// its slots.
__device__ __forceinline__ float3 body_acc(const float* __restrict__ mass,
                                           long long nb, long long b,
                                           const float* diag, const float* si,
                                           const float* sj) {
    const float3 s = sym_slot_sum(make_float3(0.f, 0.f, 0.f), nb,
                                  b / SYM_TILE, b, 1, nb / 2, si, sj);
    const float3 d = make_float3(diag[3 * b], diag[3 * b + 1],
                                 diag[3 * b + 2]);
    return sym_descale(d, s, mass[b]);
}

__global__ void __launch_bounds__(SYM_TILE)
resident_kernel(const float* pos_in, const float* vel_in,
                const float* __restrict__ mass, long long n, long long nb,
                float eps2, float h, float dt, int n_steps, float* pos_out,
                float* vel_out, float* acc_out, float* diag, float* si,
                float* sj) {
    __shared__ SymPairSmem sm;
    cg::grid_group grid = cg::this_grid();
    const long long stride = (long long)gridDim.x * SYM_TILE;
    for (int k = 0; k < n_steps; ++k) {
        const float* pr = (k == 0) ? pos_in : pos_out;
        const float* vr = (k == 0) ? vel_in : vel_out;
        sweep(pr, mass, n, nb, eps2, diag, si, sj, sm);
        grid.sync();
        for (long long b = (long long)blockIdx.x * SYM_TILE + threadIdx.x;
             b < n; b += stride) {
            const float3 a = body_acc(mass, nb, b, diag, si, sj);
            const float vx = __fadd_rn(vr[3 * b], __fmul_rn(h, a.x));
            const float vy = __fadd_rn(vr[3 * b + 1], __fmul_rn(h, a.y));
            const float vz = __fadd_rn(vr[3 * b + 2], __fmul_rn(h, a.z));
            pos_out[3 * b] = __fadd_rn(pr[3 * b], __fmul_rn(dt, vx));
            pos_out[3 * b + 1] = __fadd_rn(pr[3 * b + 1], __fmul_rn(dt, vy));
            pos_out[3 * b + 2] = __fadd_rn(pr[3 * b + 2], __fmul_rn(dt, vz));
            vel_out[3 * b] = vx;
            vel_out[3 * b + 1] = vy;
            vel_out[3 * b + 2] = vz;
            if (k == n_steps - 1) {
                acc_out[3 * b] = a.x;
                acc_out[3 * b + 1] = a.y;
                acc_out[3 * b + 2] = a.z;
            }
        }
        grid.sync();
    }
}

// v += h a; x += wdt v for body b's three components.
__device__ __forceinline__ void kick_drift(const float* pr, const float* vr,
                                           float3 a, float h, float wdt,
                                           long long b, float* pos_out,
                                           float* vel_out) {
    const float ac[3] = {a.x, a.y, a.z};
    for (int c = 0; c < 3; ++c) {
        const float v = __fadd_rn(vr[3 * b + c], __fmul_rn(h, ac[c]));
        pos_out[3 * b + c] = __fadd_rn(pr[3 * b + c], __fmul_rn(wdt, v));
        vel_out[3 * b + c] = v;
    }
}

__global__ void __launch_bounds__(SYM_TILE)
resident_kdk_kernel(const float* pos_in, const float* vel_in,
                    const float* acc_in, const float* __restrict__ mass,
                    long long n, long long nb, float eps2, KdkWeights wt,
                    int n_steps, float* pos_out, float* vel_out,
                    float* acc_out, float* diag, float* si, float* sj) {
    __shared__ SymPairSmem sm;
    cg::grid_group grid = cg::this_grid();
    const long long stride = (long long)gridDim.x * SYM_TILE;
    const long long b0 = (long long)blockIdx.x * SYM_TILE + threadIdx.x;
    for (long long b = b0; b < n; b += stride) {
        kick_drift(pos_in, vel_in, make_float3(acc_in[3 * b],
                                               acc_in[3 * b + 1],
                                               acc_in[3 * b + 2]),
                   wt.h[0], wt.wdt[0], b, pos_out, vel_out);
    }
    grid.sync();
    const int subs = n_steps * wt.count;
    for (int k = 0; k < subs; ++k) {
        const float h = wt.h[k % wt.count];
        const float h_next = wt.h[(k + 1) % wt.count];
        const float wdt_next = wt.wdt[(k + 1) % wt.count];
        sweep(pos_out, mass, n, nb, eps2, diag, si, sj, sm);
        grid.sync();
        for (long long b = b0; b < n; b += stride) {
            const float3 a = body_acc(mass, nb, b, diag, si, sj);
            const float vx = __fadd_rn(vel_out[3 * b], __fmul_rn(h, a.x));
            const float vy = __fadd_rn(vel_out[3 * b + 1],
                                       __fmul_rn(h, a.y));
            const float vz = __fadd_rn(vel_out[3 * b + 2],
                                       __fmul_rn(h, a.z));
            acc_out[3 * b] = a.x;
            acc_out[3 * b + 1] = a.y;
            acc_out[3 * b + 2] = a.z;
            vel_out[3 * b] = vx;
            vel_out[3 * b + 1] = vy;
            vel_out[3 * b + 2] = vz;
            if (k + 1 < subs)   // the next sub-step's kick and drift
                kick_drift(pos_out, vel_out, a, h_next, wdt_next, b,
                           pos_out, vel_out);
        }
        grid.sync();
    }
}

// Blocks of SYM_TILE threads the card holds at once for the kernel: the
// largest grid a cooperative launch accepts.
static int coresident_blocks(const void* kernel) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return -1;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
        != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      SYM_TILE, 0)
        != cudaSuccess) return -1;
    return per_sm * sms;
}

// The grid for nb row tiles: no more blocks than phase (a) has work items
// (at least nb, enough for phase (b)'s bodies), no more than the card
// holds at once.
static unsigned grid_for(const void* kernel, long long nb) {
    const int cap = coresident_blocks(kernel);
    const long long work = nb * (1 + nb / 2);
    if (cap <= 0) return 0;
    return (unsigned)(work < cap ? work : cap);
}

extern "C" int nbt_resident_max_blocks(int kdk) {
    return coresident_blocks(kdk ? (const void*)resident_kdk_kernel
                                 : (const void*)resident_kernel);
}

extern "C" int nbt_resident(const float* pos_in, const float* vel_in,
                            const float* mass, long long n, long long nb,
                            float eps2, float h, float dt, int n_steps,
                            float* pos_out, float* vel_out, float* acc_out,
                            float* diag, float* si, float* sj,
                            void* stream) {
    if (n_steps <= 0 || n <= 0) return 0;
    const unsigned grid = grid_for((const void*)resident_kernel, nb);
    if (grid == 0) return (int)cudaErrorInvalidConfiguration;
    void* args[] = {&pos_in, &vel_in, &mass, &n, &nb, &eps2, &h, &dt,
                    &n_steps, &pos_out, &vel_out, &acc_out, &diag, &si,
                    &sj};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)resident_kernel, dim3(grid), dim3(SYM_TILE), args, 0,
        (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int nbt_resident_kdk(const float* pos_in, const float* vel_in,
                                const float* acc_in, const float* mass,
                                long long n, long long nb, float eps2,
                                const float* h, const float* wdt, int count,
                                int n_steps, float* pos_out, float* vel_out,
                                float* acc_out, float* diag, float* si,
                                float* sj, void* stream) {
    if (n_steps <= 0 || n <= 0) return 0;
    if (count < 1 || count > 3) return (int)cudaErrorInvalidValue;
    KdkWeights wt;
    for (int s = 0; s < 3; ++s) {
        wt.h[s] = s < count ? h[s] : 0.f;
        wt.wdt[s] = s < count ? wdt[s] : 0.f;
    }
    wt.count = count;
    const unsigned grid = grid_for((const void*)resident_kdk_kernel, nb);
    if (grid == 0) return (int)cudaErrorInvalidConfiguration;
    void* args[] = {&pos_in, &vel_in, &acc_in, &mass, &n, &nb, &eps2, &wt,
                    &n_steps, &pos_out, &vel_out, &acc_out, &diag, &si,
                    &sj};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)resident_kdk_kernel, dim3(grid), dim3(SYM_TILE), args,
        0, (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int nbt_resident_tile(void) { return SYM_TILE; }
