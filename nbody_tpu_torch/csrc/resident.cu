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
// the number of blocks the card can hold at once, and the state stays in
// device memory (at N = 8192 about 320 KB, well inside the 50 MB L2).
//
// A step's work items are K2's: one per row tile I for its one-sided
// diagonal tile (the whole row of a real zero-mass body), stored per body,
// and one per pair of distinct row tiles (I, J = (I + d) mod nb) on K2's
// circular offsets d = 1 .. nb/2, which writes I's slot si[d-1][I] and J's
// slot sj[d-1][J].  The items are listed densely, diagonal items first and
// then offset by offset (the half offset of an even nb has its nb/2 real
// items only), and block g takes items g, g + grid, ... of every step:
// nb (nb + 1) / 2 items, 528 on 264 blocks at N = 8192, two a block.
// ops/resident.py mirrors this enumeration (work_items, block_items).
//
// The schedule is a dataflow, with no grid-wide barrier between steps.
// Every row tile receives exactly nb contributions a step: its diagonal
// item and one pair item with each of the other nb - 1 tiles.  An item,
// once its stores are out, adds one to the count of each tile it wrote
// (cnt[I], and cnt[J] for a pair).  A tile's finish (phase (b): for each
// body, K2's slot sum in K2's order, the descale and the integrator,
// into the next step's position buffer) is cut into 8 groups of 32
// bodies, one warp each, spread over the grid (group q of a step runs on
// block q mod grid, ops/resident.py: finish_groups); a group waits until
// its tile's count holds the step's nb contributions, stages the 32
// bodies' slots in shared memory with asynchronous 16-byte copies (one
// wait for all of them at N = 8192), adds them, and then adds one to the
// tile's done count.  Each block runs its items of step k, then its
// groups of step k, then its items of step k + 1, each item waiting
// (one thread spinning on an acquire load) until the 8 groups of each of
// its tiles have finished step k - 1; a diagonal item whose tile holds a
// real zero-mass body, whose row reads every body, waits for every tile.
// The positions alternate between two buffers (pos_out and pos_tmp,
// chosen so that the last step writes pos_out; pos_in is read at step 0
// only), so a tile's next positions never overwrite ones that a slower
// block still reads: a tile's step-(k+1) finish waits for one item with
// every other tile at step k+1, each of which waited for that tile's
// step-k finish, which came after every step-k read of the buffer.
// Slots are reused every step: a tile's slots of step k+1 are written by
// items that waited for its step-k finish, their only reader.  The
// release / acquire pattern is the grid barrier's own (cooperative
// groups): the stores, a block (warp) barrier, a fence and an atomic by
// one thread; on the other side an acquire load by one thread, a fence,
// a block (warp) barrier.  The counts are 64-bit and only grow (nb and 8
// a step); the wrapper zeroes them.
//
// K2 (forces_sym.cu) runs the same items and slots in separate launches,
// and its reduce pass adds the slots body by body.  The schedule before
// this one (tools/resident_variants.py rebuilds it to split a step by
// phase): phase (a), a grid-stride sweep over the items (the half
// offset's skipped items included); a grid sync; phase (b), a body pass
// over blocks 0 .. nb - 1 only (at N = 8192 one block in eight); a grid
// sync.
//
// K4, sub-steps s of weights w_s (h_s = w_s dt / 2, wdt_s = w_s dt):
//   before the first: v += h_0 a; x += wdt_0 v on the seeded a, over every
//   body; one grid sync;
//   then per sub-step: the items as K3; a tile's finish: the acceleration
//   as K3, v += h_s a and a is stored, then the next sub-step's v += h a;
//   x += wdt v into the next position buffer.
// The order of operations is that of ops/step.py::step's KDK branch.
//
// Rounding.  The forces are sym_common.cuh's code, the same as K2's, the
// slot sum adds in sym_slot_sum's order, and the integrator rounds as
// PyTorch's separate multiply and add kernels do, __fadd_rn(v,
// __fmul_rn(h, a)) with h and wdt rounded to float on the host from
// double, so n_steps of K3 are bit-equal to n_steps of K2 plus the
// per-step integrator (checked on the card by chip_smoke.py).
//
// What bounds it on the card: the FP32 and MUFU issue of K2's tile (17.5
// slots a pair), at N = 8192 four tile-times an SM a step (528 items, two
// CTAs an SM at up to 128 registers); around them, the groups' slot
// copies from L2 and the hand-off of the counts, a chain of L2 round
// trips.  On an H100 80GB HBM3 at 700 W (chip_smoke.py, N = 8192), K3's
// 1000 steps take 29.98 ms against 32.55 for the schedule before it, and
// K4's 100 Yoshida4 steps 9.26 against 9.47.  Split by
// tools/resident_variants.py, a step of the schedule before held 25.2 us
// of phase (a), 3.0 us of phase (b) and two grid syncs of 1.4 us; the
// finish groups take 3.0 us of phase (b) alone with the staged copies,
// 4.0 with each lane's sym_slot_sum, which makes K3's step at N = 8192
// 6 to 7% slower (PERF.md).  What it removes against the per-step path:
// four launches a step, the wrapper's checks and allocations, and K2's
// narrow reduce pass.
//
// Scratch: the slots take 2 * (nb/2) * N_pad * 12 bytes (3 MB at N = 8192),
// the diagonal sums and the second position buffer N * 12 each, the
// counts 16 nb bytes; the wrapper refuses an N whose slots exceed
// forces_sym's budget.
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

// ---------------------------------------------------------------------
// The work of one step (ops/resident.py mirrors it: work_items,
// block_items, finish_groups).

__host__ __device__ inline long long step_items(long long nb) {
    return nb * (nb + 1) / 2;
}

// Item w of a step: the diagonal item of row tile I (d = 0) for w < nb,
// else the pair item (I, d), offset by offset.
__device__ __forceinline__ void item_of(long long w, long long nb,
                                        long long& I, long long& d) {
    if (w < nb) {
        I = w;
        d = 0;
        return;
    }
    const long long p = w - nb;
    const long long dk = p / nb;
    I = p - dk * nb;
    d = 1 + dk;
}

// A tile's finish is cut into SYM_WARPS groups of 32 bodies, one warp
// each.  The warps of a block that take groups: the fewest that cover a
// step's 8 nb groups in one round of the grid, at most all of them.
__host__ __device__ inline int group_warps(long long nb, long long grid) {
    const long long need = (SYM_WARPS * nb + grid - 1) / grid;
    return (int)(need < SYM_WARPS ? need : SYM_WARPS);
}

// The position buffer that step k writes (its next positions): the last
// step writes pos_out, and the two buffers alternate before it.
__device__ __forceinline__ float* written_by(int k, int steps, float* pos_out,
                                             float* pos_tmp) {
    return ((steps - 1 - k) & 1) ? pos_tmp : pos_out;
}

typedef unsigned long long u64;

// The hand-off between blocks, as CUTLASS's generic barrier does it: one
// thread spins on an acquire load until *p >= target, then a block (or
// warp) barrier; on the other side the stores, a barrier, and one thread's
// release fence and relaxed add.
__device__ __forceinline__ void wait_at_least(const u64* p, u64 target) {
    u64 v;
    do {
        asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                     : "=l"(v) : "l"(p) : "memory");
    } while (v < target);
}

__device__ __forceinline__ void release_add(u64* p) {
    asm volatile("fence.acq_rel.gpu;\n"
                 "red.relaxed.gpu.global.add.u64 [%0], %1;"
                 :: "l"(p), "l"(1ull) : "memory");
}

// Phase (a) of step k for block blockIdx.x: its items, each once its
// tiles' positions of step k are out (done >= SYM_WARPS k: every group of
// the tile's step k - 1 finished); then one contribution to the count of
// each tile it wrote.
__device__ __forceinline__ void step_items_of_block(
        int k, const float* pr, const float* __restrict__ mass, long long n,
        long long nb, float eps2, float* diag, float* si, float* sj,
        u64* cnt, const u64* done, SymPairSmem& sm) {
    const u64 ready = (u64)SYM_WARPS * k;
    for (long long w = blockIdx.x; w < step_items(nb); w += gridDim.x) {
        long long I, d;
        item_of(w, nb, I, d);
        const long long J = d ? (I + d) % nb : I;
        const long long b = I * SYM_TILE + threadIdx.x;
        // A real zero-mass body's diagonal item reads every body.
        const bool all =
            d == 0 && __syncthreads_or(b < n && mass[b] == 0.f);
        if (threadIdx.x == 0) {
            if (all) {
                for (long long T = 0; T < nb; ++T)
                    wait_at_least(done + T, ready);
            } else {
                wait_at_least(done + I, ready);
                wait_at_least(done + J, ready);
            }
        }
        __syncthreads();
        if (d == 0) {
            const float3 s = sym_diag(pr, mass, n, b, eps2, sm.tile);
            if (b < n) {
                diag[3 * b] = s.x;
                diag[3 * b + 1] = s.y;
                diag[3 * b + 2] = s.z;
            }
        } else {
            sym_pair_tile(pr, mass, n, nb, I, d, d - 1, eps2, si, sj, sm);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            release_add(cnt + I);
            if (d) release_add(cnt + J);
        }
    }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(s), "l"(gmem) : "memory");
}

// Body b's slot sum over the offsets 1 .. nb/2 of row tile I, in
// sym_slot_sum's order (offset by offset, i-side before j-side), for the
// 32 bodies b0 .. b0+31 of a warp (b = b0 + lane): the warp stages the
// slots of as many offsets as its share `buf` of shared memory holds (for
// one offset and side the 32 bodies' records are 384 contiguous bytes)
// with asynchronous 16-byte copies, waits once, and adds from there.
// `dg` is loaded (b < n) while the first copies are in flight.
__device__ __forceinline__ float3 group_slot_sum(
        long long nb, long long I, long long b0, int lane, const float* si,
        const float* sj, float4* buf, int buf_len, const float* diag,
        long long n, float3& dg) {
    const long long n_pad = nb * SYM_TILE;
    const long long n_off = nb / 2;
    const long long b = b0 + lane;
    const int per = 2 * 24;                 // float4s an offset, both sides
    const int chunk = buf_len / per;
    float3 s = make_float3(0.f, 0.f, 0.f);
    dg = make_float3(0.f, 0.f, 0.f);
    for (long long d0 = 0; d0 == 0 || d0 < n_off; d0 += chunk) {
        const int cn = (int)(n_off - d0 < chunk ? n_off - d0 : chunk);
        for (int i = lane; i < cn * per; i += 32) {
            const int e = i / per;
            const int r = i - e * per;
            const float* src = (r < 24 ? si : sj) +
                               ((d0 + e) * n_pad + b0) * 3 + 4 * (r % 24);
            cp_async16(buf + i, src);
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
        if (d0 == 0 && b < n)
            dg = make_float3(__ldcg(diag + 3 * b), __ldcg(diag + 3 * b + 1),
                             __ldcg(diag + 3 * b + 2));
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncwarp();
        const float* f = reinterpret_cast<const float*>(buf);
        for (int e = 0; e < cn; ++e) {
            const bool half = 2 * (1 + d0 + e) == nb;
            const float* o = f + e * 4 * per + 3 * lane;
            if (!half || 2 * I < nb) {
                s.x += o[0];
                s.y += o[1];
                s.z += o[2];
            }
            if (!half || 2 * I >= nb) {
                s.x += o[96];
                s.y += o[97];
                s.z += o[98];
            }
        }
        __syncwarp();                       // buf is restaged next chunk
    }
    return s;
}

// What a body's integrator reads from the step before: position, velocity.
struct BodyState {
    float x[3], v[3];
};

__device__ __forceinline__ BodyState body_state(const float* p,
                                                const float* v, long long b) {
    BodyState s;
    for (int c = 0; c < 3; ++c) {
        s.x[c] = __ldcg(p + 3 * b + c);
        s.v[c] = __ldcg(v + 3 * b + c);
    }
    return s;
}

// Phase (b) of step k for this warp: its groups (group q: row tile q / 8,
// bodies 32 (q mod 8) .. of it), each once its tile's nb contributions of
// step k are in.  For body b < n: pre(b) loads its position and velocity
// before the wait (a group runs on the same warp every step, so these are
// the lane's own stores of the step before, or the launch's inputs),
// body(b, a, p) does the integrator with acceleration a.  Then one count
// of the tile's done groups.
template <class Pre, class Body>
__device__ __forceinline__ void step_groups_of_warp(
        int k, const float* __restrict__ mass, long long n, long long nb,
        const float* diag, const float* si, const float* sj, const u64* cnt,
        u64* done, SymPairSmem& sm, Pre pre, Body body) {
    const int wa = group_warps(nb, gridDim.x);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    if (warp < wa) {
        const int buf_len = (int)(sizeof(sm.part) / sizeof(float4)) / wa;
        float4* buf = reinterpret_cast<float4*>(sm.part) + warp * buf_len;
        const u64 in = (u64)nb * (k + 1);
        for (long long q = blockIdx.x + (long long)gridDim.x * warp;
             q < SYM_WARPS * nb; q += (long long)gridDim.x * wa) {
            const long long T = q / SYM_WARPS;
            const long long b0 = T * SYM_TILE + 32 * (q % SYM_WARPS);
            const long long b = b0 + lane;
            BodyState p = {};
            float m = 0.f;
            if (b < n) {
                p = pre(b);
                m = mass[b];
            }
            if (lane == 0) wait_at_least(cnt + T, in);
            __syncwarp();
            float3 dg;
            const float3 s = group_slot_sum(nb, T, b0, lane, si, sj, buf,
                                            buf_len, diag, n, dg);
            if (b < n) body(b, sym_descale(dg, s, m), p);
            __syncwarp();
            if (lane == 0) release_add(done + T);
        }
    }
    __syncthreads();                        // sm.part is restaged next
}

__global__ void __launch_bounds__(SYM_TILE, 2)
resident_kernel(const float* pos_in, const float* vel_in,
                const float* __restrict__ mass, long long n, long long nb,
                float eps2, float h, float dt, int n_steps, float* pos_out,
                float* vel_out, float* acc_out, float* pos_tmp, float* diag,
                float* si, float* sj, u64* flags) {
    __shared__ SymPairSmem sm;
    u64* cnt = flags;
    u64* done = flags + nb;
    for (int k = 0; k < n_steps; ++k) {
        const float* pr =
            k == 0 ? pos_in : written_by(k - 1, n_steps, pos_out, pos_tmp);
        float* pw = written_by(k, n_steps, pos_out, pos_tmp);
        const float* vr = k == 0 ? vel_in : vel_out;
        const bool last = k == n_steps - 1;
        step_items_of_block(k, pr, mass, n, nb, eps2, diag, si, sj, cnt, done,
                            sm);
        step_groups_of_warp(
            k, mass, n, nb, diag, si, sj, cnt, done, sm,
            [&](long long b) { return body_state(pr, vr, b); },
            [&](long long b, float3 a, const BodyState& p) {
            const float ac[3] = {a.x, a.y, a.z};
            for (int c = 0; c < 3; ++c) {
                const float v = __fadd_rn(p.v[c], __fmul_rn(h, ac[c]));
                pw[3 * b + c] = __fadd_rn(p.x[c], __fmul_rn(dt, v));
                vel_out[3 * b + c] = v;
                if (last) acc_out[3 * b + c] = ac[c];
            }
        });
    }
}

__global__ void __launch_bounds__(SYM_TILE, 2)
resident_kdk_kernel(const float* pos_in, const float* vel_in,
                    const float* acc_in, const float* __restrict__ mass,
                    long long n, long long nb, float eps2, KdkWeights wt,
                    int n_steps, float* pos_out, float* vel_out,
                    float* acc_out, float* pos_tmp, float* diag, float* si,
                    float* sj, u64* flags) {
    __shared__ SymPairSmem sm;
    cg::grid_group grid = cg::this_grid();
    u64* cnt = flags;
    u64* done = flags + nb;
    const int subs = n_steps * wt.count;
    // Sub-step k reads the positions that sub-step k - 1 wrote (the first
    // kick and drift those of k = 0), and the last sub-step writes none:
    // its positions, written by sub-step subs - 2, go to pos_out.
    float* p0 = written_by(-1, subs - 1, pos_out, pos_tmp);
    for (long long b = (long long)blockIdx.x * SYM_TILE + threadIdx.x; b < n;
         b += (long long)gridDim.x * SYM_TILE) {
        for (int c = 0; c < 3; ++c) {
            const float v = __fadd_rn(vel_in[3 * b + c],
                                      __fmul_rn(wt.h[0], acc_in[3 * b + c]));
            p0[3 * b + c] = __fadd_rn(pos_in[3 * b + c],
                                      __fmul_rn(wt.wdt[0], v));
            vel_out[3 * b + c] = v;
        }
    }
    grid.sync();
    for (int k = 0; k < subs; ++k) {
        const float h = wt.h[k % wt.count];
        const float h_next = wt.h[(k + 1) % wt.count];
        const float wdt_next = wt.wdt[(k + 1) % wt.count];
        const bool more = k + 1 < subs;
        const float* pr = written_by(k - 1, subs - 1, pos_out, pos_tmp);
        float* pw = written_by(k, subs - 1, pos_out, pos_tmp);
        step_items_of_block(k, pr, mass, n, nb, eps2, diag, si, sj, cnt, done,
                            sm);
        step_groups_of_warp(
            k, mass, n, nb, diag, si, sj, cnt, done, sm,
            [&](long long b) { return body_state(pr, vel_out, b); },
            [&](long long b, float3 a, const BodyState& p) {
            const float ac[3] = {a.x, a.y, a.z};
            for (int c = 0; c < 3; ++c) {
                float v = __fadd_rn(p.v[c], __fmul_rn(h, ac[c]));
                acc_out[3 * b + c] = ac[c];
                if (more) {   // the next sub-step's kick and drift
                    v = __fadd_rn(v, __fmul_rn(h_next, ac[c]));
                    pw[3 * b + c] = __fadd_rn(p.x[c], __fmul_rn(wdt_next, v));
                }
                vel_out[3 * b + c] = v;
            }
        });
    }
}

// ---------------------------------------------------------------------

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

// The grid for nb row tiles: no more blocks than a step has items
// (ops/resident.py: resident_grid), no more than the card holds at once.
static unsigned grid_for(const void* kernel, long long nb) {
    const int cap = coresident_blocks(kernel);
    const long long work = step_items(nb);
    if (cap <= 0) return 0;
    return (unsigned)(work < cap ? work : cap);
}

extern "C" int nbt_resident_max_blocks(int kdk) {
    return coresident_blocks(kdk ? (const void*)resident_kdk_kernel
                                 : (const void*)resident_kernel);
}

extern "C" int nbt_resident_group_warps(long long nb, long long grid) {
    return group_warps(nb, grid);
}

extern "C" int nbt_resident_grid(long long nb, int kdk) {
    return (int)grid_for(kdk ? (const void*)resident_kdk_kernel
                             : (const void*)resident_kernel, nb);
}

// flags: 2 nb 64-bit counts, zero: each tile's contributions, then its
// finished groups.
extern "C" int nbt_resident(const float* pos_in, const float* vel_in,
                            const float* mass, long long n, long long nb,
                            float eps2, float h, float dt, int n_steps,
                            float* pos_out, float* vel_out, float* acc_out,
                            float* pos_tmp, float* diag, float* si,
                            float* sj, u64* flags, void* stream) {
    if (n_steps <= 0 || n <= 0) return 0;
    const unsigned grid = grid_for((const void*)resident_kernel, nb);
    if (grid == 0) return (int)cudaErrorInvalidConfiguration;
    void* args[] = {&pos_in, &vel_in, &mass, &n, &nb, &eps2, &h, &dt,
                    &n_steps, &pos_out, &vel_out, &acc_out, &pos_tmp, &diag,
                    &si, &sj, &flags};
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
                                float* acc_out, float* pos_tmp, float* diag,
                                float* si, float* sj, u64* flags,
                                void* stream) {
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
                    &n_steps, &pos_out, &vel_out, &acc_out, &pos_tmp, &diag,
                    &si, &sj, &flags};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)resident_kdk_kernel, dim3(grid), dim3(SYM_TILE), args,
        0, (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

extern "C" int nbt_resident_tile(void) { return SYM_TILE; }
