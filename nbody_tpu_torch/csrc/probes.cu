// The JAX rounds' platform probes for Hopper (sm_90a): the Pallas kernels of
// scripts/r3_platbug.py and scripts/r8_mosaic_rules.py, which tested two
// TPU mechanisms that shaped the force tiers, as kernels of this card.
//
// r3 (the operand-ingestion bug).  Replaces r3_platbug.py:69 red_kernel
// (its pallas_call at :78) and :91 derive_kernel (:106): column sums of a
// bf16 pack [x_hi y_hi z_hi x_lo y_lo z_lo 1 0] of (N, 3) float32
// positions, premade (pack_sum) or derived in the kernel from the positions
// (derive_pack_sum) with the tensor-core tiers' own split (split_bf16,
// tc_common.cuh: hi = bf16(x), lo = bf16(x - hi), both to nearest even).
// The TPU grid walks blocks of R3_U = 2048 rows (the script's U) in
// sequence, adding each block's sum into one output.  Here block b of the
// grid takes rows b*U .. b*U+U-1:
// thread t sums rows t, t + 256, ... of the block in float32, the 256
// partials meet in a fixed tree in shared memory (tree[t] += tree[t + s]
// for t < s, s = 128, 64, .., 1), and a second kernel adds the blocks'
// sums in block order from zero, as the TPU grid does.  No atomics: the
// bits repeat from run to run,
// and both kernels add in the same order, so a premade pack and one derived
// in the kernel give the same bits when the pack reached the kernel intact
// (ops/probes.py holds both against a float32 twin of this order).
//
// r8 (Mosaic's rules for manual-DMA kernels).  Replaces r8_mosaic_rules.py's
// run (:31, its pallas_call) over the six kernel bodies k_any (:50, probes
// 1a and 1b), k_ws (:63, 1c), k_refslice (:72, 2a), k_valslice (:82, 2b),
// k_narrow (:94, 3a) and k_transpose (:105, 3b), and k_remote (:121, its
// pallas_call at :129, probe 4).  Each stages an (8, 128) float32 tile as
// its TPU kernel stages it through VMEM: through shared memory (1c, 2a,
// 2b, 3a with an (8, 3) buffer, 3b), or through a (2, 8, 128) workspace in
// device memory (1a and 1b, the ANY and HBM scratch Mosaic rejected; on
// this card such a scratch is a plain buffer).  Probe 4's remote copy to
// device 0 at P = 1 is K13's hop across cards (rdma_ring.cu,
// rdma_flag_kernel) at P = 1: the staged tile is stored into the
// receiver's buffer, which at P = 1 is the card's own output, a flag is
// released at system scope in the receiver's flag word (peer_flags.cuh)
// and the kernel waits for it, with a bounded spin and an error word as
// K13's.
//
// What bounds them: the launch.  r3 reads 16 B a row (256 KB at N =
// 16,384: 0.08 us at 3.35 TB/s), r8 moves 8 KB.  The design is for exact,
// repeatable bits, not speed.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "peer_flags.cuh"
#include "tc_common.cuh"

// r3: threads a block, the width of the tree; rows a block.
#define PROBE_THREADS 256
#define R3_U 2048
// r8: the probes' tile.
#define R8_ROWS 8
#define R8_LANES 128

// ---------------------------------------------------------------------------
// r3

// One block of R3_U rows: its column sums into partials[blockIdx.x * 8 ..].
// DERIVE: `in` is (N, 3) float32 positions, else the (N, 8) bf16 pack.
template <bool DERIVE>
__global__ void __launch_bounds__(PROBE_THREADS)
pack_partials_kernel(const void* in, float* partials) {
    __shared__ float tree[8][PROBE_THREADS];
    const int t = threadIdx.x;
    const long long row0 = (long long)blockIdx.x * R3_U;
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    for (long long r = row0 + t; r < row0 + R3_U; r += PROBE_THREADS) {
        float col[8];
        if (DERIVE) {
            const float* p = (const float*)in + 3 * r;
#pragma unroll
            for (int e = 0; e < 3; ++e) {
                __nv_bfloat16 hi, lo;
                split_bf16(p[e], hi, lo);
                col[e] = __bfloat162float(hi);
                col[3 + e] = __bfloat162float(lo);
            }
            col[6] = 1.f;
            col[7] = 0.f;
        } else {
            const uint4 w = ((const uint4*)in)[r];
            const uint32_t h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                col[2 * k] = __uint_as_float(h[k] << 16);
                col[2 * k + 1] = __uint_as_float(h[k] & 0xffff0000u);
            }
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] = __fadd_rn(acc[c], col[c]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) tree[c][t] = acc[c];
    __syncthreads();
    for (int s = PROBE_THREADS / 2; s > 0; s >>= 1) {
        if (t < s)
#pragma unroll
            for (int c = 0; c < 8; ++c)
                tree[c][t] = __fadd_rn(tree[c][t], tree[c][t + s]);
        __syncthreads();
    }
    if (t < 8) partials[(long long)blockIdx.x * 8 + t] = tree[t][0];
}

// The blocks' sums added in block order from zero, one thread a column.
__global__ void partials_sum_kernel(const float* partials, long long nb,
                                    float* out) {
    const int c = threadIdx.x;
    float s = 0.f;
    for (long long b = 0; b < nb; ++b) s = __fadd_rn(s, partials[8 * b + c]);
    out[c] = s;
}

// Column sums of n rows (a multiple of R3_U): `in` the (n, 8) bf16 pack, or
// with `derive` the (n, 3) float32 positions; partials (n / R3_U, 8), out
// (8).
extern "C" int nbt_probe_pack_sum(const void* in, int derive, long long n,
                                  float* partials, float* out, void* stream) {
    if (n < 1 || n % R3_U) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const long long nb = n / R3_U;
    if (derive)
        pack_partials_kernel<true><<<(unsigned)nb, PROBE_THREADS, 0, s>>>(
            in, partials);
    else
        pack_partials_kernel<false><<<(unsigned)nb, PROBE_THREADS, 0, s>>>(
            in, partials);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    partials_sum_kernel<<<1, 8, 0, s>>>(partials, nb, out);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// r8: one CTA of R8_LANES threads, thread t on lane (column) t.

enum R8Probe { R8_WORKSPACE = 0, R8_STAGED = 1, R8_REF_SLICE = 2,
               R8_VALUE_SLICE = 3, R8_NARROW = 4, R8_TRANSPOSE = 5 };

// 1a / 1b (k_any): x -> ws[0] -> out, ws a (2, 8, 128) device buffer.
__global__ void __launch_bounds__(R8_LANES)
workspace_copy_kernel(const float* x, float* ws, float* out) {
    const int t = threadIdx.x;
    for (int r = 0; r < R8_ROWS; ++r)
        ws[r * R8_LANES + t] = x[r * R8_LANES + t];
    __syncthreads();
    for (int r = 0; r < R8_ROWS; ++r)
        out[r * R8_LANES + t] = ws[r * R8_LANES + t];
}

// 1c (k_ws), 2a (k_refslice), 2b (k_valslice), 3a (k_narrow), 3b
// (k_transpose): x staged in shared memory, then out as the body has it.
template <int P>
__global__ void __launch_bounds__(R8_LANES)
staged_copy_kernel(const float* x, float* out) {
    __shared__ float buf[R8_ROWS][R8_LANES];
    __shared__ float narrow[R8_ROWS][3];
    const int t = threadIdx.x;
    if (P == R8_NARROW) {
        // x[:, 0:3] into the (8, 3) buffer, then padded to 128 lanes.
        if (t < 3 * R8_ROWS) narrow[t / 3][t % 3] = x[(t / 3) * R8_LANES
                                                      + t % 3];
        __syncthreads();
        for (int r = 0; r < R8_ROWS; ++r)
            buf[r][t] = t < 3 ? narrow[r][t] : 0.f;
        __syncthreads();
        for (int r = 0; r < R8_ROWS; ++r) out[r * R8_LANES + t] = buf[r][t];
        return;
    }
    for (int r = 0; r < R8_ROWS; ++r) buf[r][t] = x[r * R8_LANES + t];
    __syncthreads();
    if (P == R8_VALUE_SLICE) {
        // The loaded value's rows 0..2 doubled, stored back, then copied.
        float v[R8_ROWS];
        for (int r = 0; r < R8_ROWS; ++r) v[r] = buf[r][t];
        __syncthreads();
        for (int r = 0; r < R8_ROWS; ++r)
            buf[r][t] = r < 3 ? __fmul_rn(v[r], 2.f) : v[r];
        __syncthreads();
    }
    if (P == R8_TRANSPOSE) {
        // [x[0:3] * x[3]; 0] as (4, 128): row r of the (128, 3) tile's
        // transpose is lane t's x[r][t] * x[3][t].
        for (int r = 0; r < 4; ++r)
            out[r * R8_LANES + t] = r < 3 ? __fmul_rn(buf[r][t], buf[3][t])
                                          : 0.f;
        return;
    }
    // 2a copies rows 0..2 only; the rest of out is left as it was.
    const int rows = P == R8_REF_SLICE ? 3 : R8_ROWS;
    for (int r = 0; r < rows; ++r) out[r * R8_LANES + t] = buf[r][t];
}

// One of the r8 copy probes on an (8, 128) float32 tile x: `which` an
// R8Probe; `ws` the (2, 8, 128) workspace of R8_WORKSPACE (else unused);
// out (8, 128), or (4, 128) for R8_TRANSPOSE.
extern "C" int nbt_probe_copy(int which, const float* x, float* ws,
                              float* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (which) {
        case R8_WORKSPACE:
            if (ws == nullptr) return (int)cudaErrorInvalidValue;
            workspace_copy_kernel<<<1, R8_LANES, 0, s>>>(x, ws, out);
            break;
        case R8_STAGED:
            staged_copy_kernel<R8_STAGED><<<1, R8_LANES, 0, s>>>(x, out);
            break;
        case R8_REF_SLICE:
            staged_copy_kernel<R8_REF_SLICE><<<1, R8_LANES, 0, s>>>(x, out);
            break;
        case R8_VALUE_SLICE:
            staged_copy_kernel<R8_VALUE_SLICE><<<1, R8_LANES, 0, s>>>(x,
                                                                      out);
            break;
        case R8_NARROW:
            staged_copy_kernel<R8_NARROW><<<1, R8_LANES, 0, s>>>(x, out);
            break;
        case R8_TRANSPOSE:
            staged_copy_kernel<R8_TRANSPOSE><<<1, R8_LANES, 0, s>>>(x, out);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// r8 probe 4: the remote copy as K13's peer store and flag, at P = 1.

__global__ void __launch_bounds__(R8_LANES)
peer_copy_kernel(const float* x, float* out, unsigned long long* flag,
                 unsigned long long want, unsigned long long spin_ns,
                 unsigned long long* err) {
    __shared__ float buf[R8_ROWS][R8_LANES];
    const int t = threadIdx.x;
    for (int r = 0; r < R8_ROWS; ++r) buf[r][t] = x[r * R8_LANES + t];
    __syncthreads();
    // The push: stores into the receiver's buffer, made visible at system
    // scope before the flag (K13's push_done).
    for (int r = 0; r < R8_ROWS; ++r) out[r * R8_LANES + t] = buf[r][t];
    __threadfence_system();
    __syncthreads();
    if (t == 0) {
        flag_store(flag, want);
        // The receive: the receiver's flag (at P = 1 this shard's own),
        // polled relaxed under a bound; past it the error word is set.
        if (flag_poll(flag) < want) {
            const unsigned long long t0 = ring_clock();
            while (flag_poll(flag) < want) {
                __nanosleep(32);
                if (ring_clock() - t0 > spin_ns) {
                    atomicCAS(err, 0ULL, want);
                    break;
                }
            }
        }
        __threadfence_system();
    }
    __syncthreads();
}

// Probe 4: x staged and pushed into out, the (8, 128) buffer of the
// receiver; `flag` its flag word, `want` the value this call releases and
// waits for; `err` the card's error word, set to `want` if the wait runs
// past spin_ns.
extern "C" int nbt_probe_peer_copy(const float* x, float* out,
                                   unsigned long long* flag,
                                   unsigned long long want,
                                   unsigned long long spin_ns,
                                   unsigned long long* err, void* stream) {
    peer_copy_kernel<<<1, R8_LANES, 0, (cudaStream_t)stream>>>(
        x, out, flag, want, spin_ns, err);
    return (int)cudaGetLastError();
}

// The probes' layout, for the wrapper to check its own against: 0 r3's
// threads a block, 1 its rows a block, 2 r8's rows, 3 its lanes, 4 + k
// the R8Probe index of the k-th copy probe.
extern "C" long long nbt_probe_geometry(int k) {
    switch (k) {
        case 0: return PROBE_THREADS;
        case 1: return R3_U;
        case 2: return R8_ROWS;
        case 3: return R8_LANES;
    }
    const long long ids[] = {R8_WORKSPACE, R8_STAGED, R8_REF_SLICE,
                             R8_VALUE_SLICE, R8_NARROW, R8_TRANSPOSE};
    return k >= 4 && k < 10 ? ids[k - 4] : -1;
}
