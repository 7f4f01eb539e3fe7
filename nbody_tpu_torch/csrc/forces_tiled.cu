// K1 and K11: one-sided exact all-pairs force tiles for Hopper (sm_90a).
//
// Replaces nbody_tpu/ops/forces_pallas.py:_force_kernel_vpu (K1) and
// :_force_kernel_vpu_kahan (K11), driven there by _forces_pallas_padded,
// forces_pallas and rect_forces_pallas.
//
// Computes, for every body i of the i-set,
//     acc_i = sum_j m_j * r_ij * rsqrt((|r_ij|^2 + eps2)^3),  r_ij = x_j - x_i
// with no i != j guard: the self-pair vanishes because r = 0, exactly as in
// the JAX kernel and the reference's tiled kernel.  The ragged edges are
// masked at load time: a j slot past Nj is staged as a zero-mass body at
// the origin (it contributes exactly 0), and rows past Ni store nothing.
// Indices are 64-bit.
//
// K1's design.  The grid is (row block, j slice).  A row block is
// K1_BLOCK_ROWS rows, K1_ROWS a lane in registers (K1_BLOCK_ROWS / K1_ROWS
// threads); a slice is `tps` consecutive j tiles of K1_TILE bodies, staged
// through shared memory as float4 {x, y, z, m} and read by broadcast, one
// shared load for a lane's K1_ROWS pairs.  The pair math is onesided_rows
// (onesided_tile.cuh), 13 issue slots a pair.  Each tile's contribution is
// summed from zero and then added to the slice's sum, as JAX's kernel adds
// each block_j tile's sum to its accumulator.  A (row block, slice) work
// item writes its rows' sums to its own slot (slice, Ni, 3); a second
// launch adds the slots in slice order, so there are no atomics and the
// result is bit-reproducible.  With one slice the item writes the
// accelerations and there is no second launch.  The wrapper
// (ops/forces_tiled.py, k1_slices) takes the slice count from Ni and Nj:
// enough items to fill the card (at N = 8192, 16 row blocks x 64 slices of
// one tile; 512 x 4 on the 1M ring's 262,144-body sweep), and one slice
// where the row blocks alone fill it.  The plain
// twin takes the same tiles, slices and order.
//
// What bounds it on the card: FP32 and MUFU issue, 13 slots a pair (the
// MUFU's quarter rate is 4 slots' worth, below the other 12); the staging
// and slot traffic are small beside it.  On an H100 80GB HBM3 at 700.00 W
// one evaluation at N = 8192 takes 0.0416 ms against the earlier design's
// 0.2167 (one thread a row, one float32 running sum a row, 64 blocks), and
// the 1M ring's 262,144 x 262,144 antipodal sweep 34.27 ms against 45.36
// with 1024 work items (chip_smoke.py check_redesign, medians of four
// alternating rounds); with 2048, as now, 33.12 ms (its float32 bound
// 19.49): the loop's 13 slots a pair and a quarter slot of shared load
// issue at 82% of the rate at the 1980 MHz boost clock.  Four rows a lane
// beat eight (34.03 against 36.87 ms; 62 registers against 96), and 1024
// or 512 items lose to 2048 (tools/k1_ring_variants.py).  The tile and
// slice partials also take the 262,144-term running sum's error out of
// the ring's antipodal sweep: 1.869e-6 of |a| against float64 where the
// earlier design reached 1.193e-3.
//
// K11 sums each j-tile's contribution plainly over the K1_THREADS staged
// bodies, then adds it to the running sum through a Kahan two-sum with a
// carried compensation (y = t - c; s' = s + y; c = (s' - s) - y), the
// Pallas kernel's tile-level compensation.  The two-sum is written with
// __fadd_rn / __fsub_rn, and the build passes no --use_fast_math, so nvcc
// neither contracts nor reassociates it (reassociated, c folds to 0).
// It costs 4 adds a tile, nothing a pair.  K11 keeps one thread per row
// and 128-thread blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math: it flushes denormals and
//        swaps the IEEE divide and rsqrt for approximations).

#include <cuda_runtime.h>

#include "onesided_tile.cuh"

#define K1_THREADS 128
// K1: rows a lane, rows a block, j-tile width.
#define K1_ROWS 4
#define K1_BLOCK_ROWS 512
#define K1_TILE 128

// s += t with the carried compensation c (a Kahan two-sum).
__device__ __forceinline__ void kahan_add(float& s, float& c, float t) {
    const float y = __fsub_rn(t, c);
    const float u = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(u, s), y);
    s = u;
}

// K11 (only its true instantiation is built; the name is the one its
// SASS has always had).
template <bool KAHAN>
__global__ void __launch_bounds__(K1_THREADS)
forces_tiled_kernel(const float* __restrict__ pos_i, long long ni,
                    const float* __restrict__ pos_j,
                    const float* __restrict__ mass_j, long long nj,
                    float eps2, float* __restrict__ acc) {
    __shared__ float4 tile[K1_THREADS];
    const long long i = (long long)blockIdx.x * K1_THREADS + threadIdx.x;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (i < ni) {
        xi = pos_i[3 * i];
        yi = pos_i[3 * i + 1];
        zi = pos_i[3 * i + 2];
    }
    float ax = 0.f, ay = 0.f, az = 0.f;
    float cx = 0.f, cy = 0.f, cz = 0.f;       // the compensation
    for (long long j0 = 0; j0 < nj; j0 += K1_THREADS) {
        const long long j = j0 + threadIdx.x;
        tile[threadIdx.x] = (j < nj)
            ? make_float4(pos_j[3 * j], pos_j[3 * j + 1], pos_j[3 * j + 2],
                          mass_j[j])
            : make_float4(0.f, 0.f, 0.f, 0.f);
        __syncthreads();
        float tx = 0.f, ty = 0.f, tz = 0.f;
#pragma unroll 8
        for (int k = 0; k < K1_THREADS; ++k) {
            const float4 b = tile[k];
            const float dx = b.x - xi;
            const float dy = b.y - yi;
            const float dz = b.z - zi;
            const float d2 = dx * dx + dy * dy + dz * dz + eps2;
            const float f = b.w * rsqrtf(d2 * d2 * d2);
            tx += f * dx;
            ty += f * dy;
            tz += f * dz;
        }
        kahan_add(ax, cx, tx);
        kahan_add(ay, cy, ty);
        kahan_add(az, cz, tz);
        __syncthreads();
    }
    if (i < ni) {
        acc[3 * i] = ax;
        acc[3 * i + 1] = ay;
        acc[3 * i + 2] = az;
    }
}

// K1's work item (row block blockIdx.x, slice blockIdx.y): the slice's
// tiles tps * blockIdx.y .. against the block's rows, into slot
// out[blockIdx.y].
__global__ void __launch_bounds__(K1_BLOCK_ROWS / K1_ROWS)
k1_tile_kernel(const float* pos_i, long long ni, const float* pos_j,
               const float* __restrict__ mass_j, long long nj, long long tps,
               float eps2, float* __restrict__ out) {
    constexpr int THREADS = K1_BLOCK_ROWS / K1_ROWS;
    __shared__ float4 tile[K1_TILE];
    const int t = threadIdx.x;
    const long long row0 = (long long)blockIdx.x * K1_BLOCK_ROWS
                           + (t >> 5) * 32 * K1_ROWS + (t & 31);
    float4 br[K1_ROWS];
    float ax[K1_ROWS], ay[K1_ROWS], az[K1_ROWS];
#pragma unroll
    for (int r = 0; r < K1_ROWS; ++r) {
        const long long i = row0 + 32 * r;
        br[r] = i < ni ? make_float4(pos_i[3 * i], pos_i[3 * i + 1],
                                     pos_i[3 * i + 2], 0.f)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        ax[r] = 0.f;
        ay[r] = 0.f;
        az[r] = 0.f;
    }
    const long long tiles = (nj + K1_TILE - 1) / K1_TILE;
    const long long t_lo = (long long)blockIdx.y * tps;
    const long long t_hi = t_lo + tps < tiles ? t_lo + tps : tiles;
    for (long long T = t_lo; T < t_hi; ++T) {
        for (int k = t; k < K1_TILE; k += THREADS)
            tile[k] = load_body(pos_j, mass_j, T * K1_TILE + k, nj);
        __syncthreads();
        float tx[K1_ROWS], ty[K1_ROWS], tz[K1_ROWS];
#pragma unroll
        for (int r = 0; r < K1_ROWS; ++r) {
            tx[r] = 0.f;
            ty[r] = 0.f;
            tz[r] = 0.f;
        }
        onesided_rows<W_MJ, K1_ROWS>(tile, K1_TILE, br, eps2, tx, ty, tz);
#pragma unroll
        for (int r = 0; r < K1_ROWS; ++r) {
            ax[r] += tx[r];
            ay[r] += ty[r];
            az[r] += tz[r];
        }
        __syncthreads();
    }
    float* slot = out + (long long)blockIdx.y * ni * 3;
#pragma unroll
    for (int r = 0; r < K1_ROWS; ++r) {
        const long long i = row0 + 32 * r;
        if (i < ni) {
            slot[3 * i] = ax[r];
            slot[3 * i + 1] = ay[r];
            slot[3 * i + 2] = az[r];
        }
    }
}

// acc = ((slot 0 + slot 1) + slot 2) ..., component by component.
__global__ void __launch_bounds__(256)
k1_reduce_kernel(const float* __restrict__ slots, long long n3, int slices,
                 float* __restrict__ acc) {
    const long long x = (long long)blockIdx.x * 256 + threadIdx.x;
    if (x >= n3) return;
    float v = slots[x];
    for (int s = 1; s < slices; ++s) v += slots[s * n3 + x];
    acc[x] = v;
}

// K1 over `slices` slices of tps j tiles each (tps * slices tiles covering
// Nj); with more than one slice `slots` holds (slices, Ni, 3) floats.
extern "C" int nbt_forces_tiled(const float* pos_i, long long ni,
                                const float* pos_j, const float* mass_j,
                                long long nj, long long tps, int slices,
                                float eps2, float* slots, float* acc,
                                void* stream) {
    if (ni <= 0) return 0;
    if (tps < 1 || slices < 1 || (slices > 1 && slots == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((unsigned)((ni + K1_BLOCK_ROWS - 1) / K1_BLOCK_ROWS),
                    (unsigned)slices);
    k1_tile_kernel<<<grid, K1_BLOCK_ROWS / K1_ROWS, 0, s>>>(
        pos_i, ni, pos_j, mass_j, nj, tps, eps2, slices > 1 ? slots : acc);
    if (slices > 1) {
        const long long n3 = ni * 3;
        k1_reduce_kernel<<<(unsigned)((n3 + 255) / 256), 256, 0, s>>>(
            slots, n3, slices, acc);
    }
    return (int)cudaGetLastError();
}

extern "C" int nbt_forces_tiled_kahan(const float* pos_i, long long ni,
                                      const float* pos_j,
                                      const float* mass_j, long long nj,
                                      float eps2, float* acc, void* stream) {
    if (ni <= 0) return 0;
    const long long blocks = (ni + K1_THREADS - 1) / K1_THREADS;
    forces_tiled_kernel<true><<<(unsigned)blocks, K1_THREADS, 0,
                                (cudaStream_t)stream>>>(
        pos_i, ni, pos_j, mass_j, nj, eps2, acc);
    return (int)cudaGetLastError();
}

extern "C" int nbt_forces_tiled_geometry(int what) {
    return what == 0 ? K1_TILE : K1_BLOCK_ROWS;
}
