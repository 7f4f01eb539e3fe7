// K1 and K11: one-sided exact all-pairs force tiles for Hopper (sm_90a).
//
// Replaces nbody_tpu/ops/forces_pallas.py:_force_kernel_vpu (K1) and
// :_force_kernel_vpu_kahan (K11), driven there by _forces_pallas_padded,
// forces_pallas and rect_forces_pallas.
//
// Computes, for every body i of the i-set,
//     acc_i = sum_j m_j * r_ij * rsqrt((|r_ij|^2 + eps2)^3),  r_ij = x_j - x_i
// with no i != j guard: the self-pair vanishes because r = 0, exactly as in
// the JAX kernel and the reference's tiled kernel.
//
// Design: one thread per i-body, blocks of K1_THREADS threads.  The j-set is
// swept in tiles of K1_THREADS bodies staged through shared memory as float4
// {x, y, z, m}; every thread of the block reads each staged body by
// broadcast.  The ragged edge is masked at load time: a j slot past Nj is
// staged as a zero-mass body at the origin (it contributes exactly 0), and
// threads past Ni load no position and store nothing.  Indices are 64-bit.
//
// What bounds it on the card: FP32 FMA and MUFU issue.  Each interaction is
// about 20 flops (3 sub, 3 FMA for d2 + eps2, 2 mul for the cube, 1 rsqrt,
// 1 mul by m_j, 3 FMA into the accumulator) plus one MUFU rsqrt, which
// issues at a quarter of the FP32 rate.  Device memory is not a bound: each
// staged tile is reused K1_THREADS times from shared memory.
//
// K11 sums each j-tile's contribution plainly over the K1_THREADS staged
// bodies, then adds it to the running sum through a Kahan two-sum with a
// carried compensation (y = t - c; s' = s + y; c = (s' - s) - y), the
// Pallas kernel's tile-level compensation.  The two-sum is written with
// __fadd_rn / __fsub_rn, and the build passes no --use_fast_math, so nvcc
// neither contracts nor reassociates it (reassociated, c folds to 0).
// It costs 4 adds a tile, nothing a pair.
//
// Left for later: one thread per body leaves the card under-occupied at
// small N (N/128 blocks for 132 SMs); splitting j across threads, TMA-fed
// multi-stage tiles and a wgmma-based accumulation are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math: it flushes denormals and
//        swaps the IEEE divide and rsqrt for approximations).

#include <cuda_runtime.h>

#define K1_THREADS 128

// s += t with the carried compensation c (a Kahan two-sum).
__device__ __forceinline__ void kahan_add(float& s, float& c, float t) {
    const float y = __fsub_rn(t, c);
    const float u = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(u, s), y);
    s = u;
}

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
    float cx = 0.f, cy = 0.f, cz = 0.f;       // K11's compensation
    for (long long j0 = 0; j0 < nj; j0 += K1_THREADS) {
        const long long j = j0 + threadIdx.x;
        tile[threadIdx.x] = (j < nj)
            ? make_float4(pos_j[3 * j], pos_j[3 * j + 1], pos_j[3 * j + 2],
                          mass_j[j])
            : make_float4(0.f, 0.f, 0.f, 0.f);
        __syncthreads();
        // K1 sums straight into the running sum, K11 into the tile's own.
        float tx = 0.f, ty = 0.f, tz = 0.f;
        float& sx = KAHAN ? tx : ax;
        float& sy = KAHAN ? ty : ay;
        float& sz = KAHAN ? tz : az;
#pragma unroll 8
        for (int k = 0; k < K1_THREADS; ++k) {
            const float4 b = tile[k];
            const float dx = b.x - xi;
            const float dy = b.y - yi;
            const float dz = b.z - zi;
            const float d2 = dx * dx + dy * dy + dz * dz + eps2;
            const float f = b.w * rsqrtf(d2 * d2 * d2);
            sx += f * dx;
            sy += f * dy;
            sz += f * dz;
        }
        if (KAHAN) {
            kahan_add(ax, cx, tx);
            kahan_add(ay, cy, ty);
            kahan_add(az, cz, tz);
        }
        __syncthreads();
    }
    if (i < ni) {
        acc[3 * i] = ax;
        acc[3 * i + 1] = ay;
        acc[3 * i + 2] = az;
    }
}

template <bool KAHAN>
static int launch(const float* pos_i, long long ni, const float* pos_j,
                  const float* mass_j, long long nj, float eps2, float* acc,
                  void* stream) {
    if (ni <= 0) return 0;
    const long long blocks = (ni + K1_THREADS - 1) / K1_THREADS;
    forces_tiled_kernel<KAHAN><<<(unsigned)blocks, K1_THREADS, 0,
                                 (cudaStream_t)stream>>>(
        pos_i, ni, pos_j, mass_j, nj, eps2, acc);
    return (int)cudaGetLastError();
}

extern "C" int nbt_forces_tiled(const float* pos_i, long long ni,
                                const float* pos_j, const float* mass_j,
                                long long nj, float eps2, float* acc,
                                void* stream) {
    return launch<false>(pos_i, ni, pos_j, mass_j, nj, eps2, acc, stream);
}

extern "C" int nbt_forces_tiled_kahan(const float* pos_i, long long ni,
                                      const float* pos_j,
                                      const float* mass_j, long long nj,
                                      float eps2, float* acc, void* stream) {
    return launch<true>(pos_i, ni, pos_j, mass_j, nj, eps2, acc, stream);
}
