// K8: pair-potential row sums for Hopper (sm_90a).
//
// Replaces nbody_tpu/ops/pe_pallas.py:_pe_kernel (launched by
// _pe_rows_padded at :66), the device half of total_energy_bounded.
//
// Computes, for every row i of the row set against every body j of the
// full set,
//     out_i = m_i * sum_j m_j * rsqrt(|x_j - x_i|^2 + eps2)
// with no mask: the self pair is included (it adds m_i^2 / sqrt(eps2)) and
// the caller subtracts the closed-form self total in float64, as the JAX
// package does.
//
// Design: K1's shape.  One thread per row, blocks of PE_THREADS threads;
// the full set is swept in tiles of PE_THREADS bodies staged through shared
// memory as float4 {x, y, z, m}, the ragged edge staged as zero-mass bodies
// (inert on both sides).  Each tile's terms are summed in a float32 partial
// (PE_THREADS terms), and the partials are added in float64, so the row sum
// of N = 1M terms carries float32 rounding of 256-term sums only; the JAX
// kernel adds 2048-term float32 blocks into a float32 row.  The output is
// float64 per row.  The accuracy class is set by the self term, which rides
// in its tile's float32 partial (pe_pallas.py:14-21 states it for any f32
// row accumulator): about 3e-5 relative at N = 3k, 3e-7 at 1M.
//
// What bounds it on the card: FP32 and MUFU issue, about 12 flops a pair
// (3 sub, 3 FMA for d2 + eps2, 1 rsqrt, 1 FMA into the partial) plus one
// MUFU rsqrt; shared-memory tiles make device memory no bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include <cuda_runtime.h>

#define PE_THREADS 256

__global__ void __launch_bounds__(PE_THREADS)
pe_rows_kernel(const float* __restrict__ pos_r,
               const float* __restrict__ mass_r, long long nr,
               const float* __restrict__ pos_a,
               const float* __restrict__ mass_a, long long na, float eps2,
               double* __restrict__ out) {
    __shared__ float4 tile[PE_THREADS];
    const long long i = (long long)blockIdx.x * PE_THREADS + threadIdx.x;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (i < nr) {
        xi = pos_r[3 * i];
        yi = pos_r[3 * i + 1];
        zi = pos_r[3 * i + 2];
    }
    double row = 0.0;
    for (long long j0 = 0; j0 < na; j0 += PE_THREADS) {
        const long long j = j0 + threadIdx.x;
        tile[threadIdx.x] = (j < na)
            ? make_float4(pos_a[3 * j], pos_a[3 * j + 1], pos_a[3 * j + 2],
                          mass_a[j])
            : make_float4(0.f, 0.f, 0.f, 0.f);
        __syncthreads();
        float part = 0.f;
#pragma unroll 8
        for (int k = 0; k < PE_THREADS; ++k) {
            const float4 b = tile[k];
            const float dx = b.x - xi;
            const float dy = b.y - yi;
            const float dz = b.z - zi;
            const float d2 = dx * dx + dy * dy + dz * dz + eps2;
            part += b.w * rsqrtf(d2);
        }
        row += (double)part;
        __syncthreads();
    }
    if (i < nr) out[i] = (double)mass_r[i] * row;
}

extern "C" int nbt_pe_rows(const float* pos_r, const float* mass_r,
                           long long nr, const float* pos_a,
                           const float* mass_a, long long na, float eps2,
                           double* out, void* stream) {
    if (nr <= 0) return 0;
    const long long blocks = (nr + PE_THREADS - 1) / PE_THREADS;
    pe_rows_kernel<<<(unsigned)blocks, PE_THREADS, 0, (cudaStream_t)stream>>>(
        pos_r, mass_r, nr, pos_a, mass_a, na, eps2, out);
    return (int)cudaGetLastError();
}

extern "C" int nbt_pe_tile(void) { return PE_THREADS; }
