// K8: the pair potential for Hopper (sm_90a): row sums (pe_rows) and the
// pair-symmetric total (pe_total).
//
// Replaces nbody_tpu/ops/pe_pallas.py:_pe_kernel (launched by
// _pe_rows_padded at :66) and pe_rows_pallas (:92), the device half of
// total_energy_bounded.
//
// Both compute, for rows i against bodies j,
//     m_i * sum_j m_j * rsqrt(|x_j - x_i|^2 + eps2)
// with no mask: the self pair is included (it adds m_i^2 / sqrt(eps2)) and
// the caller subtracts the closed-form self total in float64, as the JAX
// package does.  The accuracy class is the JAX kernel's and the same for
// both: float32 pair terms summed in float32 partials of at most 256 terms
// a row, the partials added in float64 and scaled by m_i in float64.  The
// self term rides in its tile's float32 partial (pe_pallas.py:14-21 states
// the consequence for any f32 row accumulator): about 3e-5 relative at
// N = 3k, 3e-7 at 1M.
//
// pe_rows (row subset against all bodies; the sampled-row checks).  K1's
// shape: one thread per row, blocks of PE_THREADS threads; the full set is
// swept in tiles of PE_THREADS bodies staged through shared memory as
// float4 {x, y, z, m}, the ragged edge staged as zero-mass bodies, each
// tile summed in one float32 partial, one float64 output per row.  About
// 13 issue slots a pair: an LDS.128, 3 FADD, the d2 chain, rsqrtf with its
// subnormal fix-up (an FSETP and two predicated FMULs), one FFMA.
//
// pe_total (the whole set against itself, as total_energy_bounded calls
// pe_rows_pallas(pos, mass, pos, mass)).  The summand is symmetric in i
// and j, so each unordered tile pair is visited once, on K2's circular
// schedule: row tile I against column tile J = (I + d) mod nb for
// d = 0 .. nb/2, the half offset d = nb/2 of an even nb taken by the rows
// I < nb/2 only (forces_sym.cu states why this visits every pair once and
// balances the rows).  The d = 0 tile (I against itself) is summed whole,
// self pairs included, with weight 1; every other tile with weight 2,
// which is exact in float64.  Ghost slots past N load as zero-mass bodies
// at the origin; ghost rows are left out of the sums (with eps2 = 0 a
// ghost pair would give 0 * inf), ghost columns add 0.  A real massless
// body adds exactly 0, as in JAX.  With eps2 = 0 the self pairs give inf,
// as JAX's do; nothing masks it.
//
// A block of 256 threads takes one row tile I and a run of `chunk`
// consecutive offsets (ops/pe.py picks the run so that the grid has about
// PE_TOTAL_BLOCKS blocks).  Lane l of warp w holds rows
// l + 32r (r < PE_ROWS = 8) of I in registers and sweeps columns
// 32w .. 32w+31 of each J: one broadcast LDS.128 of a column body serves
// its eight rows.  A pair is 3 FADD for the difference, d2 as three FMAs
// with eps2 folded in, one MUFU rsqrt on d2 without rsqrtf's subnormal
// fix-up (rsqrt_normal: rsqrtf's bits for every d2 >= eps2 above the
// smallest normal float, ~1.2e-38; a subnormal d2, possible only with
// eps2 = 0, flushes to 0 and gives inf), and one FFMA into the row's
// float32 partial (32 terms): 8 issue slots and an eighth of a load.  Once
// a tile the eight partials are scaled by m_i in float64 and added into
// the thread's float64 sum; the block adds its 256 sums in a fixed order
// (a shuffle tree, then the warps in order) into one float64 partial, and
// pe_sum_kernel adds the partials in a fixed order.  No atomics: the
// result is bit-reproducible from run to run.
//
// What bounds it on the card: the MUFU (16 rsqrt a clock an SM) and FP32
// issue together.  N(N-1)/2 pairs at one rsqrt each is 131.5 ms at
// N = 1,048,576 on 132 SMs at 1.98 GHz; 8 issue slots a pair 136 ms.
// On an H100 80GB HBM3 at 700 W the total takes 187.2 ms there (70% of
// that rate; the row sums of every body, 492.6 ms).  pe_rows counts N^2
// pairs at 13 slots.  Device memory is no bound: the column tiles come
// from L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include <cuda_runtime.h>

#include "sym_common.cuh"

#define PE_THREADS 256
// pe_total: the tile (rows and columns), rows a lane holds, warps.
#define PE_TILE 256
#define PE_ROWS (PE_TILE / 32)
#define PE_WARPS (PE_TILE / 32)
#define PE_SUM_THREADS 1024

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

// One block per (row tile I, run c of `chunk` offsets): blockIdx.x =
// c * nb + I.  Writes the run's weighted float64 sum to partials[blockIdx.x].
__global__ void __launch_bounds__(PE_TILE)
pe_total_kernel(const float* __restrict__ pos,
                const float* __restrict__ mass, long long n, long long nb,
                long long chunk, float eps2, double* __restrict__ partials) {
    __shared__ float4 cols[PE_TILE];
    __shared__ double warp_sum[PE_WARPS];
    const long long bid = blockIdx.x;
    const long long c = bid / nb;
    const long long I = bid - c * nb;
    const long long n_off = nb / 2 + 1;
    const long long d_lo = c * chunk;
    long long d_hi = d_lo + chunk < n_off ? d_lo + chunk : n_off;
    // Even nb: the half offset belongs to the rows I < nb/2.
    if (nb % 2 == 0 && 2 * I >= nb && d_hi == n_off) --d_hi;
    const int t = threadIdx.x;
    const int w = t >> 5;
    const int l = t & 31;

    float xr[PE_ROWS], yr[PE_ROWS], zr[PE_ROWS], mr[PE_ROWS];
    unsigned real = 0u;                   // bit r: row l + 32r is a body
#pragma unroll
    for (int r = 0; r < PE_ROWS; ++r) {
        const long long i = I * PE_TILE + l + 32 * r;
        const float4 b = load_body(pos, mass, i, n);
        xr[r] = b.x;
        yr[r] = b.y;
        zr[r] = b.z;
        mr[r] = b.w;
        if (i < n) real |= 1u << r;
    }
    double acc = 0.0;
    float4 next = load_body(pos, mass, ((I + d_lo) % nb) * PE_TILE + t, n);
    for (long long d = d_lo; d < d_hi; ++d) {
        __syncthreads();                  // the last tile's readers
        cols[t] = next;
        __syncthreads();
        if (d + 1 < d_hi)
            next = load_body(pos, mass, ((I + d + 1) % nb) * PE_TILE + t, n);
        float part[PE_ROWS];
#pragma unroll
        for (int r = 0; r < PE_ROWS; ++r) part[r] = 0.f;
        const float4* cw = cols + 32 * w;
#pragma unroll 8
        for (int k = 0; k < 32; ++k) {
            const float4 q = cw[k];
#pragma unroll
            for (int r = 0; r < PE_ROWS; ++r) {
                const float dx = q.x - xr[r];
                const float dy = q.y - yr[r];
                const float dz = q.z - zr[r];
                const float d2 =
                    fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
                part[r] = fmaf(q.w, rsqrt_normal(d2), part[r]);
            }
        }
        double tile = 0.0;
#pragma unroll
        for (int r = 0; r < PE_ROWS; ++r)
            if (real & (1u << r)) tile += (double)mr[r] * (double)part[r];
        acc += d == 0 ? tile : 2.0 * tile;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (l == 0) warp_sum[w] = acc;
    __syncthreads();
    if (t == 0) {
        double s = 0.0;
#pragma unroll
        for (int v = 0; v < PE_WARPS; ++v) s += warp_sum[v];
        partials[bid] = s;
    }
}

// One block: the partials added in a fixed order (strided sums, then a
// tree) into out[0].
__global__ void __launch_bounds__(PE_SUM_THREADS)
pe_sum_kernel(const double* __restrict__ partials, long long count,
              double* __restrict__ out) {
    __shared__ double s[PE_SUM_THREADS];
    const int t = threadIdx.x;
    double a = 0.0;
    for (long long k = t; k < count; k += PE_SUM_THREADS) a += partials[k];
    s[t] = a;
    __syncthreads();
    for (int h = PE_SUM_THREADS / 2; h > 0; h >>= 1) {
        if (t < h) s[t] += s[t + h];
        __syncthreads();
    }
    if (t == 0) out[0] = s[0];
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

// pe_total: `partials` holds nb * ceil((nb/2 + 1) / chunk) doubles, `out`
// one.  n >= 1.
extern "C" int nbt_pe_total(const float* pos, const float* mass,
                            long long n, long long chunk, float eps2,
                            double* partials, double* out, void* stream) {
    const long long nb = (n + PE_TILE - 1) / PE_TILE;
    const long long runs = (nb / 2 + 1 + chunk - 1) / chunk;
    pe_total_kernel<<<(unsigned)(nb * runs), PE_TILE, 0,
                      (cudaStream_t)stream>>>(pos, mass, n, nb, chunk, eps2,
                                              partials);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    pe_sum_kernel<<<1, PE_SUM_THREADS, 0, (cudaStream_t)stream>>>(
        partials, nb * runs, out);
    return (int)cudaGetLastError();
}

extern "C" int nbt_pe_tile(void) { return PE_THREADS; }
extern "C" int nbt_pe_total_tile(void) { return PE_TILE; }
