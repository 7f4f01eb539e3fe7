// K9 / K10: one-sided all-pairs forces on Hopper's tensor cores (sm_90a),
// the speed tier (turbo) and the near-exact tier (mxu).
//
// Replaces nbody_tpu/ops/forces_pallas.py:_force_kernel_turbo (K9) and
// :_force_kernel_mxu (K10), driven there by _forces_pallas_padded through
// forces_pallas and rect_forces_pallas.
//
// For every body i of the i-set, j-tile by j-tile (TC_TILE_J bodies):
//   f_ij = m_j rsqrt((|x_j - x_i|^2 + eps2)^3)        exact float32
//   out  = W @ pack_j,  pack = [x_hi x_lo y_hi y_lo z_hi z_lo 1 0]
//   acc_i += (x_hi + x_lo column sums) - x_i * (sum of W)   per tile
// with W = bf16(f) for turbo (one product) and W = bf16(f), bf16(f - hi)
// for mxu (two products into one accumulator).  The correction cancels, so
// it is applied once per j-tile of fixed width, as the Pallas kernels apply
// it once per block_j: the plain version (ops/forces_tiled_tc.py) uses the
// same tiles and the JAX package is compared at block_j = TC_TILE_J.
//
// The self-pair is masked by index equality before the product when
// mask_self is set (the square case, and the rect case with self_tile):
// f_ii = m_i eps2^-1.5 ~ 1e13 times |x| ~ 1e5 would swamp the float32
// accumulator, and only exact arithmetic would cancel it again.  A j slot
// past Nj is staged as a zero-mass body at the origin and adds 0.
//
// Design: a block of TC_WARPS warps owns 16 i-rows per warp; each warp
// computes the 16 x 16 pair weights of an mma A fragment in registers (no
// shared memory), 8 pairs a lane, and multiplies them with the j-tile's
// pack, staged transposed in shared memory as the B operand.  The float32
// accumulator fragment is reduced to the per-row correction with one quad
// shuffle.  Indices are 64-bit.
//
// What bounds it on the card: float32 throughput.  An interaction costs 13
// float32 operations (3 sub, 3 mul + 3 add for d2 + eps2, 2 mul for the
// cube, 1 rsqrt on the MUFU, 1 mul by m_j; 14 for mxu with the split's
// subtract) plus the bf16 rounding and the self-pair test, against 16
// tensor-core flops (32 for mxu): the geometry on the float32 pipes is the
// limit, not the tensor cores.  Left for later: FMA-contracted geometry
// (it would change the bf16 roundings against the plain version), several
// rows a lane to reuse the staged j values, and splitting j across warps
// at small N.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include "tc_common.cuh"

#define TC_TILE_J 128
#define TC_WARPS 4
#define TC_THREADS (32 * TC_WARPS)
#define TC_ROWS (16 * TC_WARPS)
#define TC_LD (TC_TILE_J + TC_PAD)

static_assert(TC_THREADS == TC_TILE_J, "one staging thread per j slot");

__device__ __forceinline__ float4 load_row(const float* __restrict__ pos,
                                           long long i, long long n) {
    return (i < n) ? make_float4(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2],
                                 0.f)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Weight of pair (i, j); 0 for the self-pair when masking.
__device__ __forceinline__ float weight(float4 bi, long long i, float4 bj,
                                        long long j, float eps2,
                                        bool mask_self) {
    const float f = __fmul_rn(bj.w, pair_inv(bi, bj, eps2));
    return (mask_self && i == j) ? 0.f : f;
}

template <bool MXU>
__global__ void __launch_bounds__(TC_THREADS)
forces_tiled_tc_kernel(const float* __restrict__ pos_i, long long ni,
                       const float* __restrict__ pos_j,
                       const float* __restrict__ mass_j, long long nj,
                       float eps2, int mask_self, float* __restrict__ acc) {
    __shared__ float4 tile[TC_TILE_J];
    __shared__ __align__(16) __nv_bfloat16 packT[8 * TC_LD];
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const long long ia = (long long)blockIdx.x * TC_ROWS
                         + (threadIdx.x >> 5) * 16 + g;
    const long long ib = ia + 8;
    const float4 xa = load_row(pos_i, ia, ni);
    const float4 xb = load_row(pos_i, ib, ni);
    const bool mask = mask_self != 0;
    float acc_a = 0.f, acc_b = 0.f;

    for (long long j0 = 0; j0 < nj; j0 += TC_TILE_J) {
        const long long j = j0 + threadIdx.x;
        const float4 q = (j < nj)
            ? make_float4(pos_j[3 * j], pos_j[3 * j + 1], pos_j[3 * j + 2],
                          mass_j[j])
            : make_float4(0.f, 0.f, 0.f, 0.f);
        tile[threadIdx.x] = q;
        pack_position(packT, TC_LD, threadIdx.x, q);
        __syncthreads();

        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int k0 = 0; k0 < TC_TILE_J; k0 += 16) {
            const int c = k0 + 2 * t;
            const long long jc = j0 + c;
            const float4 q0 = tile[c], q1 = tile[c + 1];
            const float4 q2 = tile[c + 8], q3 = tile[c + 9];
            const float f[8] = {
                weight(xa, ia, q0, jc, eps2, mask),
                weight(xa, ia, q1, jc + 1, eps2, mask),
                weight(xb, ib, q0, jc, eps2, mask),
                weight(xb, ib, q1, jc + 1, eps2, mask),
                weight(xa, ia, q2, jc + 8, eps2, mask),
                weight(xa, ia, q3, jc + 9, eps2, mask),
                weight(xb, ib, q2, jc + 8, eps2, mask),
                weight(xb, ib, q3, jc + 9, eps2, mask)};
            uint32_t b0, b1;
            load_b(packT, TC_LD, k0, g, t, b0, b1);
            uint32_t a[4];
            if (MXU) {
                uint32_t lo[4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    split_rn(f[2 * r], f[2 * r + 1], a[r], lo[r]);
                mma_bf16(d, a, b0, b1);
                mma_bf16(d, lo, b0, b1);
            } else {
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    a[r] = pack_rn(f[2 * r], f[2 * r + 1]);
                mma_bf16(d, a, b0, b1);
            }
        }
        const float ca = tile_correction(d[0], d[1], component(xa, t));
        const float cb = tile_correction(d[2], d[3], component(xb, t));
        acc_a = __fadd_rn(acc_a, ca);
        acc_b = __fadd_rn(acc_b, cb);
        __syncthreads();
    }
    if (t < 3) {
        if (ia < ni) acc[3 * ia + t] = acc_a;
        if (ib < ni) acc[3 * ib + t] = acc_b;
    }
}

extern "C" int nbt_forces_tiled_tc(const float* pos_i, long long ni,
                                   const float* pos_j, const float* mass_j,
                                   long long nj, float eps2, int mxu,
                                   int mask_self, float* acc, void* stream) {
    if (ni <= 0) return 0;
    const long long blocks = (ni + TC_ROWS - 1) / TC_ROWS;
    cudaStream_t s = (cudaStream_t)stream;
    if (mxu)
        forces_tiled_tc_kernel<true><<<(unsigned)blocks, TC_THREADS, 0, s>>>(
            pos_i, ni, pos_j, mass_j, nj, eps2, mask_self, acc);
    else
        forces_tiled_tc_kernel<false><<<(unsigned)blocks, TC_THREADS, 0, s>>>(
            pos_i, ni, pos_j, mass_j, nj, eps2, mask_self, acc);
    return (int)cudaGetLastError();
}

extern "C" int nbt_tiled_tc_tile(void) { return TC_TILE_J; }
