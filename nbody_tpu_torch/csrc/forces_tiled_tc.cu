// K9 / K10: one-sided all-pairs forces on Hopper's tensor cores (sm_90a),
// the speed tier (turbo) and the near-exact tier (mxu).
//
// Replaces nbody_tpu/ops/forces_pallas.py:_force_kernel_turbo (K9) and
// :_force_kernel_mxu (K10), driven there by _forces_pallas_padded through
// forces_pallas and rect_forces_pallas.
//
// For every body i of the i-set, j-tile by j-tile (TC_TILE_J bodies):
//   f_ij = m_j rsqrt((|x_j - x_i|^2 + eps2)^3)        float32
//   out  = W @ pack_j,  pack = [x_hi x_lo y_hi y_lo z_hi z_lo 1 0]
//   acc_i += (x_hi + x_lo column sums) - x_i * (sum of W)   per tile
// with W = bf16(f) for turbo (one product) and W = bf16(f), bf16(f - hi)
// for mxu (two products into one accumulator).  The correction cancels, so
// it is applied once per j-tile of fixed width, as the Pallas kernels apply
// it once per block_j: the plain version (ops/forces_tiled_tc.py) uses the
// same tiles and the JAX package is compared at block_j = TC_TILE_J.
//
// The geometry is the trimmed one of K5, K6 and K14a (tc_common.cuh,
// pair_inv_fma): d2 as three FMAs with eps2 folded in and the MUFU rsqrt
// without rsqrtf's subnormal fix-up, 9 issue slots where pair_inv takes
// about 15.  The twin rounds each FMA once, as the kernel does, so the two
// round the same float32 weights to bf16 but for rare double-rounding ties.
// turbo packs two weights with one bf16x2 convert (pack2_rn, pack_rn's
// bits); mxu splits two weights at once (split2_rn, split_rn's bits).
//
// The self-pair is masked by index equality before the product when
// mask_self is set (the square case, and the rect case with self_tile):
// f_ii = m_i eps2^-1.5 ~ 1e13 times |x| ~ 1e5 would swamp the float32
// accumulator, and only exact arithmetic would cancel it again.  Only a
// tile whose j range overlaps a warp's 32 rows can hold a self-pair, so
// each warp decides once a tile whether to run the masked pass (a select,
// f = 0, since at eps2 = 0 the self-pair's weight is infinite) or the
// unmasked one; the result is that of masking every tile bit for bit.  A j
// slot past Nj is staged as a zero-mass body at the origin and adds 0.
//
// Design.  The grid is (row block, j slice), K1's work items
// (forces_tiled.cu).  A row block is TC_WARPS warps of TC_RB 16-row mma
// blocks each; a slice is `tps` consecutive j tiles.  A tile's bodies are
// staged in shared memory as float4 {x, y, z, m} and as the transposed
// pack (the mma B operand).  For each 16 columns a lane reads its four
// column bodies and its B fragment once and forms the 8 pair weights of an
// A fragment in registers for each of its warp's row blocks.  The float32
// accumulator is reduced to the per-row correction with one quad shuffle a
// tile.  Each tile's result is added to the slice's sum, and an item
// writes its rows' sums to its own slot (slice, Ni, 3); a second launch
// adds the slots in slice order: no atomics, bit-reproducible.  With one
// slice (N = 1M: the row blocks alone fill the card) the item writes the
// accelerations and there is no second launch.  The wrapper
// (ops/forces_tiled_tc.py, tc_slices) takes the slice count from Ni and
// Nj; the plain twin takes the same tiles, slices and order.  Indices are
// 64-bit.
//
// What bounds it on the card: float32 and MUFU issue, about 11 slots a
// pair for turbo (9 for pair_inv_fma, 1 for the m_j multiply, half a
// convert, a share of the shared loads) and 13.5 for mxu (the split's
// converts, subtractions and shifts, and a second mma); the tensor cores do
// 16 (32) flops a pair, ~3% of their rate.  On an H100 80GB HBM3 at
// 700.00 W (chip_smoke.py check_redesign, medians of four alternating
// rounds against the design before it, which kept one 16-row block a warp,
// 64 rows a block, pair_inv and the mask test on every pair): K9 takes
// 523.97 ms at N = 1,048,576 against 755.72, and 0.0412 ms of the card's
// time at 8192 against 0.1005; K10 621.82 against 1000.60, and 0.0473
// against 0.1160.  At 1M that is ~69% (K9) and ~71% (K10) of the issue
// rate at the 1980 MHz boost clock.  K9's item runs at 72 registers
// (seven CTAs an SM), K10's at 80 (six), no spill.  Four warps a block
// beat eight, two row blocks a warp beat one or four, 2048 work items
// beat 1024 and 4096 at 8192, and turbo's column loop runs faster rolled,
// mxu's unrolled twice (tools/tc_onesided_variants.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include "tc_common.cuh"

#define TC_TILE_J 128
// Warps a block and 16-row mma blocks a warp.
#define TC_WARPS 4
#define TC_RB 2
#define TC_THREADS (32 * TC_WARPS)
#define TC_WARP_ROWS (16 * TC_RB)
#define TC_BLOCK_ROWS (TC_WARP_ROWS * TC_WARPS)
#define TC_LD (TC_TILE_J + TC_PAD)

__device__ __forceinline__ float4 tc_row(const float* __restrict__ pos,
                                         long long i, long long n) {
    return (i < n) ? make_float4(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2],
                                 0.f)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The pass of one staged j tile over a warp's rows: d[rb] += W @ pack for
// its row blocks rb, rows xr[rb][0] (g) and xr[rb][1] (g + 8).  MASK: the
// pair whose row, counted from the tile's first body, equals its column is
// given weight 0; rel is row g of row block 0 counted so.
template <bool MXU, bool MASK>
__device__ __forceinline__ void tc_pass(const float4* tile,
                                        const __nv_bfloat16* packT,
                                        const float4 (&xr)[TC_RB][2], int g,
                                        int t, int rel, float eps2,
                                        float (&d)[TC_RB][4]) {
    // mxu's loop unrolled twice, turbo's rolled: each the faster at 8192
    // and 1M (tools/tc_onesided_variants.py).
#pragma unroll (MXU ? 2 : 1)
    for (int k0 = 0; k0 < TC_TILE_J; k0 += 16) {
        const int c = k0 + 2 * t;
        const float4 q[4] = {tile[c], tile[c + 1], tile[c + 8], tile[c + 9]};
        uint32_t b0, b1;
        load_b(packT, TC_LD, k0, g, t, b0, b1);
#pragma unroll
        for (int rb = 0; rb < TC_RB; ++rb) {
            // Fragment register r holds the pairs (row, q[qa]), (row,
            // q[qa + 1]) with row g (r even) or g + 8 (r odd), qa = 0
            // (r < 2) or 2; q[0..3] are columns c, c + 1, c + 8, c + 9.
            float f[8];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float4 x = xr[rb][r & 1];
                const int qa = (r >> 1) * 2;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float w = __fmul_rn(
                        q[qa + e].w, pair_inv_fma(x, q[qa + e], eps2));
                    f[2 * r + e] =
                        (MASK && rel + 16 * rb + 8 * (r & 1) == c + 4 * qa + e)
                            ? 0.f : w;
                }
            }
            uint32_t a[4];
            if (MXU) {
                uint32_t lo[4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    split2_rn(f[2 * r], f[2 * r + 1], a[r], lo[r]);
                mma_bf16(d[rb], a, b0, b1);
                mma_bf16(d[rb], lo, b0, b1);
            } else {
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    a[r] = pack2_rn(f[2 * r], f[2 * r + 1]);
                mma_bf16(d[rb], a, b0, b1);
            }
        }
    }
}

// The work item (row block blockIdx.x, slice blockIdx.y): the slice's
// tiles tps * blockIdx.y .. against the block's rows, each tile's result
// added to the slice's sum, the sums written to slot out[blockIdx.y].
template <bool MXU>
__global__ void __launch_bounds__(TC_THREADS)
tc_item_kernel(const float* __restrict__ pos_i, long long ni,
               const float* __restrict__ pos_j,
               const float* __restrict__ mass_j, long long nj, long long tps,
               float eps2, int mask_self, float* __restrict__ out) {
    __shared__ float4 tile[TC_TILE_J];
    __shared__ __align__(16) __nv_bfloat16 packT[8 * TC_LD];
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const long long row0 = (long long)blockIdx.x * TC_BLOCK_ROWS
                           + (threadIdx.x >> 5) * TC_WARP_ROWS;
    float4 xr[TC_RB][2];
    float acc[TC_RB][2];
#pragma unroll
    for (int rb = 0; rb < TC_RB; ++rb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            xr[rb][h] = tc_row(pos_i, row0 + 16 * rb + 8 * h + g, ni);
            acc[rb][h] = 0.f;
        }
    const long long tiles = (nj + TC_TILE_J - 1) / TC_TILE_J;
    const long long t_lo = (long long)blockIdx.y * tps;
    const long long t_hi = t_lo + tps < tiles ? t_lo + tps : tiles;
    for (long long T = t_lo; T < t_hi; ++T) {
        const long long j0 = T * TC_TILE_J;
        for (int k = threadIdx.x; k < TC_TILE_J; k += TC_THREADS) {
            const long long j = j0 + k;
            const float4 q = (j < nj)
                ? make_float4(pos_j[3 * j], pos_j[3 * j + 1],
                              pos_j[3 * j + 2], mass_j[j])
                : make_float4(0.f, 0.f, 0.f, 0.f);
            tile[k] = q;
            pack_position(packT, TC_LD, k, q);
        }
        __syncthreads();
        float d[TC_RB][4];
#pragma unroll
        for (int rb = 0; rb < TC_RB; ++rb)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[rb][e] = 0.f;
        // Whether this warp's rows meet the tile's bodies: the same for
        // the whole warp.
        if (mask_self && j0 < row0 + TC_WARP_ROWS && row0 < j0 + TC_TILE_J)
            tc_pass<MXU, true>(tile, packT, xr, g, t, (int)(row0 - j0) + g,
                               eps2, d);
        else
            tc_pass<MXU, false>(tile, packT, xr, g, t, 0, eps2, d);
#pragma unroll
        for (int rb = 0; rb < TC_RB; ++rb) {
            acc[rb][0] = __fadd_rn(acc[rb][0], tile_correction(
                d[rb][0], d[rb][1], component(xr[rb][0], t)));
            acc[rb][1] = __fadd_rn(acc[rb][1], tile_correction(
                d[rb][2], d[rb][3], component(xr[rb][1], t)));
        }
        __syncthreads();
    }
    if (t == 3) return;
    float* slot = out + (long long)blockIdx.y * ni * 3;
#pragma unroll
    for (int rb = 0; rb < TC_RB; ++rb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const long long i = row0 + 16 * rb + 8 * h + g;
            if (i < ni) slot[3 * i + t] = acc[rb][h];
        }
}

// acc = ((slot 0 + slot 1) + slot 2) ..., component by component.
__global__ void __launch_bounds__(256)
tc_reduce_kernel(const float* __restrict__ slots, long long n3, int slices,
                 float* __restrict__ acc) {
    const long long x = (long long)blockIdx.x * 256 + threadIdx.x;
    if (x >= n3) return;
    float v = slots[x];
    for (int s = 1; s < slices; ++s) v = __fadd_rn(v, slots[s * n3 + x]);
    acc[x] = v;
}

// K9 (mxu 0) or K10 (mxu 1) over `slices` slices of tps j tiles each (tps
// * slices tiles covering Nj); with more than one slice `slots` holds
// (slices, Ni, 3) floats.
extern "C" int nbt_forces_tiled_tc(const float* pos_i, long long ni,
                                   const float* pos_j, const float* mass_j,
                                   long long nj, long long tps, int slices,
                                   float eps2, int mxu, int mask_self,
                                   float* slots, float* acc, void* stream) {
    if (ni <= 0) return 0;
    if (tps < 1 || slices < 1 || (slices > 1 && slots == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((unsigned)((ni + TC_BLOCK_ROWS - 1) / TC_BLOCK_ROWS),
                    (unsigned)slices);
    float* out = slices > 1 ? slots : acc;
    if (mxu)
        tc_item_kernel<true><<<grid, TC_THREADS, 0, s>>>(
            pos_i, ni, pos_j, mass_j, nj, tps, eps2, mask_self, out);
    else
        tc_item_kernel<false><<<grid, TC_THREADS, 0, s>>>(
            pos_i, ni, pos_j, mass_j, nj, tps, eps2, mask_self, out);
    if (slices > 1) {
        const long long n3 = ni * 3;
        tc_reduce_kernel<<<(unsigned)((n3 + 255) / 256), 256, 0, s>>>(
            slots, n3, slices, acc);
    }
    return (int)cudaGetLastError();
}

// The j-tile width (what 0) and the rows a block (what 1).
extern "C" int nbt_tiled_tc_geometry(int what) {
    return what == 0 ? TC_TILE_J : TC_BLOCK_ROWS;
}
