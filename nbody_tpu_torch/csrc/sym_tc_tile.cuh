// The tensor-core pair tile of K5, K6, K14a-c, K2-rect and K15's tmm_*
// ablations (forces_sym_tc.cu) and of K13 (rdma_ring.cu): sym_tc_tile, its
// variants, shared memory and packs.  Moved here verbatim from
// forces_sym_tc.cu so that rdma_ring.cu compiles the same tile.

#pragma once

#include "sym_common.cuh"
#include "tc_common.cuh"

#define SYM_LD (SYM_TILE + TC_PAD)

// The pair tiles of forces_sym_tc.cu.  TURBOP is TURBO's math on a deferred
// j-side schedule.  The last four are K15's ablations of TURBO's tile
// (nbody_tpu/ops/ablation_sym.py, _tile_turbo_mm):
//   TMM_FULL    TURBO itself: JAX rebuilt the (U,3) j positions from the
//               transposed tile, which here are both packed from one
//               float4 tile already (the control);
//   TMM_NOSCAT  TURBO's tile, its column sums stored in the writer's own
//               row slot, all added into tile 0's bodies by the reduce;
//   TMM_NOJ     the i-side product only: no transposed i pack, j-side
//               weights, movmatrix, second mma chain or partials;
//   TMM_NOMM    the pair terms and both bf16 roundings, no mma: each row
//               sums bf16(m_j inv) + bf16(m_i inv) over the tile (the row
//               reduce that keeps the roundings live), the same sum for
//               each of its three components.
enum SymTcVariant { TURBO, MXU, TURBO2, TURBOF, TURBOP, TMM_FULL, TMM_NOSCAT,
                    TMM_NOJ, TMM_NOMM };

// The tile a variant's pairs kernel runs: TMM_FULL and TMM_NOSCAT run
// TURBO's (they differ from it in their slot and reduce only).
__host__ __device__ constexpr int tc_tile_of(int v) {
    return (v == TMM_FULL || v == TMM_NOSCAT) ? (int)TURBO : v;
}

// Whether a pairs kernel of forces_sym_tc.cu runs the trimmed geometry
// (pair_inv_fma): K5 and the kernels defined as K5's values, turbop and
// the TMM_FULL / TMM_NOSCAT controls, so that they stay bit-equal to it.
// The other variants, and K13's tiles (rdma_ring.cu), keep pair_inv.
__host__ __device__ constexpr bool tc_trimmed(int v) {
    return v == TURBO || v == TURBOP || v == TMM_FULL || v == TMM_NOSCAT;
}

struct SymTcSmem {
    float4 tile[SYM_TILE];                 // column tile J: x, y, z, m
    __nv_bfloat16 pack_j[8 * SYM_LD];      // J's pack, transposed
    __nv_bfloat16 pack_i[8 * SYM_LD];      // I's pack, transposed
    float part[SYM_WARPS][SYM_TILE][4];    // per-warp j-side sums
};

template <int V>
__device__ __forceinline__ void pack_body(__nv_bfloat16* packT, int k,
                                          float4 b) {
    if (V == MXU || V == TURBO2)
        pack_mass_folded(packT, SYM_LD, k, b);
    else
        pack_position(packT, SYM_LD, k, b);
}

// A warp's j-side sums of column block k0 (rows k0 + g and k0 + g + 8 of
// the accumulator) into its shared-memory partials.
__device__ __forceinline__ void store_part(SymTcSmem& sm, int w, int k0,
                                           int g, int t, const float dj[4]) {
    sm.part[w][k0 + g][t] = __fadd_rn(dj[0], dj[1]);
    sm.part[w][k0 + g + 8][t] = __fadd_rn(dj[2], dj[3]);
}

// The pair tile of row tile I of body set i (n_i bodies) against column
// tile J of body set j (n_j bodies): the row sums of I go to si_tile[3 * r]
// for its rows r = 0 .. SYM_TILE-1, the column sums of J to
// sj_tile[3 * c] for its columns c.  The square sweep calls it with one
// body set on both sides, the rect sweep (K2-rect) with the two sets.
// TRIM: each pair's inv from pair_inv_fma, else from pair_inv (the values
// differ in the last bits of d2, and so in rare bf16 roundings), and the
// column loop unrolled twice.  Every thread of the block calls it.
template <int V, bool TRIM = false>
__device__ __forceinline__ void sym_tc_tile(
        const float* __restrict__ pos_i, const float* __restrict__ mass_i,
        long long n_i, long long I, const float* __restrict__ pos_j,
        const float* __restrict__ mass_j, long long n_j, long long J,
        float eps2, float* __restrict__ si_tile,
        float* __restrict__ sj_tile, SymTcSmem& sm) {
    const int tid = threadIdx.x;
    const int w = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;

    const float4 own_j = load_body(pos_j, mass_j, J * SYM_TILE + tid, n_j);
    sm.tile[tid] = own_j;
    if (V != TMM_NOMM) pack_body<V>(sm.pack_j, tid, own_j);
    if (V != TMM_NOJ && V != TMM_NOMM)
        pack_body<V>(sm.pack_i, tid,
                     load_body(pos_i, mass_i, I * SYM_TILE + tid, n_i));
    // Rows g and g + 8 of this warp's two 16-row blocks.
    float4 xr[2][2];
    const int r0 = 32 * w + g;
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
        xr[rb][0] = load_body(pos_i, mass_i, I * SYM_TILE + r0 + 16 * rb,
                              n_i);
        xr[rb][1] = load_body(pos_i, mass_i, I * SYM_TILE + r0 + 16 * rb + 8,
                              n_i);
    }
    __syncthreads();
    uint32_t bi[2][2];
    if (V != TMM_NOJ && V != TMM_NOMM) {
#pragma unroll
        for (int rb = 0; rb < 2; ++rb)
            load_b(sm.pack_i, SYM_LD, 32 * w + 16 * rb, g, t, bi[rb][0],
                   bi[rb][1]);
    }

    float di[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dj[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t aj_prev[4] = {0u, 0u, 0u, 0u};   // TURBOP: the deferred block
    // TMM_NOMM: rows g, g + 8 of each row block, sums of bf16(m_j inv) and
    // of bf16(m_i inv) over this lane's columns.
    float wi_sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float wj_sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    // The trimmed tile unrolls the 16-column loop twice (80 registers
    // still, three CTAs an SM; tools/sym_tc_variants.py); the others keep
    // it rolled, their code unchanged.
#pragma unroll (TRIM ? 2 : 1)
    for (int k0 = 0; k0 < SYM_TILE; k0 += 16) {
        const int c = k0 + 2 * t;
        const float4 q[4] = {sm.tile[c], sm.tile[c + 1], sm.tile[c + 8],
                             sm.tile[c + 9]};
        uint32_t bj0 = 0u, bj1 = 0u;
        if (V != TMM_NOMM) load_b(sm.pack_j, SYM_LD, k0, g, t, bj0, bj1);
        if (V != TURBOP) {
#pragma unroll
            for (int e = 0; e < 4; ++e) dj[e] = 0.f;
        }
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) {
            // Fragment register r holds the pairs (row, q[qa]), (row, q[qa+1])
            // with row = g (r even) or g + 8 (r odd), qa = 0 (r < 2) or 2.
            float inv[8];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float4 x = xr[rb][r & 1];
                const int qa = (r >> 1) * 2;
                inv[2 * r] = TRIM ? pair_inv_fma(x, q[qa], eps2)
                                  : pair_inv(x, q[qa], eps2);
                inv[2 * r + 1] = TRIM ? pair_inv_fma(x, q[qa + 1], eps2)
                                      : pair_inv(x, q[qa + 1], eps2);
            }
            uint32_t a[4], at[4];
            if (V == TMM_NOMM) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float mi = xr[rb][r & 1].w;
                    const int qa = (r >> 1) * 2;
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const float f = inv[2 * r + e];
                        wi_sum[rb][r & 1] += __bfloat162float(
                            __float2bfloat16_rn(__fmul_rn(q[qa + e].w, f)));
                        wj_sum[rb][r & 1] += __bfloat162float(
                            __float2bfloat16_rn(__fmul_rn(mi, f)));
                    }
                }
            } else if (V == MXU) {
                uint32_t lo[4], lot[4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    split_rn(inv[2 * r], inv[2 * r + 1], a[r], lo[r]);
                mma_bf16(di[rb], a, bj0, bj1);
                mma_bf16(di[rb], lo, bj0, bj1);
                transpose_a(a, at);
                transpose_a(lo, lot);
                mma_bf16(dj, at, bi[rb][0], bi[rb][1]);
                mma_bf16(dj, lot, bi[rb][0], bi[rb][1]);
            } else if (V == TURBO2 || V == TURBOF) {
                // One weight matrix for both sides.
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    if (V == TURBO2) {
                        a[r] = pack_rn(inv[2 * r], inv[2 * r + 1]);
                    } else {
                        const float mi = xr[rb][r & 1].w;
                        const int qa = (r >> 1) * 2;
                        a[r] = pack_rn(
                            __fmul_rn(__fmul_rn(mi, q[qa].w), inv[2 * r]),
                            __fmul_rn(__fmul_rn(mi, q[qa + 1].w),
                                      inv[2 * r + 1]));
                    }
                }
                mma_bf16(di[rb], a, bj0, bj1);
                transpose_a(a, at);
                mma_bf16(dj, at, bi[rb][0], bi[rb][1]);
            } else {
                uint32_t aj[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float mi = xr[rb][r & 1].w;
                    const int qa = (r >> 1) * 2;
                    a[r] = pack_rn(__fmul_rn(q[qa].w, inv[2 * r]),
                                   __fmul_rn(q[qa + 1].w, inv[2 * r + 1]));
                    if (V != TMM_NOJ)
                        aj[r] = pack_rn(__fmul_rn(mi, inv[2 * r]),
                                        __fmul_rn(mi, inv[2 * r + 1]));
                }
                mma_bf16(di[rb], a, bj0, bj1);
                if (V == TMM_NOJ) {
                    // The i side only.
                } else if (V == TURBO) {
                    transpose_a(aj, at);
                    mma_bf16(dj, at, bi[rb][0], bi[rb][1]);
                } else {
                    // TURBOP: the previous block's j-side now, this
                    // block's at the next one.  The previous block is
                    // (k0, row block 0) when rb = 1, else (k0 - 16, row
                    // block 1), whose column block is then complete.
                    if (rb == 1 || k0 > 0) {
                        transpose_a(aj_prev, at);
                        mma_bf16(dj, at, bi[1 - rb][0], bi[1 - rb][1]);
                    }
                    if (rb == 0) {
                        if (k0 > 0) store_part(sm, w, k0 - 16, g, t, dj);
#pragma unroll
                        for (int e = 0; e < 4; ++e) dj[e] = 0.f;
                    }
#pragma unroll
                    for (int e = 0; e < 4; ++e) aj_prev[e] = aj[e];
                }
            }
        }
        if (V != TURBOP && V != TMM_NOJ && V != TMM_NOMM)
            store_part(sm, w, k0, g, t, dj);
    }
    if (V == TURBOP) {
        uint32_t at[4];
        transpose_a(aj_prev, at);
        mma_bf16(dj, at, bi[1][0], bi[1][1]);
        store_part(sm, w, SYM_TILE - 16, g, t, dj);
    }

    if (V == TMM_NOMM) {
        // Rows g and g + 8 are spread over the quad's four lanes.
#pragma unroll
        for (int rb = 0; rb < 2; ++rb)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float si_ = wi_sum[rb][h], sj_ = wj_sum[rb][h];
                si_ += __shfl_xor_sync(0xffffffffu, si_, 1);
                si_ += __shfl_xor_sync(0xffffffffu, si_, 2);
                sj_ += __shfl_xor_sync(0xffffffffu, sj_, 1);
                sj_ += __shfl_xor_sync(0xffffffffu, sj_, 2);
                if (t < 3) si_tile[3 * (r0 + 16 * rb + 8 * h) + t] = si_ + sj_;
            }
        return;
    }
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
        const float ca = tile_correction(di[rb][0], di[rb][1],
                                         component(xr[rb][0], t));
        const float cb = tile_correction(di[rb][2], di[rb][3],
                                         component(xr[rb][1], t));
        if (t < 3) {
            si_tile[3 * (r0 + 16 * rb) + t] = ca;
            si_tile[3 * (r0 + 16 * rb + 8) + t] = cb;
        }
    }
    if (V == TMM_NOJ) return;
    __syncthreads();
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int v = 0; v < SYM_WARPS; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] = __fadd_rn(s[e], sm.part[v][tid][e]);
    sj_tile[3 * tid] = __fsub_rn(s[0], __fmul_rn(own_j.x, s[3]));
    sj_tile[3 * tid + 1] = __fsub_rn(s[1], __fmul_rn(own_j.y, s[3]));
    sj_tile[3 * tid + 2] = __fsub_rn(s[2], __fmul_rn(own_j.z, s[3]));
}
