// Device code shared by K2 and K7 (forces_sym.cu) and the resident kernels
// K3/K4 (resident.cu): the pair-symmetric tile of one (row tile, offset)
// work item with K2's or K7's math, the fixed-order slot sum, and the
// one-sided diagonal tile with the 1/m descale; K2-rect's classic vpu2 and
// vpu sweeps and K13 (rdma_ring.cu) run the pair tile's core,
// sym_pair_core, with slots of their own.  forces_sym.cu's header states the
// enumeration, the slot layout, the determinism contract and the pair
// tile's design (eight rows a lane in registers, one column accumulator
// rotating around the warp) with its numbers on the card.  K2 and K3/K4
// compile these functions from the same source, so a resident step
// computes bit for bit the force evaluation that K2 computes.
//
// Positions and slots are read through plain (not __restrict__) pointers:
// inside one resident launch other blocks write them between grid syncs,
// and the read-only data path that a const __restrict__ pointer allows is
// not coherent with those writes.  Masses are never written.

#pragma once

#include <cuda_runtime.h>

#define SYM_TILE 256
#define SYM_WARPS (SYM_TILE / 32)

__device__ __forceinline__ float4 load_body(const float* pos,
                                            const float* __restrict__ mass,
                                            long long b, long long n) {
    return (b < n) ? make_float4(pos[3 * b], pos[3 * b + 1], pos[3 * b + 2],
                                 mass[b])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Shared memory of one pair tile (28 KB).  sym_tile_core (sym_tile.cuh,
// K13's two-sided vpu phase) stages the column tile in `tile` and keeps a
// warp's column partials in `part`; sym_pair_core and K13's one-sided tile
// (onesided_pair_rows, onesided_tile.cuh) use `part` alone (their staging
// over it, then the row partials).
struct SymPairSmem {
    float4 tile[SYM_TILE];
    float part[SYM_WARPS][SYM_TILE * 3];
};

// Rows a lane of K2's pair tile holds in registers: every warp holds all
// SYM_TILE rows of the tile.
#define SYM_ROWS (SYM_TILE / 32)

// sym_pair_core's staging inside SymPairSmem::part: the row tile, and each
// warp's 32 columns written twice over, so that lane l reads column
// (l + k) mod 32 at an offset that is l plus a constant.
struct SymK2Stage {
    float4 rows[SYM_TILE];
    float4 cols[SYM_WARPS][64];
};
static_assert(sizeof(SymK2Stage) <= sizeof(float) * SYM_WARPS * SYM_TILE * 3,
              "K2's staging must fit in SymPairSmem::part");

// The pair math of the exact tiles: K2's shared weight, K7's one-sided
// weights, and K15's ablations of K7 (nbody_tpu/ops/ablation_sym.py), all
// on sym_pair_core and each timed against K7, its control:
//   VPU_NOJ   K7's row side alone: fi = m_j inv and the three row FMAs; no
//             fj, column accumulator, shuffles or column slot (the j half
//             of every pair is dropped): K7's row slots bit for bit;
//   VPU_FIX0  K7, its column sums stored in the writer's own row slot (the
//             reduce adds them all into tile 0's bodies);
//   VPU_RC    K7 with the differences recomputed per component for the six
//             accumulating FMAs (JAX's liveness ablation,
//             _accum_both_vpu_rc): K7's bits.
// K13's two-sided vpu phase runs K7's math on sym_tile_core (sym_tile.cuh).
enum SymMath { SYM_K2 = 0, SYM_K7 = 1, VPU_NOJ = 2, VPU_FIX0 = 3,
               VPU_RC = 4 };

// rsqrt(x) on the MUFU without rsqrtf's fix-up for a subnormal x (a
// compare and two predicated multiplies a call): for x = d2^3 with d2 >=
// eps2, x is normal for every eps2 above ~1e-12, and the two give the same
// bits.
__device__ __forceinline__ float rsqrt_normal(float x) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// The pair work of one tile, with K2's math (M = SYM_K2: F = m_i m_j inv
// on both sides) or K7's (M = SYM_K7 and VPU_FIX0: fi = m_j inv on the
// rows, fj = m_i inv on the column; VPU_RC: the same, the differences
// taken again after the rsqrt; VPU_NOJ: the rows only): row body i of
// (pos_r, mass_r) and column body j of (pos_c, mass_c), each thread t
// staging row t and column t of the tile.
// Returns in rs the sum of row t and in cs the (positive) sum of column t
// (zero for VPU_NOJ).
// Every thread of the block calls it; shared memory may be reused once it
// returns.
//
// Warp w takes columns 32w .. 32w+31 against all SYM_TILE rows; lane l
// holds rows l + 32r (r < SYM_ROWS) in registers.  At step k lane l pairs
// its SYM_ROWS rows with column (l + k) mod 32 of the warp's range, adds
// the row term to its rows' sums and the column term to one column
// accumulator, and then takes the column accumulator of lane l + 1: after
// 32 steps lane l holds the whole column 32w + l.  That is one shared load
// and three shuffles for every SYM_ROWS pairs, and the terms go into both
// sums as fused multiply-adds.  Both maths take 17 issue slots a pair: K2
// multiplies m_i m_j and then F = (m_i m_j) inv, K7 the two weights m_j
// inv and m_i inv.  The row partials of the eight warps meet once a tile
// in `part` and are added in warp order: the tile is bit-reproducible.
// K2's instantiation is the code K3/K4 compile (resident.cu).  VPU_RC's
// recomputed differences are K7's bit for bit, three more FADDs a pair.
// VPU_NOJ runs K7's row FMAs in K7's order and adds the row partials in
// warp order, so its row sums are K7's bit for bit, at three FFMAs, a
// weight multiply and 3/8 of a shuffle fewer a pair.
template <int M = SYM_K2>
__device__ __forceinline__ void sym_pair_core(
        const float* pos_r, const float* __restrict__ mass_r, long long i,
        long long n_r, const float* pos_c, const float* __restrict__ mass_c,
        long long j, long long n_c, float eps2, SymPairSmem& sm, float3& rs,
        float3& cs) {
    const int t = threadIdx.x;
    const int w = t >> 5;
    const int l = t & 31;
    SymK2Stage& st = *reinterpret_cast<SymK2Stage*>(sm.part);

    __syncthreads();                      // the last tile's readers of part
    st.rows[t] = load_body(pos_r, mass_r, i, n_r);
    const float4 bj = load_body(pos_c, mass_c, j, n_c);
    st.cols[w][l] = bj;
    st.cols[w][l + 32] = bj;
    __syncthreads();

    float4 br[SYM_ROWS];
    float ax[SYM_ROWS], ay[SYM_ROWS], az[SYM_ROWS];
#pragma unroll
    for (int r = 0; r < SYM_ROWS; ++r) {
        br[r] = st.rows[l + 32 * r];
        ax[r] = 0.f;
        ay[r] = 0.f;
        az[r] = 0.f;
    }
    const float4* cw = st.cols[w] + l;
    const int src = (l + 1) & 31;
    float bx = 0.f, by = 0.f, bz = 0.f;
#pragma unroll 4
    for (int k = 0; k < 32; ++k) {
        const float4 q = cw[k];
#pragma unroll
        for (int r = 0; r < SYM_ROWS; ++r) {
            const float dx = q.x - br[r].x;
            const float dy = q.y - br[r].y;
            const float dz = q.z - br[r].z;
            const float d2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
            if (M == SYM_K2) {
                const float f = (br[r].w * q.w) * rsqrt_normal(d2 * d2 * d2);
                ax[r] = fmaf(f, dx, ax[r]);
                ay[r] = fmaf(f, dy, ay[r]);
                az[r] = fmaf(f, dz, az[r]);
                bx = fmaf(f, dx, bx);
                by = fmaf(f, dy, by);
                bz = fmaf(f, dz, bz);
            } else if constexpr (M == VPU_RC) {
                // dx, dy, dz die at d2; the accumulate takes them anew
                // (__fsub_rn: ptxas keeps the three FADDs a pair, which
                // chip_smoke.py checks in the SASS).
                const float inv = rsqrt_normal(d2 * d2 * d2);
                const float fi = q.w * inv;
                const float fj = br[r].w * inv;
                const float rx = __fsub_rn(q.x, br[r].x);
                const float ry = __fsub_rn(q.y, br[r].y);
                const float rz = __fsub_rn(q.z, br[r].z);
                ax[r] = fmaf(fi, rx, ax[r]);
                ay[r] = fmaf(fi, ry, ay[r]);
                az[r] = fmaf(fi, rz, az[r]);
                bx = fmaf(fj, rx, bx);
                by = fmaf(fj, ry, by);
                bz = fmaf(fj, rz, bz);
            } else if constexpr (M == VPU_NOJ) {
                const float inv = rsqrt_normal(d2 * d2 * d2);
                const float fi = q.w * inv;
                ax[r] = fmaf(fi, dx, ax[r]);
                ay[r] = fmaf(fi, dy, ay[r]);
                az[r] = fmaf(fi, dz, az[r]);
            } else {
                const float inv = rsqrt_normal(d2 * d2 * d2);
                const float fi = q.w * inv;
                const float fj = br[r].w * inv;
                ax[r] = fmaf(fi, dx, ax[r]);
                ay[r] = fmaf(fi, dy, ay[r]);
                az[r] = fmaf(fi, dz, az[r]);
                bx = fmaf(fj, dx, bx);
                by = fmaf(fj, dy, by);
                bz = fmaf(fj, dz, bz);
            }
        }
        if constexpr (M != VPU_NOJ) {
            bx = __shfl_sync(0xffffffffu, bx, src);
            by = __shfl_sync(0xffffffffu, by, src);
            bz = __shfl_sync(0xffffffffu, bz, src);
        }
    }
    __syncthreads();                      // every warp is done with st
#pragma unroll
    for (int r = 0; r < SYM_ROWS; ++r) {
        const int row = l + 32 * r;
        sm.part[w][3 * row] = ax[r];
        sm.part[w][3 * row + 1] = ay[r];
        sm.part[w][3 * row + 2] = az[r];
    }
    __syncthreads();
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int v = 0; v < SYM_WARPS; ++v) {
        sx += sm.part[v][3 * t];
        sy += sm.part[v][3 * t + 1];
        sz += sm.part[v][3 * t + 2];
    }
    rs = make_float3(sx, sy, sz);
    cs = make_float3(bx, by, bz);
}

// Row tile I against column tile J = (I + d) mod nb of the triangular
// sweep (sym_pair_core with M's math); every thread of the block calls it.
// The row sums go to slot si[dk][I], the negated column sums to slot
// sj[dk][J], or for VPU_FIX0 to the writer's own slot sj[dk][I] (J -> I is
// a bijection for one offset, so every slot keeps one writer); VPU_NOJ
// writes no column slot.  Shared memory may be reused once it returns.
template <int M = SYM_K2>
__device__ __forceinline__ void sym_pair_tile(
        const float* pos, const float* __restrict__ mass,
        long long n, long long nb, long long I, long long d, long long dk,
        float eps2, float* __restrict__ si, float* __restrict__ sj,
        SymPairSmem& sm) {
    const long long J = (I + d) % nb;
    const int t = threadIdx.x;
    const long long i = I * SYM_TILE + t;
    const long long j = J * SYM_TILE + t;
    float3 rs, cs;
    sym_pair_core<M>(pos, mass, i, n, pos, mass, j, n, eps2, sm, rs, cs);
    const long long slot = dk * nb * SYM_TILE * 3;
    si[slot + 3 * i] = rs.x;
    si[slot + 3 * i + 1] = rs.y;
    si[slot + 3 * i + 2] = rs.z;
    if constexpr (M == VPU_NOJ) return;
    const long long jt = (M == VPU_FIX0) ? i : j;
    sj[slot + 3 * jt] = -cs.x;
    sj[slot + 3 * jt + 1] = -cs.y;
    sj[slot + 3 * jt + 2] = -cs.z;
}

// Adds body b's slots of the offsets d_lo .. d_lo+dc-1 (row tile I) to s,
// offset by offset, i-side before j-side.
__device__ __forceinline__ float3 sym_slot_sum(
        float3 s, long long nb, long long I, long long b, long long d_lo,
        long long dc, const float* si, const float* sj) {
    const long long n_pad = nb * SYM_TILE;
    for (long long dk = 0; dk < dc; ++dk) {
        const bool half = 2 * (d_lo + dk) == nb;
        const long long o = (dk * n_pad + b) * 3;
        if (!half || 2 * I < nb) {
            s.x += si[o];
            s.y += si[o + 1];
            s.z += si[o + 2];
        }
        if (!half || 2 * I >= nb) {
            s.x += sj[o];
            s.y += sj[o + 1];
            s.z += sj[o + 2];
        }
    }
    return s;
}

// Body b's one-sided diagonal-tile sum (m_j weights), or, for a real body
// of mass 0 (whose mass-scaled slot sums are all 0), its whole row swept
// one-sided over every body.  Every thread of the block calls it (it
// stages the block's tile in `tile`); the result is meaningful for b < n
// only.  The caller syncs before reusing `tile`.
__device__ __forceinline__ float3 sym_diag(
        const float* pos, const float* __restrict__ mass,
        long long n, long long b, float eps2, float4* tile) {
    const int t = threadIdx.x;
    tile[t] = load_body(pos, mass, b, n);
    __syncthreads();
    float ax = 0.f, ay = 0.f, az = 0.f;
    if (b >= n) return make_float3(ax, ay, az);
    const float4 bi = tile[t];
    if (bi.w != 0.f) {
#pragma unroll 8
        for (int k = 0; k < SYM_TILE; ++k) {
            const float4 q = tile[k];
            const float dx = q.x - bi.x;
            const float dy = q.y - bi.y;
            const float dz = q.z - bi.z;
            const float d2 = dx * dx + dy * dy + dz * dz + eps2;
            const float f = q.w * rsqrtf(d2 * d2 * d2);
            ax += f * dx;
            ay += f * dy;
            az += f * dz;
        }
    } else {
        for (long long jj = 0; jj < n; ++jj) {
            const float dx = pos[3 * jj] - bi.x;
            const float dy = pos[3 * jj + 1] - bi.y;
            const float dz = pos[3 * jj + 2] - bi.z;
            const float d2 = dx * dx + dy * dy + dz * dz + eps2;
            const float f = mass[jj] * rsqrtf(d2 * d2 * d2);
            ax += f * dx;
            ay += f * dy;
            az += f * dz;
        }
    }
    return make_float3(ax, ay, az);
}

// Body b's one-sided diagonal-tile sum (m_j weights) for every body, mass 0
// included: the diagonal of the tensor-core tiers K5/K6 (forces_sym_tc.cu),
// whose slot sums carry m_j, not m_i, and so are complete for a massless
// body without a one-sided recompute.  Every thread of the block calls it;
// the result is meaningful for b < n only.  The caller syncs before
// reusing `tile`.
__device__ __forceinline__ float3 sym_diag_tile(
        const float* pos, const float* __restrict__ mass,
        long long n, long long b, float eps2, float4* tile) {
    const int t = threadIdx.x;
    tile[t] = load_body(pos, mass, b, n);
    __syncthreads();
    const float4 bi = tile[t];
    float ax = 0.f, ay = 0.f, az = 0.f;
#pragma unroll 8
    for (int k = 0; k < SYM_TILE; ++k) {
        const float4 q = tile[k];
        const float dx = q.x - bi.x;
        const float dy = q.y - bi.y;
        const float dz = q.z - bi.z;
        const float d2 = dx * dx + dy * dy + dz * dz + eps2;
        const float f = q.w * rsqrtf(d2 * d2 * d2);
        ax += f * dx;
        ay += f * dy;
        az += f * dz;
    }
    return make_float3(ax, ay, az);
}

// The acceleration of a body of mass m from its diagonal sum `diag` and
// its summed slots s: diag + s / m, or diag alone (its whole row) at m = 0.
__device__ __forceinline__ float3 sym_descale(float3 diag, float3 s,
                                              float m) {
    if (m == 0.f) return diag;
    const float inv_m = 1.0f / m;
    float ax = diag.x, ay = diag.y, az = diag.z;
    ax += s.x * inv_m;
    ay += s.y * inv_m;
    az += s.z * inv_m;
    return make_float3(ax, ay, az);
}
