// The one-row-a-thread exact pair tile of K13's two-sided vpu phase
// (rdma_ring.cu), its one caller: K7's math on one 256 x 256 tile.  One
// row a thread, the column tile staged once and read (l + k) mod 32 at a
// time, a column accumulator shuffled once a pair, rsqrtf with its
// subnormal fix-up.  Every other exact tile (K2, K3/K4, K7, the folds,
// K2-rect's classic vpu2 and vpu sweeps, K15's vpu_* ablations) runs
// sym_pair_core (sym_common.cuh) instead, eight rows a lane.

#pragma once

#include "sym_common.cuh"

// The pair work of one 256 x 256 tile for the row body bi of this thread,
// against the column tile staged (and synced) in sm.tile: K7's math (fi =
// m_j inv, fj = m_i inv; M = SYM_K7 only).  Adds the row sums to (ax, ay,
// az) and returns the column sum of column threadIdx.x over the tile's
// rows, a positive magnitude (the caller negates).  Every thread of the
// block calls it; the caller syncs before restaging sm.
template <int M>
__device__ __forceinline__ float3 sym_tile_core(float4 bi, float eps2,
                                                float& ax, float& ay,
                                                float& az, SymPairSmem& sm) {
    static_assert(M == SYM_K7, "sym_tile_core takes K7's math only");
    const int t = threadIdx.x;
    const int w = t >> 5;
    const int l = t & 31;
    for (int c = 0; c < SYM_TILE / 32; ++c) {
        float bx = 0.f, by = 0.f, bz = 0.f;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
            const float4 q = sm.tile[c * 32 + ((l + k) & 31)];
            const float dx = q.x - bi.x;
            const float dy = q.y - bi.y;
            const float dz = q.z - bi.z;
            const float d2 = dx * dx + dy * dy + dz * dz + eps2;
            const float inv = rsqrtf(d2 * d2 * d2);
            const float fi = q.w * inv;
            ax += fi * dx;
            ay += fi * dy;
            az += fi * dz;
            const float fj = bi.w * inv;
            bx += fj * dx;
            by += fj * dy;
            bz += fj * dz;
            const int src = (l + 1) & 31;
            bx = __shfl_sync(0xffffffffu, bx, src);
            by = __shfl_sync(0xffffffffu, by, src);
            bz = __shfl_sync(0xffffffffu, bz, src);
        }
        const int col = c * 32 + l;
        sm.part[w][3 * col] = bx;
        sm.part[w][3 * col + 1] = by;
        sm.part[w][3 * col + 2] = bz;
    }
    __syncthreads();
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int v = 0; v < SYM_WARPS; ++v) {
        sx += sm.part[v][3 * t];
        sy += sm.part[v][3 * t + 1];
        sz += sm.part[v][3 * t + 2];
    }
    return make_float3(sx, sy, sz);
}
