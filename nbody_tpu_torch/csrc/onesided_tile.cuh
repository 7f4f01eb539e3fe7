// The one-sided exact tile of K1 (forces_tiled.cu) and of K13's one-sided
// phases (rdma_ring.cu): R rows a lane held in registers against columns
// staged in shared memory, each column read once (by broadcast) for the
// lane's R rows.  A pair costs 13 issue slots: 3 subtracts, d2 + eps2 as
// three FMAs, 2 multiplies for the cube, the MUFU rsqrt without rsqrtf's
// subnormal fix-up (rsqrt_normal: d2^3 >= eps2^3 is normal), 1 multiply
// by the weight and 3 FMAs into the row sums; m_i m_j costs one more
// multiply.  The weight is a template parameter, so one loop serves K1
// (m_j), K13's vpu2 one-sided phases (m_i m_j, JAX's _tile_i "vpu2") and
// its vpu ones (m_j).

#pragma once

#include "sym_common.cuh"

// The weight of a pair's term: m_j (the force on the row body) or m_i m_j
// (vpu2's mass-scaled sums).
enum OneSidedWeight { W_MJ = 0, W_MIMJ = 1 };

// Adds to the row sums (ax, ay, az)[r] of the lane's R rows br[r] the terms
// of the ncols columns at cols, in column order.
template <int WEIGHT, int R>
__device__ __forceinline__ void onesided_rows(const float4* cols, int ncols,
                                              const float4 (&br)[R],
                                              float eps2, float (&ax)[R],
                                              float (&ay)[R],
                                              float (&az)[R]) {
#pragma unroll 4
    for (int k = 0; k < ncols; ++k) {
        const float4 q = cols[k];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float dx = q.x - br[r].x;
            const float dy = q.y - br[r].y;
            const float dz = q.z - br[r].z;
            const float d2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
            const float w = WEIGHT == W_MIMJ ? br[r].w * q.w : q.w;
            const float f = w * rsqrt_normal(d2 * d2 * d2);
            ax[r] = fmaf(f, dx, ax[r]);
            ay[r] = fmaf(f, dy, ay[r]);
            az[r] = fmaf(f, dz, az[r]);
        }
    }
}

// One-sided staging of a 256 x 256 tile inside SymPairSmem::part.
struct OneSidedStage {
    float4 rows[SYM_TILE];
    float4 cols[SYM_TILE];
};
static_assert(sizeof(OneSidedStage)
                  <= sizeof(float) * SYM_WARPS * SYM_TILE * 3,
              "the one-sided staging must fit in SymPairSmem::part");

// Row tile (pos_r, mass_r) against column tile (pos_c, mass_c), one-sided,
// every thread of the block calling it with i, j its own row and column
// body: returns the row sum of row threadIdx.x.  Warp w takes columns 32w
// .. 32w+31 against all SYM_TILE rows, SYM_ROWS rows a lane (sym_pair_core's
// geometry without the column side); the eight warps' row partials meet in
// `part` and are added in warp order, so the tile is bit-reproducible.
// Shared memory may be reused once it returns.
template <int WEIGHT>
__device__ __forceinline__ float3 onesided_pair_rows(
        const float* pos_r, const float* __restrict__ mass_r, long long i,
        long long n_r, const float* pos_c, const float* __restrict__ mass_c,
        long long j, long long n_c, float eps2, SymPairSmem& sm) {
    const int t = threadIdx.x;
    const int w = t >> 5;
    const int l = t & 31;
    OneSidedStage& st = *reinterpret_cast<OneSidedStage*>(sm.part);

    __syncthreads();                      // the last tile's readers of part
    st.rows[t] = load_body(pos_r, mass_r, i, n_r);
    st.cols[t] = load_body(pos_c, mass_c, j, n_c);
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
    onesided_rows<WEIGHT, SYM_ROWS>(st.cols + 32 * w, 32, br, eps2, ax, ay,
                                    az);
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
    return make_float3(sx, sy, sz);
}
