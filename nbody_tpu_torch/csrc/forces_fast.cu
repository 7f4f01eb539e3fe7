// K12: one-sided all-pairs forces with the distances AND the accumulation
// on Hopper's tensor cores (sm_90a), the "fast" tier.
//
// Replaces nbody_tpu/ops/forces_pallas.py:_force_kernel_fast (split_f=True,
// the variant "fast" that _forces_pallas_padded drives through
// forces_pallas and rect_forces_pallas).
//
// For every body i of the i-set, j-tile by j-tile (FAST_TILE_J bodies):
//   c      = the tile's centroid (sum / FAST_TILE_J; the zero-mass ghosts
//            that pad the last tile sit at the origin and count, as the
//            JAX package's mean counts them)
//   u, v   = x_i - c, x_j - c;  |u|^2, |v|^2 in float32
//   cross  = u18 . v18, one bf16 product with float32 accumulation of the
//            K=18 packs  u18 = [uh um ul uh uh um],  v18 = [vh vh vh vm vl
//            vm]  (3-limb bf16 splits; the six limb products keep ~24 bits
//            of u . v), K padded to 32: two m16n8k16 steps, the second with
//            2 live columns
//   d2     = ((|u|^2 + eps2) - (cross + cross)) + |v|^2, or, where that is
//            below CLOSE_PAIR_SCALE (|u|^2 + eps2 + |v|^2), the direct
//            |x_j - x_i|^2 + eps2; then clamped at eps2
//   f      = m_j rsqrt(d2^3), 0 for the self-pair when masking
//   acc_i += (f_hi + f_lo) @ [x_hi x_lo y_hi y_lo z_hi z_lo 1 0], then the
//            correction  sum f x_j - x_i sum f  once per tile (K10's
//            accumulation, tc_common.cuh)
// The centred expansion cancels: its float32 error is about 2^-21 (|u|^2 +
// |v|^2), which grows with the tile's extent, so the tier wants
// Morton-sorted bodies (models/ordering.py).  A pair closer than that
// error would come out at the eps2 clamp in the JAX kernel, its force up
// to ~1e7 times too large, and every run from the uniform box then blows
// up within tens of steps (ROADMAP Queue 3).  Here such a pair (centred
// d2 below 2^-11 of the scale, where the centred value has lost ~10 bits)
// takes the direct difference instead, in a branch that a warp takes only
// when one of its pairs is that close, which is rare: the fault is not
// copied.  The plain version (ops/forces_fast.py) does the same on the
// same tiles, and the JAX package is compared at block_j = FAST_TILE_J.
//
// Design.  A block of FAST_WARPS warps owns 16 i-rows a warp; one thread a
// j slot stages the tile: the float4 body, the transposed position pack
// (the accumulate product's B), the v18 pack row (the cross product's B)
// and |v|^2.  The centroid is summed in a fixed order (a butterfly within
// each warp, then the warps' sums in order), so runs are bit-reproducible.
// Each warp's u18 rows go through shared memory once a tile and stay in
// registers as the cross product's A fragments.  For each 16 x 16 block of
// pairs the warp runs the cross product for two adjacent 8-column halves;
// the float32 accumulator fragments of those two halves hold exactly the
// pairs of a k16 A fragment (rows g, g+8 x columns 2t, 2t+1 and 2t+8,
// 2t+9), so f is formed, split and fed to the accumulate product from
// registers, with no shared-memory round trip.
//
// What bounds it on the card: float32 issue.  A pair costs about 12
// float32 operations (3 for d2, 3 for the close-pair test, the clamp, 2 for
// the cube, 1 rsqrt on the MUFU, 1 multiply by m_j, 1 for the split) plus
// the bf16 conversions and the self-pair test, against 68 tensor-core
// flops (36 for the K=18 cross product, 32 for the two accumulate
// products; the padding to K=32 issues 64 + 32).  Left for later: wgmma,
// several rows a lane, splitting j across warps at small N.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include "tc_common.cuh"

#define FAST_TILE_J 128
#define FAST_WARPS 4
#define FAST_THREADS (32 * FAST_WARPS)
#define FAST_ROWS (16 * FAST_WARPS)
#define FAST_LD (FAST_TILE_J + TC_PAD)
// The close-pair test: centred d2 below this fraction of |u|^2 + eps2 +
// |v|^2 takes the direct d2 (CLOSE_PAIR_SCALE in ops/forces_fast.py).
#define CLOSE_PAIR_SCALE 0x1p-11f
// Row pitch (bf16) of the u18 / v18 packs: 32 columns (18 live) and a pad
// that puts the 32 lanes of a fragment load on 32 different banks.
#define PACK18_LD 40

static_assert(FAST_THREADS == FAST_TILE_J, "one staging thread per j slot");
static_assert(FAST_ROWS <= FAST_THREADS, "one thread per i row for u18");

struct FastSmem {
    float4 tile[FAST_TILE_J];                       // x, y, z, m
    float vn2[FAST_TILE_J];                         // |v|^2
    float un2[FAST_ROWS];                           // |u|^2 + eps2
    float csum[FAST_WARPS][3];                      // the warps' sums
    __nv_bfloat16 packT[8 * FAST_LD];               // position pack, (8, T)
    __nv_bfloat16 v18[FAST_TILE_J * PACK18_LD];     // v18 pack, a row a body
    __nv_bfloat16 u18[FAST_ROWS * PACK18_LD];       // u18 pack, a row a body
};

// The 3-limb bf16 split: hi + mid + lo reproduces x to ~24 bits.
__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
    hi = __float2bfloat16_rn(x);
    const float r1 = __fsub_rn(x, __bfloat162float(hi));
    mid = __float2bfloat16_rn(r1);
    lo = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
}

// Writes one body's K=18 pack into row `row` (32 columns, zero from 18):
// the limb order is (a0 a1 a2 a3 a4 a5) of each component, with
// u18: (h m l h h m) and v18: (h h h m l m) as _pack_u18 / _pack_v18.
template <bool U>
__device__ __forceinline__ void pack18(__nv_bfloat16* row, float3 w) {
    const float c[3] = {w.x, w.y, w.z};
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int e = 0; e < 3; ++e) {
        __nv_bfloat16 h, m, l;
        split3(c[e], h, m, l);
        if (U) {
            row[e] = h; row[3 + e] = m; row[6 + e] = l;
            row[9 + e] = h; row[12 + e] = h; row[15 + e] = m;
        } else {
            row[e] = h; row[3 + e] = h; row[6 + e] = h;
            row[9 + e] = m; row[12 + e] = l; row[15 + e] = m;
        }
    }
#pragma unroll
    for (int k = 18; k < 32; ++k) row[k] = zero;
}

// |w|^2 in the plain version's order.
__device__ __forceinline__ float norm2(float3 w) {
    return __fadd_rn(__fadd_rn(__fmul_rn(w.x, w.x), __fmul_rn(w.y, w.y)),
                     __fmul_rn(w.z, w.z));
}

__device__ __forceinline__ float4 load_row(const float* __restrict__ pos,
                                           long long i, long long n) {
    return (i < n) ? make_float4(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2],
                                 0.f)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Whether a centred d2 is below the close-pair test.
__device__ __forceinline__ bool is_close(float d2, float un2e, float vn2) {
    return d2 < __fmul_rn(__fadd_rn(un2e, vn2), CLOSE_PAIR_SCALE);
}

// The centred d2 of a pair from the cross product; `close` gathers the
// pairs below the test.
__device__ __forceinline__ float centred_d2(float cross, float un2e,
                                            float vn2, bool& close) {
    const float d2 = __fadd_rn(__fsub_rn(un2e, __fadd_rn(cross, cross)),
                               vn2);
    close |= is_close(d2, un2e, vn2);
    return d2;
}

// d2, or the direct |x_j - x_i|^2 + eps2 where d2 is below the test.
__device__ __forceinline__ float close_d2(float d2, float un2e, float vn2,
                                          float4 xi, float4 q, float eps2) {
    if (!is_close(d2, un2e, vn2)) return d2;
    const float dx = __fsub_rn(q.x, xi.x);
    const float dy = __fsub_rn(q.y, xi.y);
    const float dz = __fsub_rn(q.z, xi.z);
    return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                         __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz)), eps2);
}

// f = m rsqrt(d2^3) with d2 clamped at eps2; 0 for a masked pair.
__device__ __forceinline__ float weight(float d2, float m, float eps2,
                                        bool masked) {
    d2 = fmaxf(d2, eps2);
    const float f = __fmul_rn(m, rsqrtf(__fmul_rn(__fmul_rn(d2, d2), d2)));
    return masked ? 0.f : f;
}

__global__ void __launch_bounds__(FAST_THREADS)
forces_fast_kernel(const float* __restrict__ pos_i, long long ni,
                   const float* __restrict__ pos_j,
                   const float* __restrict__ mass_j, long long nj,
                   float eps2, int mask_self, float* __restrict__ acc) {
    __shared__ __align__(16) FastSmem sm;
    const int tid = threadIdx.x;
    const int w = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const long long row0 = (long long)blockIdx.x * FAST_ROWS;
    const long long ia = row0 + 16 * w + g;
    const long long ib = ia + 8;
    const float4 xa = load_row(pos_i, ia, ni);
    const float4 xb = load_row(pos_i, ib, ni);
    // The row this thread packs as u18 (threads tid < FAST_ROWS).
    const float4 xu = load_row(pos_i, row0 + tid, ni);
    const bool mask = mask_self != 0;
    float acc_a = 0.f, acc_b = 0.f;

    for (long long j0 = 0; j0 < nj; j0 += FAST_TILE_J) {
        const long long j = j0 + tid;
        const float4 q = (j < nj)
            ? make_float4(pos_j[3 * j], pos_j[3 * j + 1], pos_j[3 * j + 2],
                          mass_j[j])
            : make_float4(0.f, 0.f, 0.f, 0.f);
        sm.tile[tid] = q;
        pack_position(sm.packT, FAST_LD, tid, q);
        // The centroid: a butterfly within the warp (every lane ends with
        // the same sum), then the warps' sums in warp order.
        float sx = q.x, sy = q.y, sz = q.z;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            sx = __fadd_rn(sx, __shfl_xor_sync(0xffffffffu, sx, o));
            sy = __fadd_rn(sy, __shfl_xor_sync(0xffffffffu, sy, o));
            sz = __fadd_rn(sz, __shfl_xor_sync(0xffffffffu, sz, o));
        }
        if (lane == 0) {
            sm.csum[w][0] = sx;
            sm.csum[w][1] = sy;
            sm.csum[w][2] = sz;
        }
        __syncthreads();
        float cs[3] = {sm.csum[0][0], sm.csum[0][1], sm.csum[0][2]};
#pragma unroll
        for (int v = 1; v < FAST_WARPS; ++v)
#pragma unroll
            for (int e = 0; e < 3; ++e)
                cs[e] = __fadd_rn(cs[e], sm.csum[v][e]);
        const float inv_t = 1.0f / FAST_TILE_J;       // a power of two: exact
        const float3 c = make_float3(__fmul_rn(cs[0], inv_t),
                                     __fmul_rn(cs[1], inv_t),
                                     __fmul_rn(cs[2], inv_t));
        const float3 v = make_float3(__fsub_rn(q.x, c.x), __fsub_rn(q.y, c.y),
                                     __fsub_rn(q.z, c.z));
        pack18<false>(sm.v18 + tid * PACK18_LD, v);
        sm.vn2[tid] = norm2(v);
        if (tid < FAST_ROWS) {
            const float3 u = make_float3(__fsub_rn(xu.x, c.x),
                                         __fsub_rn(xu.y, c.y),
                                         __fsub_rn(xu.z, c.z));
            pack18<true>(sm.u18 + tid * PACK18_LD, u);
            sm.un2[tid] = __fadd_rn(norm2(u), eps2);
        }
        __syncthreads();

        // This warp's u18 rows as the cross product's A fragments (two k16
        // steps), and |u|^2 + eps2 of rows g and g + 8.
        uint32_t ua[2][4];
        const __nv_bfloat16* ur = sm.u18 + (16 * w + g) * PACK18_LD + 2 * t;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const __nv_bfloat16* p = ur + 16 * s;
            ua[s][0] = *reinterpret_cast<const uint32_t*>(p);
            ua[s][1] = *reinterpret_cast<const uint32_t*>(p + 8 * PACK18_LD);
            ua[s][2] = *reinterpret_cast<const uint32_t*>(p + 8);
            ua[s][3] = *reinterpret_cast<const uint32_t*>(
                p + 8 * PACK18_LD + 8);
        }
        const float una = sm.un2[16 * w + g];
        const float unb = sm.un2[16 * w + g + 8];

        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int k0 = 0; k0 < FAST_TILE_J; k0 += 16) {
            // d2 and f of rows (g, g + 8) x columns (k0 + 2t, +1) and (+8,
            // +9): the two n8 halves of the block, in A-fragment order.
            float d2[8], f[8];
            bool close = false;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int jb = k0 + 8 * h;
                float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    uint32_t b0, b1;
                    load_b(sm.v18 + jb * PACK18_LD, PACK18_LD, 16 * s, g, t,
                           b0, b1);
                    mma_bf16(x, ua[s], b0, b1);
                }
                const int c0 = jb + 2 * t;
                const float v0 = sm.vn2[c0], v1 = sm.vn2[c0 + 1];
                d2[4 * h] = centred_d2(x[0], una, v0, close);
                d2[4 * h + 1] = centred_d2(x[1], una, v1, close);
                d2[4 * h + 2] = centred_d2(x[2], unb, v0, close);
                d2[4 * h + 3] = centred_d2(x[3], unb, v1, close);
            }
            // The direct distances, in a branch the whole warp takes only
            // when one of its pairs is that close.
            if (__any_sync(0xffffffffu, close)) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int c0 = k0 + 8 * h + 2 * t;
                    const float4 q0 = sm.tile[c0], q1 = sm.tile[c0 + 1];
                    const float v0 = sm.vn2[c0], v1 = sm.vn2[c0 + 1];
                    d2[4 * h] = close_d2(d2[4 * h], una, v0, xa, q0, eps2);
                    d2[4 * h + 1] = close_d2(d2[4 * h + 1], una, v1, xa, q1,
                                             eps2);
                    d2[4 * h + 2] = close_d2(d2[4 * h + 2], unb, v0, xb, q0,
                                             eps2);
                    d2[4 * h + 3] = close_d2(d2[4 * h + 3], unb, v1, xb, q1,
                                             eps2);
                }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int c0 = k0 + 8 * h + 2 * t;
                const long long jc = j0 + c0;
                const float m0 = sm.tile[c0].w, m1 = sm.tile[c0 + 1].w;
                f[4 * h] = weight(d2[4 * h], m0, eps2, mask && ia == jc);
                f[4 * h + 1] = weight(d2[4 * h + 1], m1, eps2,
                                      mask && ia == jc + 1);
                f[4 * h + 2] = weight(d2[4 * h + 2], m0, eps2,
                                      mask && ib == jc);
                f[4 * h + 3] = weight(d2[4 * h + 3], m1, eps2,
                                      mask && ib == jc + 1);
            }
            // A fragment: a0 = (g, 2t..), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
            // a3 = (g+8, 2t+8..).
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                split_rn(f[2 * r], f[2 * r + 1], hi[r], lo[r]);
            uint32_t b0, b1;
            load_b(sm.packT, FAST_LD, k0, g, t, b0, b1);
            mma_bf16(d, hi, b0, b1);
            mma_bf16(d, lo, b0, b1);
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

extern "C" int nbt_forces_fast(const float* pos_i, long long ni,
                               const float* pos_j, const float* mass_j,
                               long long nj, float eps2, int mask_self,
                               float* acc, void* stream) {
    if (ni <= 0) return 0;
    const long long blocks = (ni + FAST_ROWS - 1) / FAST_ROWS;
    forces_fast_kernel<<<(unsigned)blocks, FAST_THREADS, 0,
                         (cudaStream_t)stream>>>(pos_i, ni, pos_j, mass_j, nj,
                                                 eps2, mask_self, acc);
    return (int)cudaGetLastError();
}

extern "C" int nbt_fast_tile(void) { return FAST_TILE_J; }
