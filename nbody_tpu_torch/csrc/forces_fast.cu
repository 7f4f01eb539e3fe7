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
//            of u . v), K padded to 24: one m16n8k16 and one m16n8k8 step
//   d2     = ((|u|^2 + eps2) - 2 cross) + |v|^2, or, where that is below
//            tu_i + tv_j  (tu = CLOSE_PAIR_SCALE (|u|^2 + eps2),  tv =
//            CLOSE_PAIR_SCALE |v|^2, a power of two apart from the sum, so
//            the test is CLOSE_PAIR_SCALE (|u|^2 + eps2 + |v|^2) to the
//            bit), the direct |x_j - x_i|^2 + eps2; then clamped at eps2
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
// Design.  Two launches an evaluation, three where the j range is split.
//   1. fast_prologue_kernel, one block a j tile: everything that depends
//      on the tile alone, once per evaluation, into device scratch (a
//      FastJTile, 9744 bytes, ~76 bytes a body): the centroid (summed in a
//      fixed order: a butterfly within each warp, then the warps' sums in
//      order), the v18 pack (body-major, 24 columns), the position pack
//      (body-major), (|v|^2, tv) and m_j.
//   2. fast_forces_kernel, a block of FAST_WARPS warps over FAST_ROWS
//      i-rows (FAST_MT m16 tiles, 32 rows, a warp) and one range of j
//      tiles.  Thread 0 streams the tiles into a double-buffered ring in
//      shared memory with one bulk copy (cp.async.bulk) each, completed on
//      a "full" mbarrier; each warp waits once for a tile, and releases
//      it on an "empty" mbarrier, on which thread 0 waits before it
//      refills the buffer.  Per tile a warp stages its 32 rows' u18 packs
//      (one row a lane) and reads them back as A fragments (ldmatrix);
//      per 16 columns it loads the B fragments once (ldmatrix: the cross
//      product's k16 and k8 steps for both n8 halves, the position pack
//      transposed) and uses them for its FAST_MT m16 tiles.  The float32
//      accumulator fragments of two adjacent n8 halves hold exactly the
//      pairs of a k16 A fragment, so f is formed, split (one cvt.bf16x2
//      for two hi limbs, one for two lo) and fed to the accumulate product
//      from registers.  The self-pair mask runs only on the tile that
//      holds a warp's diagonal (a templated tile loop).
//   3. At small N the j range is split across blocks (gridDim.y), each
//      split's partial sums go to scratch, and fast_combine_kernel adds
//      them in split order.  Which splits is a function of the shapes
//      alone (ops/forces_fast.py::j_splits), so every run and the plain
//      version sum alike: the result is bit-reproducible.
//
// What bounds it on the card: float32 issue and the latency of each
// pair's chain.  A pair costs about 12 float32 issue slots: 2 for d2 (an
// FMA for |u|^2 + eps2 - 2 cross, an add), 2 for the close-pair test (an
// add and a compare), the clamp, 2 for the cube, 1 rsqrt on the MUFU
// (without rsqrtf's subnormal fix-up: d2^3 >= eps2^3 is normal), 1
// multiply by m_j, 3 for the hi/lo split; with the warp's share of the
// mma, the shared loads, the vote and the u18 staging the compiled loop
// is about 15.  The tensor cores do 68 flops a pair (36 for the K=18
// cross product, 32 for the two accumulate products), far under their
// rate.  On an H100 80GB HBM3 at 700 W an evaluation of 1,048,576
// Morton-sorted bodies takes 762.4 ms and one of 8192 0.0623 ms: about
// two thirds of the issue rate at the 1980 MHz boost clock, the rest the
// chain of each pair (two mma.sync, the compare and vote, the MUFU, the
// split, two accumulate mma) at 16 warps an SM (109 registers, two
// blocks).
//
// Left for later: a loop that issues the next 16 columns' cross product
// before this one's weights, the close-pair branch out of line (its
// unrolled code doubles the loop's size), wgmma.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include "tc_common.cuh"

#define FAST_TILE_J 128
#define FAST_WARPS 8
#define FAST_THREADS (32 * FAST_WARPS)
#define FAST_MT 2
#define FAST_WARP_ROWS (16 * FAST_MT)
#define FAST_ROWS (FAST_WARP_ROWS * FAST_WARPS)
// The close-pair test: centred d2 below this fraction of |u|^2 + eps2 +
// |v|^2 takes the direct d2 (CLOSE_PAIR_SCALE in ops/forces_fast.py).
#define CLOSE_PAIR_SCALE 0x1p-11f
// Columns of the K=18 packs: 18 live, padded to a k16 and a k8 step.
#define PACK_K 24
// Row pitch (bf16) of a warp's u18 staging: the pack, (|u|^2 + eps2, tu)
// as two floats at column 24, and a pad that puts the rows of an ldmatrix
// on different banks.
#define U_LD 40

static_assert(FAST_WARP_ROWS == 32, "one staging lane per row of a warp");

// One j tile as the prologue writes it and the force kernel copies it.
struct __align__(16) FastJTile {
    __nv_bfloat16 v18[FAST_TILE_J * PACK_K];   // v18 packs, a row a body
    __nv_bfloat16 pack[FAST_TILE_J * 8];       // position packs, a row a body
    float2 vt[FAST_TILE_J];                    // (|v|^2, tv)
    float m[FAST_TILE_J];
    float4 c;                                  // the centroid, w = 0
};
static_assert(sizeof(FastJTile) % 16 == 0, "bulk copies move 16-byte units");

// The 3-limb bf16 split: hi + mid + lo reproduces x to ~24 bits.
__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
    hi = __float2bfloat16_rn(x);
    const float r1 = __fsub_rn(x, __bfloat162float(hi));
    mid = __float2bfloat16_rn(r1);
    lo = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
}

// Writes one body's K=18 pack into row[0 .. PACK_K) (zero from 18): the
// limb order is (a0 a1 a2 a3 a4 a5) of each component, with
// u18: (h m l h h m) and v18: (h h h m l m) as _pack_u18 / _pack_v18.
template <bool U>
__device__ __forceinline__ void pack18(__nv_bfloat16* row, float3 w) {
    const float c[3] = {w.x, w.y, w.z};
    __nv_bfloat16 k[PACK_K];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
        __nv_bfloat16 h, m, l;
        split3(c[e], h, m, l);
        if (U) {
            k[e] = h; k[3 + e] = m; k[6 + e] = l;
            k[9 + e] = h; k[12 + e] = h; k[15 + e] = m;
        } else {
            k[e] = h; k[3 + e] = h; k[6 + e] = h;
            k[9 + e] = m; k[12 + e] = l; k[15 + e] = m;
        }
    }
#pragma unroll
    for (int e = 18; e < PACK_K; ++e) k[e] = __float2bfloat16_rn(0.f);
    uint4* dst = reinterpret_cast<uint4*>(row);
#pragma unroll
    for (int q = 0; q < PACK_K / 8; ++q)
        dst[q] = make_uint4(bf16x2(k[8 * q], k[8 * q + 1]),
                            bf16x2(k[8 * q + 2], k[8 * q + 3]),
                            bf16x2(k[8 * q + 4], k[8 * q + 5]),
                            bf16x2(k[8 * q + 6], k[8 * q + 7]));
}

// |w|^2 in the plain version's order.
__device__ __forceinline__ float norm2(float3 w) {
    return __fadd_rn(__fadd_rn(__fmul_rn(w.x, w.x), __fmul_rn(w.y, w.y)),
                     __fmul_rn(w.z, w.z));
}

__device__ __forceinline__ float3 load_pos(const float* __restrict__ pos,
                                           long long i, long long n) {
    return (i < n) ? make_float3(pos[3 * i], pos[3 * i + 1], pos[3 * i + 2])
                   : make_float3(0.f, 0.f, 0.f);
}

// The direct |x_j - x_i|^2 + eps2 of rows i and column j, read from global
// memory (the close-pair branch is rare).
__device__ __forceinline__ float direct_d2(const float* __restrict__ pos_i,
                                           long long i, long long ni,
                                           const float* __restrict__ pos_j,
                                           long long j, long long nj,
                                           float eps2) {
    const float3 a = load_pos(pos_i, i, ni);
    const float3 b = load_pos(pos_j, j, nj);
    const float dx = __fsub_rn(b.x, a.x);
    const float dy = __fsub_rn(b.y, a.y);
    const float dz = __fsub_rn(b.z, a.z);
    return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                         __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz)), eps2);
}

// rsqrt(x) on the MUFU without rsqrtf's fix-up for a subnormal x (a
// compare and two predicated multiplies a call): for x = d2^3 with d2 >=
// eps2, x is normal for every eps2 above ~1e-12, and the two give the same
// bits.
__device__ __forceinline__ float rsqrt_normal(float x) {
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// f = m rsqrt(d2^3) with d2 clamped at eps2.
__device__ __forceinline__ float weight(float d2, float m, float eps2) {
    d2 = fmaxf(d2, eps2);
    return __fmul_rn(m, rsqrt_normal(__fmul_rn(__fmul_rn(d2, d2), d2)));
}

// Hi and lo bf16 limbs of two weights as two bf16x2 registers (a in the
// low half), each rounded to nearest even: split_rn's values.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    const float ra = __fsub_rn(a, __uint_as_float(hi << 16));
    const float rb = __fsub_rn(b, __uint_as_float(hi & 0xffff0000u));
    const __nv_bfloat162 l = __floats2bfloat162_rn(ra, rb);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
        : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              uint32_t addr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}

// d += a x b for a 16x8 A (rows g, g+8 x columns 2t, 2t+1) and an 8x8 B.
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[2],
                                       uint32_t b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@p bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// One bulk copy of a FastJTile into shared memory, completed on `bar`.
__device__ __forceinline__ void load_tile(FastJTile* dst,
                                          const FastJTile* src,
                                          uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"((uint32_t)sizeof(FastJTile))
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"((uint32_t)sizeof(FastJTile)),
           "r"(smem_u32(bar)) : "memory");
}

// Everything of a j tile that depends on the tile alone.
__global__ void __launch_bounds__(FAST_TILE_J)
fast_prologue_kernel(const float* __restrict__ pos_j,
                     const float* __restrict__ mass_j, long long nj,
                     FastJTile* __restrict__ tiles) {
    __shared__ float csum[FAST_TILE_J / 32][3];
    const int tid = threadIdx.x;
    const int w = tid >> 5;
    const int lane = tid & 31;
    const long long j = (long long)blockIdx.x * FAST_TILE_J + tid;
    const float3 q = load_pos(pos_j, j, nj);
    const float m = (j < nj) ? mass_j[j] : 0.f;
    // The centroid: a butterfly within the warp (every lane ends with the
    // same sum), then the warps' sums in warp order.
    float sx = q.x, sy = q.y, sz = q.z;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        sx = __fadd_rn(sx, __shfl_xor_sync(0xffffffffu, sx, o));
        sy = __fadd_rn(sy, __shfl_xor_sync(0xffffffffu, sy, o));
        sz = __fadd_rn(sz, __shfl_xor_sync(0xffffffffu, sz, o));
    }
    if (lane == 0) {
        csum[w][0] = sx;
        csum[w][1] = sy;
        csum[w][2] = sz;
    }
    __syncthreads();
    float cs[3] = {csum[0][0], csum[0][1], csum[0][2]};
#pragma unroll
    for (int v = 1; v < FAST_TILE_J / 32; ++v)
#pragma unroll
        for (int e = 0; e < 3; ++e) cs[e] = __fadd_rn(cs[e], csum[v][e]);
    const float inv_t = 1.0f / FAST_TILE_J;           // a power of two: exact
    const float3 c = make_float3(__fmul_rn(cs[0], inv_t),
                                 __fmul_rn(cs[1], inv_t),
                                 __fmul_rn(cs[2], inv_t));
    const float3 v = make_float3(__fsub_rn(q.x, c.x), __fsub_rn(q.y, c.y),
                                 __fsub_rn(q.z, c.z));
    FastJTile& T = tiles[blockIdx.x];
    pack18<false>(T.v18 + tid * PACK_K, v);
    const float p[3] = {q.x, q.y, q.z};
    uint32_t k[4];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
        __nv_bfloat16 hi, lo;
        split_bf16(p[e], hi, lo);
        k[e] = bf16x2(hi, lo);
    }
    k[3] = bf16x2(__float2bfloat16_rn(1.f), __float2bfloat16_rn(0.f));
    *reinterpret_cast<uint4*>(T.pack + tid * 8) =
        make_uint4(k[0], k[1], k[2], k[3]);
    const float vn2 = norm2(v);
    T.vt[tid] = make_float2(vn2, __fmul_rn(vn2, CLOSE_PAIR_SCALE));
    T.m[tid] = m;
    if (tid == 0) T.c = make_float4(c.x, c.y, c.z, 0.f);
}

// One j tile against a warp's FAST_MT m16 row tiles: the cross product,
// d2, the close-pair branch, f and the accumulate products into d.  With
// MASK the pair whose warp row (16 m + g or + 8) equals diag + its tile
// column is the self-pair and weighs 0.
template <bool MASK>
__device__ __forceinline__ void fast_tile(
        const FastJTile& T, const uint32_t (&ua16)[FAST_MT][4],
        const uint32_t (&ua8)[FAST_MT][2], const float (&un)[FAST_MT][2],
        const float (&tu)[FAST_MT][2], int diag,
        const float* __restrict__ pos_i, long long ni, long long rw,
        const float* __restrict__ pos_j, long long nj, long long j0,
        float eps2, float (&d)[FAST_MT][4]) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // ldmatrix row addresses: the cross product's B (k 0-15 of columns
    // 0-7 and 8-15; k 16-23 of both) and the position pack's rows.
    const uint32_t v18 = smem_u32(T.v18)
        + (((lane >> 4) & 1) * 8 + (lane & 7)) * (PACK_K * 2)
        + ((lane >> 3) & 1) * 16;
    const uint32_t v18k8 = smem_u32(T.v18)
        + (((lane >> 3) & 1) * 8 + (lane & 7)) * (PACK_K * 2) + 32;
    const uint32_t pk = smem_u32(T.pack) + (lane & 15) * 16;
#pragma unroll 1
    for (int k0 = 0; k0 < FAST_TILE_J; k0 += 16) {
        uint32_t bc[4], bk[2], bp[2];
        ldsm_x4(bc, v18 + k0 * (PACK_K * 2));
        ldsm_x2(bk, v18k8 + k0 * (PACK_K * 2));
        ldsm_x2_trans(bp, pk + k0 * 16);
        float4 vt[2];
        float2 mj[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int c0 = k0 + 8 * h + 2 * t;
            vt[h] = *reinterpret_cast<const float4*>(&T.vt[c0]);
            mj[h] = *reinterpret_cast<const float2*>(&T.m[c0]);
        }
        // d2 of rows (g, g + 8) of each m16 tile x columns (k0 + 2t, +1)
        // and (+8, +9): the two n8 halves, in A-fragment order.
        float d2[FAST_MT][8];
        bool close = false;
#pragma unroll
        for (int m = 0; m < FAST_MT; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float x[4] = {0.f, 0.f, 0.f, 0.f};
                mma_bf16(x, ua16[m], bc[2 * h], bc[2 * h + 1]);
                mma_k8(x, ua8[m], bk[h]);
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    const float vn2 = (p & 1) ? vt[h].z : vt[h].x;
                    const float tv = (p & 1) ? vt[h].w : vt[h].y;
                    d2[m][4 * h + p] = __fadd_rn(
                        fmaf(-2.f, x[p], un[m][p >> 1]), vn2);
                    close |= d2[m][4 * h + p] < __fadd_rn(tu[m][p >> 1], tv);
                }
            }
        // The direct distances, in a branch the whole warp takes only when
        // one of its pairs is that close.
        if (__any_sync(0xffffffffu, close)) {
#pragma unroll
            for (int m = 0; m < FAST_MT; ++m)
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int p = 0; p < 4; ++p) {
                        const float tv = (p & 1) ? vt[h].w : vt[h].y;
                        if (d2[m][4 * h + p] < __fadd_rn(tu[m][p >> 1], tv))
                            d2[m][4 * h + p] = direct_d2(
                                pos_i, rw + 16 * m + g + 8 * (p >> 1), ni,
                                pos_j, j0 + k0 + 8 * h + 2 * t + (p & 1), nj,
                                eps2);
                    }
        }
#pragma unroll
        for (int m = 0; m < FAST_MT; ++m) {
            float f[8];
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    f[4 * h + p] = weight(d2[m][4 * h + p],
                                          (p & 1) ? mj[h].y : mj[h].x, eps2);
                    if (MASK && 16 * m + g + 8 * (p >> 1)
                                    == diag + k0 + 8 * h + 2 * t + (p & 1))
                        f[4 * h + p] = 0.f;
                }
            // A fragment: a0 = (g, 2t..), a1 = (g+8, 2t..), a2 = (g,
            // 2t+8..), a3 = (g+8, 2t+8..).
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
                split2(f[2 * r], f[2 * r + 1], hi[r], lo[r]);
            mma_bf16(d[m], hi, bp[0], bp[1]);
            mma_bf16(d[m], lo, bp[0], bp[1]);
        }
    }
}

// Rows blockIdx.x * FAST_ROWS .. + FAST_ROWS against the j tiles of split
// blockIdx.y; the sums go to out (the split's partial sums when the j
// range is split).
__global__ void __launch_bounds__(FAST_THREADS, 2)
fast_forces_kernel(const float* __restrict__ pos_i, long long ni,
                   const float* __restrict__ pos_j, long long nj,
                   const FastJTile* __restrict__ tiles, long long ntiles,
                   long long tiles_per_split, float eps2, int mask_self,
                   float* __restrict__ out) {
    __shared__ FastJTile buf[2];
    __shared__ __align__(16) __nv_bfloat16 su[FAST_WARPS][32 * U_LD];
    __shared__ __align__(8) uint64_t full[2], empty[2];
    const int tid = threadIdx.x;
    const int w = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const long long r0 = (long long)blockIdx.x * FAST_ROWS;
    const long long rw = r0 + FAST_WARP_ROWS * w;
    const long long tb = (long long)blockIdx.y * tiles_per_split;
    const long long te = min(ntiles, tb + tiles_per_split);
    const int count = (int)(te - tb);
    if (tid == 0) {
        for (int b = 0; b < 2; ++b) {
            mbar_init(&full[b], 1);
            mbar_init(&empty[b], FAST_WARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
        for (int k = 0; k < 2 && k < count; ++k)
            load_tile(&buf[k], tiles + tb + k, &full[k]);

    // The row this lane stages, and component t of this lane's fragment
    // rows (16 m + g, + 8) for the per-tile correction.
    const float3 xs = load_pos(pos_i, rw + lane, ni);
    float xc[FAST_MT][2], acc[FAST_MT][2];
#pragma unroll
    for (int m = 0; m < FAST_MT; ++m)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const long long row = rw + 16 * m + g + 8 * r;
            xc[m][r] = (row < ni) ? pos_i[3 * row + min(t, 2)] : 0.f;
            acc[m][r] = 0.f;
        }
    __nv_bfloat16* my = su[w];
    // ldmatrix row addresses of the A fragments (k 0-15: rows 0-7 / 8-15
    // x k 0-7 / 8-15; k 16-23: rows 0-7 / 8-15).
    const uint32_t ua_addr = smem_u32(my)
        + (((lane >> 3) & 1) * 8 + (lane & 7)) * (U_LD * 2)
        + ((lane >> 4) & 1) * 16;
    const uint32_t ua8_addr = smem_u32(my)
        + (((lane >> 3) & 1) * 8 + (lane & 7)) * (U_LD * 2) + 32;

    for (int lt = 0; lt < count; ++lt) {
        const int b = lt & 1;
        const uint32_t phase = (lt >> 1) & 1;
        mbar_wait(&full[b], phase);
        const FastJTile& T = buf[b];
        const long long j0 = (tb + lt) * FAST_TILE_J;
        // This warp's u18 rows, |u|^2 + eps2 and tu, one row a lane.
        const float4 c = T.c;
        const float3 u = make_float3(__fsub_rn(xs.x, c.x),
                                     __fsub_rn(xs.y, c.y),
                                     __fsub_rn(xs.z, c.z));
        __syncwarp();
        pack18<true>(my + lane * U_LD, u);
        const float un2e = __fadd_rn(norm2(u), eps2);
        *reinterpret_cast<float2*>(my + lane * U_LD + PACK_K) =
            make_float2(un2e, __fmul_rn(un2e, CLOSE_PAIR_SCALE));
        __syncwarp();
        uint32_t ua16[FAST_MT][4], ua8[FAST_MT][2];
        float un[FAST_MT][2], tu[FAST_MT][2];
#pragma unroll
        for (int m = 0; m < FAST_MT; ++m) {
            ldsm_x4(ua16[m], ua_addr + 16 * m * (U_LD * 2));
            ldsm_x2(ua8[m], ua8_addr + 16 * m * (U_LD * 2));
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const float2 s = *reinterpret_cast<const float2*>(
                    my + (16 * m + g + 8 * r) * U_LD + PACK_K);
                un[m][r] = s.x;
                tu[m][r] = s.y;
            }
        }
        float d[FAST_MT][4];
#pragma unroll
        for (int m = 0; m < FAST_MT; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[m][e] = 0.f;
        // The tile that holds this warp's self-pairs (rows rw .. rw + 31).
        const bool diag = mask_self && j0 < rw + FAST_WARP_ROWS
                          && rw < j0 + FAST_TILE_J;
        if (diag)
            fast_tile<true>(T, ua16, ua8, un, tu, (int)(j0 - rw), pos_i, ni,
                            rw, pos_j, nj, j0, eps2, d);
        else
            fast_tile<false>(T, ua16, ua8, un, tu, 0, pos_i, ni, rw, pos_j,
                             nj, j0, eps2, d);
#pragma unroll
        for (int m = 0; m < FAST_MT; ++m) {
            acc[m][0] = __fadd_rn(acc[m][0],
                                  tile_correction(d[m][0], d[m][1],
                                                  xc[m][0]));
            acc[m][1] = __fadd_rn(acc[m][1],
                                  tile_correction(d[m][2], d[m][3],
                                                  xc[m][1]));
        }
        // Release the buffer; thread 0 refills it once every warp has.
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[b]);
        if (w == 0) {
            if (lane == 0 && lt + 2 < count) {
                mbar_wait(&empty[b], phase);
                load_tile(&buf[b], tiles + tb + lt + 2, &full[b]);
            }
            __syncwarp();
        }
    }
    if (t < 3) {
        float* o = out + (long long)blockIdx.y * 3 * ni;
#pragma unroll
        for (int m = 0; m < FAST_MT; ++m)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const long long row = rw + 16 * m + g + 8 * r;
                if (row < ni) o[3 * row + t] = acc[m][r];
            }
    }
}

// out = the splits' partial sums added in split order.
__global__ void fast_combine_kernel(const float* __restrict__ part,
                                    long long len, int splits,
                                    float* __restrict__ out) {
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= len) return;
    float s = part[k];
    for (int q = 1; q < splits; ++q) s = __fadd_rn(s, part[q * len + k]);
    out[k] = s;
}

// One evaluation: tiles holds ceil(nj / FAST_TILE_J) FastJTiles (at least
// one), part splits * 3 * ni floats when splits > 1.
extern "C" int nbt_forces_fast(const float* pos_i, long long ni,
                               const float* pos_j, const float* mass_j,
                               long long nj, float eps2, int mask_self,
                               long long splits, long long tiles_per_split,
                               void* tiles, float* part, float* acc,
                               void* stream) {
    if (ni <= 0) return 0;
    const long long ntiles = nj > 0 ? (nj + FAST_TILE_J - 1) / FAST_TILE_J
                                    : 1;
    if (splits < 1 || splits > 65535 || tiles_per_split < 1
        || (splits - 1) * tiles_per_split >= ntiles
        || splits * tiles_per_split < ntiles)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    FastJTile* t = (FastJTile*)tiles;
    fast_prologue_kernel<<<(unsigned)ntiles, FAST_TILE_J, 0, s>>>(
        pos_j, mass_j, nj, t);
    const long long blocks = (ni + FAST_ROWS - 1) / FAST_ROWS;
    fast_forces_kernel<<<dim3((unsigned)blocks, (unsigned)splits),
                         FAST_THREADS, 0, s>>>(
        pos_i, ni, pos_j, nj, t, ntiles, tiles_per_split, eps2, mask_self,
        splits > 1 ? part : acc);
    if (splits > 1) {
        const long long len = 3 * ni;
        fast_combine_kernel<<<(unsigned)((len + 255) / 256), 256, 0, s>>>(
            part, len, (int)splits, acc);
    }
    return (int)cudaGetLastError();
}

extern "C" int nbt_fast_tile(void) { return FAST_TILE_J; }
extern "C" int nbt_fast_rows(void) { return FAST_ROWS; }
extern "C" int nbt_fast_tile_bytes(void) { return (int)sizeof(FastJTile); }
