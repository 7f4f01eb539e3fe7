// Device code shared by the tensor-core force tiers: K9/K10 (one-sided,
// forces_tiled_tc.cu) and K5/K6 (pair-symmetric, forces_sym_tc.cu).
//
// Every tier forms a per-pair weight in float32, rounds it to bf16 (hi/lo
// limbs for the mxu tiers) and lets the tensor cores sum weight x pack with
// float32 accumulation, where a pack holds 8 bf16 columns per body:
//
//   position pack      [x_hi x_lo y_hi y_lo z_hi z_lo 1 0]
//   mass-folded pack   [Px_hi Px_lo Py_hi Py_lo Pz_hi Pz_lo m_hi m_lo], P = m x
//
// These are the JAX package's packs (forces_pallas_sym.py:_pack8 and
// _mass_folded_pack) with the columns interleaved hi, lo: in the mma
// accumulator a thread holds columns 2t and 2t+1, so it adds hi + lo of
// component t (or the two weight columns, t = 3) without a shuffle.  The
// result of a tile is then  sum w x_j - x_i sum w  per component, the
// correction of forces_pallas.py:255 / forces_pallas_sym.py:230,242,312.
//
// Rounding follows the plain PyTorch versions step by step: the pair
// geometry is evaluated with __f*_rn (no FMA contraction) in the order
// dx*dx + dy*dy + dz*dz + eps2, so that the float32 weights, and hence
// their bf16 roundings, are those of the plain versions on the same card;
// bf16 conversion rounds to nearest even, as .to(torch.bfloat16) and JAX's
// astype do.  K5's trimmed geometry (pair_inv_fma) fuses d2 instead, and
// its twin rounds each fused multiply-add once.
//
// Fragment layouts of mma.m16n8k16 (bf16 in, f32 accumulate), for lane
// l = 4g + t:
//   A (16x16)  rows g, g+8 x columns 2t, 2t+1, 2t+8, 2t+9; registers
//              a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//              a3 = (g+8, 2t+8..), the lower column in the low half;
//   B (16x8)   k = 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of column g;
//   D (16x8)   (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Row pitch (in bf16) of a transposed pack in shared memory: the 8 columns
// are stored as rows of `tile + TC_PAD` entries.  With the pad the 32
// lanes of a B-fragment load hit 32 different banks.
#define TC_PAD 8

__device__ __forceinline__ uint32_t bf16x2(__nv_bfloat16 lo,
                                           __nv_bfloat16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo)
           | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Two float32 weights as one bf16x2 register, each rounded to nearest even.
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
    return bf16x2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// The bf16 hi/lo split: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16& hi,
                                           __nv_bfloat16& lo) {
    hi = __float2bfloat16_rn(x);
    lo = __float2bfloat16_rn(__fsub_rn(x, __bfloat162float(hi)));
}

// Hi and lo limbs of two weights as two bf16x2 registers.
__device__ __forceinline__ void split_rn(float a, float b, uint32_t& hi,
                                         uint32_t& lo) {
    __nv_bfloat16 ah, al, bh, bl;
    split_bf16(a, ah, al);
    split_bf16(b, bh, bl);
    hi = bf16x2(ah, bh);
    lo = bf16x2(al, bl);
}

// Writes body k's position pack into column k of packT (8 rows of pitch ld).
__device__ __forceinline__ void pack_position(__nv_bfloat16* packT, int ld,
                                              int k, float4 b) {
    const float c[3] = {b.x, b.y, b.z};
#pragma unroll
    for (int e = 0; e < 3; ++e)
        split_bf16(c[e], packT[(2 * e) * ld + k], packT[(2 * e + 1) * ld + k]);
    packT[6 * ld + k] = __float2bfloat16_rn(1.f);
    packT[7 * ld + k] = __float2bfloat16_rn(0.f);
}

// Writes body k's mass-folded pack (P = m x) into column k of packT.
__device__ __forceinline__ void pack_mass_folded(__nv_bfloat16* packT,
                                                 int ld, int k, float4 b) {
    const float c[3] = {__fmul_rn(b.w, b.x), __fmul_rn(b.w, b.y),
                        __fmul_rn(b.w, b.z)};
#pragma unroll
    for (int e = 0; e < 3; ++e)
        split_bf16(c[e], packT[(2 * e) * ld + k], packT[(2 * e + 1) * ld + k]);
    split_bf16(b.w, packT[6 * ld + k], packT[7 * ld + k]);
}

// B fragment of pack rows k0 .. k0+15 (all 8 columns) for lane (g, t).
__device__ __forceinline__ void load_b(const __nv_bfloat16* packT, int ld,
                                       int k0, int g, int t, uint32_t& b0,
                                       uint32_t& b1) {
    const __nv_bfloat16* p = packT + g * ld + k0 + 2 * t;
    b0 = *reinterpret_cast<const uint32_t*>(p);
    b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// d += a x b on the tensor cores.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
    uint32_t y;
    asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
                 : "=r"(y) : "r"(x));
    return y;
}

// The A fragment of the transposed 16x16 matrix: each 8x8 quarter is
// transposed in place and the two off-diagonal quarters trade places.
__device__ __forceinline__ void transpose_a(const uint32_t a[4],
                                            uint32_t at[4]) {
    at[0] = movmatrix_trans(a[0]);
    at[1] = movmatrix_trans(a[2]);
    at[2] = movmatrix_trans(a[1]);
    at[3] = movmatrix_trans(a[3]);
}

// rsqrt((|x_j - x_i|^2 + eps2)^3), rounded as the plain versions round.
__device__ __forceinline__ float pair_inv(float4 bi, float4 bj, float eps2) {
    const float dx = __fsub_rn(bj.x, bi.x);
    const float dy = __fsub_rn(bj.y, bi.y);
    const float dz = __fsub_rn(bj.z, bi.z);
    const float d2 = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                  __fmul_rn(dz, dz)), eps2);
    return rsqrtf(__fmul_rn(__fmul_rn(d2, d2), d2));
}

// pair_inv trimmed for K5's tile (sym_tc_tile.cuh, TRIM): d2 as three
// fused multiply-adds with eps2 folded in, and the rsqrt of d2^3 on the
// MUFU without rsqrtf's subnormal fix-up (a compare and two predicated
// multiplies; sym_common.cuh's rsqrt_normal, written out here because
// this header stands alone): rsqrtf's bits wherever d2^3 is a normal
// float, which d2 >= eps2 makes it for every eps2 above ~1e-12.  10 issue
// slots against pair_inv's 15 (3 sub, 3 FMA, 2 mul for the cube, 1 MUFU,
// and no fix-up).  The plain twin rounds each FMA once from its exact
// value (ops/forces_sym_tc.py: pair_inv_fma).
__device__ __forceinline__ float pair_inv_fma(float4 bi, float4 bj,
                                              float eps2) {
    const float dx = __fsub_rn(bj.x, bi.x);
    const float dy = __fsub_rn(bj.y, bi.y);
    const float dz = __fsub_rn(bj.z, bi.z);
    const float d2 =
        __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmaf_rn(dx, dx, eps2)));
    float y;
    asm("rsqrt.approx.ftz.f32 %0, %1;"
        : "=f"(y) : "f"(__fmul_rn(__fmul_rn(d2, d2), d2)));
    return y;
}

__device__ __forceinline__ float component(float4 b, int e) {
    return e == 0 ? b.x : (e == 1 ? b.y : b.z);
}

// The tile result of component t for the accumulator rows of this lane:
// s = hi + lo column sums (lane t < 3) and the weight sum w (lane t = 3,
// shuffled across the quad); returns s - x * w, meaningful for t < 3.
__device__ __forceinline__ float tile_correction(float d_even, float d_odd,
                                                 float x) {
    const float s = __fadd_rn(d_even, d_odd);
    const int lane = threadIdx.x & 31;
    const float w = __shfl_sync(0xffffffffu, s, lane | 3);
    return __fsub_rn(s, __fmul_rn(x, w));
}
