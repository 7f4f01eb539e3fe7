// K5 / K6 / K14a-c: Newton's-third-law all-pairs forces on Hopper's tensor
// cores (sm_90a): the pair-symmetric speed tiers (turbo, turbo2, turbof,
// turbop) and the near-exact tier (mxu).
//
// Replaces nbody_tpu/ops/forces_pallas_sym.py:_make_sym_kernel, variants
// "turbo" (_accum_i_turbo, _accum_j_turbo), "mxu" (_accum_both_mxu),
// "turbo2" (_accum_i_turbo2, _accum_j_turbo2, _mass_folded_pack) and
// "turbof" (_accum_both_turbof, with the 1/m descale of _inv_mass_scale),
// and _make_sym_kernel_turbop (turbo with the j-side chain deferred), with
// the exact diagonal pass _diag_kernel_vpu, as _forces_sym_padded composes
// them.
//
// Schedule, slots and determinism are K2's (forces_sym.cu, sym_common.cuh):
// 256-wide tiles, row tile I against column tile J = (I + d) mod nb for
// the circular offsets d, one CTA per (I, d) writing its own row slot
// si[d][I] and column slot sj[d][J], offsets in chunks, and a reduce pass
// that adds the slots in a fixed order.  Bit-reproducible, no atomics.
//
// The pair tile.  inv = rsqrt((|r|^2 + eps2)^3) is computed once a pair.
//   turbo:  i-side  bf16(m_j inv)  @ pos pack of J      (force on i)
//           j-side  bf16(m_i inv)^T @ pos pack of I     (force on j)
//   mxu:    i-side  (inv_hi + inv_lo)  @ mass-folded pack of J
//           j-side  (inv_hi + inv_lo)^T @ mass-folded pack of I
//   turbo2: i-side  bf16(inv)  @ mass-folded pack of J  (mxu's lo limb
//           j-side  bf16(inv)^T @ mass-folded pack of I  dropped)
//   turbof: i-side  bf16(m_i m_j inv)  @ pos pack of J  (one weight
//           j-side  bf16(m_i m_j inv)^T @ pos pack of I  matrix, shared)
// and each side's tile result is  sum w x - x * sum w  per component
// (tc_common.cuh).  turbo, mxu and turbo2 give accelerations, so their
// slots need no descale; turbof's slots carry the receiving body's mass
// and its reduce pass descales them by 1/m as K2's does, recomputing the
// row of a real body of mass 0 one-sided (JAX's turbof maps 1/0 to 0 and
// leaves such a body with its diagonal terms only).  The correction is
// applied once per 256 x 256 tile on both sides; the plain versions
// (ops/forces_sym_tc.py) do the same, and the JAX package is compared at
// block_u = 256.
//
// turbop is turbo with the j-side mma of each 16 x 16 block issued after
// the geometry and i-side mma of the next block, from the previous
// block's bf16 weights held in registers: the tensor-core chain of the
// j-side has no dependency on the float32 geometry issued before it.  The
// values and the per-slot add order are turbo's, so turbop is bit-equal
// to K5.
//
// The diagonal tiles are exact float32, one-sided with m_j weights
// (sym_diag_tile; turbof: K2's sym_diag with sym_descale), added to the
// slot sums in the reduce pass.  For turbo, mxu and turbo2 a real body of
// mass 0 needs nothing more: its weights carry its partners' masses.
// Ghost slots past N load as zero-mass bodies at the origin: weight m = 0
// on their partners' sides (turbo, turbof), a zero pack (mxu, turbo2);
// their own slots are written but never read into a real body.
//
// Warps.  Eight warps; warp w owns rows 32w .. 32w+31 of I (two 16-row
// blocks) and sweeps the 16 column blocks of J.  For each 16 x 16 block a
// lane computes the 8 pairs of its mma A fragment in registers, so the
// i-side weights are the A operand directly (B: J's pack, in shared
// memory).  The j-side needs the transposed weights: movmatrix.trans
// transposes each 8 x 8 quarter in registers, so the geometry is computed
// once.  The i-side accumulators stay in registers across the J sweep; the
// j-side partial sums of each warp (hi + lo per component, and the weight
// column) meet in shared memory and are added warp by warp in a fixed
// order.
//
// What bounds it on the card: float32 issue, as K2.  A pair costs 14
// float32 operations for two interactions (3 sub, 6 for d2 + eps2, 2 for
// the cube, 1 rsqrt on the MUFU, 2 weight multiplies) for turbo, turbop
// and turbof (m_i m_j, then times inv), 13 for mxu (the hi/lo split's
// subtract in place of the multiplies), 12 for turbo2 (no per-pair mass
// multiply: the masses ride in the packs), plus the bf16 roundings (two a
// pair for turbo and mxu, one for turbo2 and turbof) and 4 movmatrix a
// 16 x 16 block (8 for mxu), against 32 tensor-core flops a pair (64 for
// mxu).  The tensor cores are not the limit (K5's 32 flops a pair take
// about 18 ms of an evaluation at N = 1M).
//
// K5's geometry is trimmed (tc_trimmed, pair_inv_fma in tc_common.cuh):
// d2 as three FMAs with eps2 folded in, and the MUFU rsqrt of d2^3
// without rsqrtf's subnormal fix-up, which brings its pair from about
// 19.6 issue slots to about 13.6 (3 sub, 3 FMA, 2 mul for the cube, the
// rsqrt, 2 weight multiplies, one bf16x2 convert, half a movmatrix, a
// quarter mma, and 0.9 of loads and partial stores a 16-column step).
// turbop, TMM_FULL and TMM_NOSCAT, defined as K5's values, take it too,
// in both sweeps; mxu, turbo2, turbof, the other ablations and K13 keep
// pair_inv.  The trimmed tile also unrolls its 16-column loop twice.  On
// an H100 80GB HBM3 at 700 W an evaluation at N = 1M takes 333.5 ms
// (343.1 with the loop rolled, 433.5 untrimmed; tools/sym_tc_variants.py,
// chip_smoke.py): the pair passes issue at about 70% of the rate at 13.4
// slots a pair, and the reduce passes take about 16 ms.  Four CTAs an SM
// at 64 registers (three at 80) did not pay.  Left for later: wgmma, TMA-fed tiles, a persistent
// schedule, the trimmed geometry for the other variants.
//
// K15's tmm_* ablations (nbody_tpu/ops/ablation_sym.py, _tile_turbo_mm)
// are four more values of the tile's variant, SymTcVariant; their none /
// fix0 reduce passes are in forces_sym.cu.
//
// K2-rect (the rect sweep of _make_rect_kernel, variants turbo, mxu,
// turbo2 and turbof, and of _make_rect_kernel_turbop, between two disjoint
// body sets) runs the same tile, sym_tc_tile, over the rectangular
// enumeration and slots of rect_common.cuh: one CTA per (row tile of A,
// column tile of B), no diagonal.  turbop stays bit-equal to turbo there
// too.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include "rect_common.cuh"
#include "sym_common.cuh"
#include "tc_common.cuh"
#include "sym_tc_tile.cuh"

// One CTA per (row tile I, offset d) of the chunk d = d_lo .. d_lo+dc-1.
// TMM_NOSCAT stores its column sums in slot sj[d][I], the writer's own.
template <int V>
__global__ void __launch_bounds__(SYM_TILE)
sym_tc_pairs_kernel(const float* __restrict__ pos,
                    const float* __restrict__ mass, long long n,
                    long long nb, long long d_lo, float eps2,
                    float* __restrict__ si, float* __restrict__ sj) {
    __shared__ __align__(16) SymTcSmem sm;
    const long long bid = blockIdx.x;
    const long long dk = bid / nb;
    const long long I = bid - dk * nb;
    const long long d = d_lo + dk;
    if (2 * d == nb && 2 * I >= nb) return;   // even nb: half offset
    const long long J = (I + d) % nb;
    const long long slot = dk * nb * SYM_TILE * 3;
    const long long jt = (V == TMM_NOSCAT) ? I : J;
    sym_tc_tile<tc_tile_of(V), tc_trimmed(V)>(
        pos, mass, n, I, pos, mass, n, J, eps2, si + slot + 3 * I * SYM_TILE,
        sj + slot + 3 * jt * SYM_TILE, sm);
}

// K2-rect on the tensor cores: one CTA per (row tile IA of A, column tile
// JB = j_lo + jk of B), the slots of rect_common.cuh.
template <int V>
__global__ void __launch_bounds__(SYM_TILE)
rect_tc_pairs_kernel(const float* __restrict__ pos_a,
                     const float* __restrict__ mass_a, long long na,
                     const float* __restrict__ pos_b,
                     const float* __restrict__ mass_b, long long nb,
                     long long na_s, long long j_lo, long long jc,
                     float eps2, float* __restrict__ si,
                     float* __restrict__ sj) {
    __shared__ __align__(16) SymTcSmem sm;
    const long long bid = blockIdx.x;
    const long long jk = bid / na_s;
    const long long IA = bid - jk * na_s;
    sym_tc_tile<tc_tile_of(V), tc_trimmed(V)>(
        pos_a, mass_a, na, IA, pos_b, mass_b, nb, j_lo + jk, eps2,
        si + (jk * na_s + IA) * SYM_TILE * 3,
        sj + (IA * jc + jk) * SYM_TILE * 3, sm);
}

// One CTA per tile: folds the chunk's slots into the running sum, and on the
// last chunk adds the exact diagonal tile (DESCALE, turbof: K2's diagonal,
// 1/m descale and one-sided recompute of massless rows).
template <bool DESCALE>
__global__ void __launch_bounds__(SYM_TILE)
sym_tc_reduce_kernel(const float* __restrict__ pos,
                     const float* __restrict__ mass, long long n,
                     long long nb, long long d_lo, long long dc,
                     const float* __restrict__ si,
                     const float* __restrict__ sj, float* __restrict__ raw,
                     int first, int last, float eps2,
                     float* __restrict__ out) {
    __shared__ float4 tile[SYM_TILE];
    const long long I = blockIdx.x;
    const long long b = I * SYM_TILE + threadIdx.x;

    float3 s = first ? make_float3(0.f, 0.f, 0.f)
                     : make_float3(raw[3 * b], raw[3 * b + 1], raw[3 * b + 2]);
    s = sym_slot_sum(s, nb, I, b, d_lo, dc, si, sj);
    if (!last) {
        raw[3 * b] = s.x;
        raw[3 * b + 1] = s.y;
        raw[3 * b + 2] = s.z;
        return;
    }
    if (DESCALE) {
        const float3 d = sym_diag(pos, mass, n, b, eps2, tile);
        if (b < n) {
            const float3 a = sym_descale(d, s, mass[b]);
            out[3 * b] = a.x;
            out[3 * b + 1] = a.y;
            out[3 * b + 2] = a.z;
        }
        return;
    }
    const float3 d = sym_diag_tile(pos, mass, n, b, eps2, tile);
    if (b < n) {
        out[3 * b] = __fadd_rn(d.x, s.x);
        out[3 * b + 1] = __fadd_rn(d.y, s.y);
        out[3 * b + 2] = __fadd_rn(d.z, s.z);
    }
}

// The dynamic shared memory K15's tmm_* pair launches reserve: 0, but
// while nbt_sym_tc_abl_pin holds them at K5's CTAs per SM.  No kernel reads
// it.
static int abl_dyn_smem = 0;

template <int V>
static int launch_pairs(const float* pos, const float* mass, long long n,
                        long long nb, long long d_lo, long long dc,
                        float eps2, float* si, float* sj, void* stream) {
    if (dc <= 0) return 0;
    sym_tc_pairs_kernel<V><<<(unsigned)(nb * dc), SYM_TILE,
                             V >= TMM_FULL ? abl_dyn_smem : 0,
                             (cudaStream_t)stream>>>(pos, mass, n, nb, d_lo,
                                                     eps2, si, sj);
    return (int)cudaGetLastError();
}

template <bool DESCALE>
static int launch_reduce(const float* pos, const float* mass, long long n,
                         long long nb, long long d_lo, long long dc,
                         const float* si, const float* sj, float* raw,
                         int first, int last, float eps2, float* out,
                         void* stream) {
    sym_tc_reduce_kernel<DESCALE><<<(unsigned)nb, SYM_TILE, 0,
                                    (cudaStream_t)stream>>>(
        pos, mass, n, nb, d_lo, dc, si, sj, raw, first, last, eps2, out);
    return (int)cudaGetLastError();
}

// The pair passes of K5, K6, turbo2, turbof and turbop, each with K2's
// nbt_sym_pairs signature.
#define SYM_TC_PAIRS(NAME, V)                                                \
    extern "C" int NAME(const float* pos, const float* mass, long long n,    \
                        long long nb, long long d_lo, long long dc,          \
                        float eps2, float* si, float* sj, void* stream) {    \
        return launch_pairs<V>(pos, mass, n, nb, d_lo, dc, eps2, si, sj,     \
                               stream);                                      \
    }
SYM_TC_PAIRS(nbt_sym_turbo_pairs, TURBO)
SYM_TC_PAIRS(nbt_sym_mxu_pairs, MXU)
SYM_TC_PAIRS(nbt_sym_turbo2_pairs, TURBO2)
SYM_TC_PAIRS(nbt_sym_turbof_pairs, TURBOF)
SYM_TC_PAIRS(nbt_sym_turbop_pairs, TURBOP)
// K15's tensor-core ablations; their reduce passes are K5's
// (nbt_sym_tc_reduce: tmm_full) and forces_sym.cu's (nbt_sym_fix0_reduce:
// tmm_noscat; nbt_sym_noj_reduce: tmm_noj, tmm_nomm).
SYM_TC_PAIRS(nbt_sym_tmm_full_pairs, TMM_FULL)
SYM_TC_PAIRS(nbt_sym_tmm_noscat_pairs, TMM_NOSCAT)
SYM_TC_PAIRS(nbt_sym_tmm_noj_pairs, TMM_NOJ)
SYM_TC_PAIRS(nbt_sym_tmm_nomm_pairs, TMM_NOMM)

// The occupancy pin of the tmm_* pair kernels at K5's CTAs per SM, as
// nbt_sym_abl_pin (forces_sym.cu) does for vpu_* at K7's.
template <int V>
static int pairs_ctas(int dyn) {
    int ctas = -1;
    if (V >= TMM_FULL &&
        cudaFuncSetAttribute(sym_tc_pairs_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn) != cudaSuccess)
        return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &ctas, sym_tc_pairs_kernel<V>, SYM_TILE, (size_t)dyn) !=
        cudaSuccess)
        return -1;
    return ctas;
}

extern "C" int nbt_sym_tc_pairs_ctas(int v) {
    const int dyn = v >= TMM_FULL ? abl_dyn_smem : 0;
    switch (v) {
        case TURBO: return pairs_ctas<TURBO>(dyn);
        case TMM_FULL: return pairs_ctas<TMM_FULL>(dyn);
        case TMM_NOSCAT: return pairs_ctas<TMM_NOSCAT>(dyn);
        case TMM_NOJ: return pairs_ctas<TMM_NOJ>(dyn);
        case TMM_NOMM: return pairs_ctas<TMM_NOMM>(dyn);
    }
    return -1;
}

extern "C" int nbt_sym_tc_abl_pin(int on) {
    abl_dyn_smem = 0;
    if (!on) return 0;
    const int want = pairs_ctas<TURBO>(0);
    for (int dyn = 0; dyn <= 96 * 1024; dyn += 256) {
        const int c[4] = {pairs_ctas<TMM_FULL>(dyn),
                          pairs_ctas<TMM_NOSCAT>(dyn),
                          pairs_ctas<TMM_NOJ>(dyn),
                          pairs_ctas<TMM_NOMM>(dyn)};
        bool above = false, off = want < 1;
        for (int k = 0; k < 4; ++k) {
            above |= c[k] > want;
            off |= c[k] != want;
        }
        if (above) continue;
        if (off) return -1;
        abl_dyn_smem = dyn;
        return dyn;
    }
    return -1;
}

// The reduce pass of the tiers whose slots are accelerations, and of
// turbof, whose slots are mass-scaled.
extern "C" int nbt_sym_tc_reduce(const float* pos, const float* mass,
                                 long long n, long long nb, long long d_lo,
                                 long long dc, const float* si,
                                 const float* sj, float* raw, int first,
                                 int last, float eps2, float* out,
                                 void* stream) {
    return launch_reduce<false>(pos, mass, n, nb, d_lo, dc, si, sj, raw,
                                first, last, eps2, out, stream);
}

extern "C" int nbt_sym_tc_descale_reduce(const float* pos,
                                         const float* mass, long long n,
                                         long long nb, long long d_lo,
                                         long long dc, const float* si,
                                         const float* sj, float* raw,
                                         int first, int last, float eps2,
                                         float* out, void* stream) {
    return launch_reduce<true>(pos, mass, n, nb, d_lo, dc, si, sj, raw,
                               first, last, eps2, out, stream);
}

template <int V>
static int launch_rect_pairs(const float* pos_a, const float* mass_a,
                             long long na, const float* pos_b,
                             const float* mass_b, long long nb,
                             long long na_s, long long j_lo, long long jc,
                             float eps2, float* si, float* sj, void* stream) {
    if (jc <= 0 || na_s <= 0) return 0;
    rect_tc_pairs_kernel<V><<<(unsigned)(na_s * jc), SYM_TILE, 0,
                              (cudaStream_t)stream>>>(
        pos_a, mass_a, na, pos_b, mass_b, nb, na_s, j_lo, jc, eps2, si, sj);
    return (int)cudaGetLastError();
}

// K2-rect's pair passes for turbo, mxu, turbo2, turbof and turbop, and its
// reduce pass (rect_common.cuh; descale for turbof).
#define RECT_TC_PAIRS(NAME, V)                                               \
    extern "C" int NAME(const float* pos_a, const float* mass_a,             \
                        long long na, const float* pos_b,                    \
                        const float* mass_b, long long nb, long long na_s,   \
                        long long j_lo, long long jc, float eps2, float* si, \
                        float* sj, void* stream) {                           \
        return launch_rect_pairs<V>(pos_a, mass_a, na, pos_b, mass_b, nb,    \
                                    na_s, j_lo, jc, eps2, si, sj, stream);   \
    }
RECT_TC_PAIRS(nbt_rect_turbo_pairs, TURBO)
RECT_TC_PAIRS(nbt_rect_mxu_pairs, MXU)
RECT_TC_PAIRS(nbt_rect_turbo2_pairs, TURBO2)
RECT_TC_PAIRS(nbt_rect_turbof_pairs, TURBOF)
RECT_TC_PAIRS(nbt_rect_turbop_pairs, TURBOP)
// K15's rect forms: the column slot is the writer's own (IA, JB) already,
// so tmm_noscat's pair pass is turbo's and its reduce (forces_sym.cu's
// nbt_rect_fix0_reduce) adds every column slot into B's superblock 0.
RECT_TC_PAIRS(nbt_rect_tmm_full_pairs, TMM_FULL)
RECT_TC_PAIRS(nbt_rect_tmm_noscat_pairs, TMM_NOSCAT)
RECT_TC_PAIRS(nbt_rect_tmm_noj_pairs, TMM_NOJ)
RECT_TC_PAIRS(nbt_rect_tmm_nomm_pairs, TMM_NOMM)

extern "C" int nbt_rect_tc_reduce(const float* pos_a, const float* mass_a,
                                  long long na, const float* pos_b,
                                  const float* mass_b, long long nb,
                                  long long na_s, long long u, long long j_lo,
                                  long long jc, const float* si,
                                  const float* sj, float* raw_a, int first,
                                  int last, int descale, float eps2,
                                  float* acc_a, float* acc_b, void* stream) {
    return launch_rect_reduce(pos_a, mass_a, na, pos_b, mass_b, nb, na_s, u,
                              j_lo, jc, si, sj, raw_a, first, last, descale,
                              eps2, acc_a, acc_b, stream);
}

extern "C" int nbt_sym_tc_tile(void) { return SYM_TILE; }
