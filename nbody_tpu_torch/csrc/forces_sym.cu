// K2, K7, K14d, K2-rect and K15 (exact): Newton's-third-law exact
// all-pairs forces for Hopper (sm_90a).
//
// Replaces nbody_tpu/ops/forces_pallas_sym.py variant "vpu2":
//   _make_sym_kernel (the off-diagonal tile pairs, _pair_products_sym) and
//   _diag_kernel_vpu (the one-sided diagonal superblocks), with the 1/m
//   descale of _inv_mass_scale, as _forces_sym_padded composes them.
//
// Bodies are cut into tiles of SYM_TILE.  nb = ceil(N / SYM_TILE) tiles;
// the tail is masked at load time (a slot past N loads as a zero-mass body
// at the origin, which adds exactly 0 on both sides), so no padded copy of
// the state is made.  Every unordered off-diagonal tile pair is visited
// once, by circular offsets: row tile I pairs with column tile
// J = (I + d) mod nb for d = 1 .. nb/2, where for even nb the last offset
// d = nb/2 is taken only by the rows I < nb/2 (the other half would repeat
// those pairs).  For one pair tile the shared weight F = m_i m_j inv,
// inv = rsqrt((|r|^2 + eps2)^3), is computed once; F*r is summed along rows
// (force on i, times m_i) and along columns (force on j, times m_j,
// negated).  The diagonal tiles are one-sided (m_j weights, self-pair
// vanishes by r = 0) and are computed in the reduce pass.
//
// Determinism contract.  On the TPU the j-side scatter is race-free only
// because grid steps run in order.  Here CTAs run concurrently, so each CTA
// (row tile I, offset d) writes its row sums to slot SI[d][I] and its
// column sums to slot SJ[d][J]; every slot is written by exactly one CTA
// and no atomics are used.  The reduce pass then adds, for each body, the
// slots in a fixed order (offset by offset, i-side before j-side), divides
// by the body's mass and adds the one-sided diagonal tile.  Results are
// bit-reproducible from run to run.
//
// Scratch.  The slots take 2 * D * N_pad * 3 * 4 bytes for D = nb/2
// offsets: 3.1 MB at N = 8192 (nb = 32, D = 16), but 51.5 GB at
// N = 1,048,576 (nb = 4096, D = 2048).  The wrapper therefore processes
// the offsets in chunks whose slots fit a fixed budget (2 GiB by default:
// 85 offsets a chunk at N = 1,048,576) and folds each chunk into a running
// (N_pad, 3) sum with the same reduce kernel; the last chunk finalises.
// It raises where one offset's slots alone exceed the budget.
//
// Zero-mass real bodies.  The row sums carry m_i as a factor, so for a body
// with m_i = 0 they cannot be descaled (the JAX vpu2 path returns only the
// diagonal terms there).  The reduce pass instead recomputes such a row
// one-sided over all N bodies.  Ghosts past N are never written.
//
// Index arithmetic (tiles, slots, offsets) is 64-bit, and the grid is
// flattened onto gridDim.x.
//
// Design of the pair tile (sym_pair_tile, sym_common.cuh).  Warp w takes
// the tile's columns 32w .. 32w+31 against all 256 rows, and lane l holds
// rows l + 32r (r < 8) in registers.  At step k lane l pairs its eight rows
// with column (l + k) mod 32 of the warp's range (one shared load; the
// warp's columns are staged twice over, so the address is l plus a
// constant), adds F r to the eight row sums and to one column accumulator
// with fused multiply-adds, and then takes the column accumulator of lane
// l + 1 (three shuffles): after 32 steps lane l holds column 32w + l over
// all rows.  The eight warps' row partials are added once a tile, in warp
// order, through shared memory.  d2 + eps2 is three FMAs, and the rsqrt
// takes the MUFU without rsqrtf's subnormal fix-up (d2^3 >= eps2^3 is
// normal), so a pair is 17 issue slots (3 sub, 3 FMA for d2, 2 mul for the
// cube, 1 rsqrt, 2 mul for F, 6 FMA into the row and column sums) and the
// load and shuffles add half a slot.
//
// What bounds it on the card: FP32 FMA and MUFU issue.  At N = 1,048,576
// on an H100 80GB HBM3 at 700 W an evaluation takes 392.5 ms, 17.5 slots
// a pair at 73% of the issue rate at the 1980 MHz boost clock.  The pair
// passes take 375.7 ms of it and the 25 reduce passes (slots, diagonal,
// descale) 16.9 ms, so a persistent schedule that keeps the i side in
// registers across offsets would win at most those 4%.
//
// K2-rect's classic vpu2 and vpu sweeps (rect_k2_pairs_kernel and
// rect_k7_pairs_kernel, below) and K13's two-sided vpu2 phases run this
// tile's core, sym_pair_core, on two body sets: a 262,144 x 262,144
// rotation of the 1M ring takes 49.1 ms there with K2's math (65.7 on
// sym_tile_core), 73% of the issue rate; the folds (K14d and K2-rect's)
// run it too.  Left for later: wgmma accumulation of the row and column
// sums on the tensor cores.
//
// The pair tile, the slot sum and the diagonal tile are in sym_common.cuh,
// shared with the resident kernels (resident.cu).
//
// K7 (variant "vpu" of _make_sym_kernel: _pair_terms, _accum_i_vpu,
// _accum_j_vpu) shares the schedule, slots and reduce pass.  Per pair it
// computes inv once and weighs each side by the other's mass: fi = m_j inv
// for the row sums (an acceleration of i), fj = m_i inv for the negated
// column sums (of j).  Nothing is mass-scaled, so there is no descale and a
// real massless body is complete from its slots; its diagonal is the exact
// sym_diag_tile of K5/K6.  26 flops a pair (3 more multiplies than K2's
// 23).  K7 runs K2's pair tile with K7's math (sym_pair_core<SYM_K7>):
// the same 17 issue slots a pair, the two weight multiplies in place of
// K2's m_i m_j and F, at 80 registers, no spill, three CTAs an SM.  On an
// H100 80GB HBM3 at 700 W an evaluation at N = 1,048,576 takes 404.2 ms
// against 533.0 on sym_tile_core (one row a thread, a column accumulator
// shuffled once a pair, rsqrtf with its fix-up), 0.0420 ms of the card's
// time at N = 8192 against 0.0487, and K2-rect vpu's 262,144 x 262,144
// sweep 50.0 ms against 66.2 (chip_smoke.py check_redesign, medians of
// four alternating rounds).  Its summation within a tile follows K2's
// tile (row partials added in warp order, one column accumulator over the
// tile's 256 rows); K2's instantiation keeps its code, so K3/K4 stay
// bit-equal to per-step K2.
//
// K14d (the fold schedule of _make_sym_kernel_fold) runs the pair tile
// with K2's and K7's math on superblocks of several tiles, one superblock
// pair a thread-block cluster, and folds the j-side sums of a superblock's
// row tiles across the cluster; its kernels and their contract follow
// K7's.  K2-rect (the rect sweeps of _make_rect_kernel and
// _make_rect_kernel_fold between two disjoint body sets) runs the pair
// tile, classic or folded the same way, over a rectangular enumeration.
// K15's vpu_* ablations (nbody_tpu/ops/ablation_sym.py) are SymMath values
// of the pair tile, each ablating K7 as it runs, their control: vpu_noj
// its row side alone, vpu_fix0 its column sums in the writer's own slot,
// vpu_rc its differences taken again.  Their reduce passes, shared by
// every K15 form, come last.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include <cooperative_groups.h>

#include <algorithm>
#include <utility>

#include "sym_common.cuh"
#include "rect_common.cuh"
#include "onesided_tile.cuh"

namespace cg = cooperative_groups;

// One CTA per (row tile I, offset d) of the chunk d = d_lo .. d_lo+dc-1:
// the pair tile with K2's or K7's math or K15's vpu_noj / vpu_fix0 /
// vpu_rc.
template <int M>
__global__ void __launch_bounds__(SYM_TILE)
sym_pairs_kernel(const float* __restrict__ pos,
                 const float* __restrict__ mass, long long n, long long nb,
                 long long d_lo, float eps2, float* __restrict__ si,
                 float* __restrict__ sj) {
    __shared__ SymPairSmem sm;
    const long long bid = blockIdx.x;
    const long long dk = bid / nb;
    const long long I = bid - dk * nb;
    const long long d = d_lo + dk;
    if (2 * d == nb && 2 * I >= nb) return;   // even nb: half offset
    sym_pair_tile<M>(pos, mass, n, nb, I, d, dk, eps2, si, sj, sm);
}

// One CTA per tile: folds the chunk's slots into the running sum, and on the
// last chunk adds the one-sided diagonal tile and, for K2, applies the 1/m
// descale (K7's slots are accelerations already).
template <bool K7>
__global__ void __launch_bounds__(SYM_TILE)
sym_reduce_kernel(const float* __restrict__ pos,
                  const float* __restrict__ mass, long long n, long long nb,
                  long long d_lo, long long dc, const float* __restrict__ si,
                  const float* __restrict__ sj, float* __restrict__ raw,
                  int first, int last, float eps2, float* __restrict__ out) {
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
    if (K7) {
        const float3 d = sym_diag_tile(pos, mass, n, b, eps2, tile);
        if (b < n) {
            out[3 * b] = d.x + s.x;
            out[3 * b + 1] = d.y + s.y;
            out[3 * b + 2] = d.z + s.z;
        }
        return;
    }
    const float3 d = sym_diag(pos, mass, n, b, eps2, tile);
    if (b < n) {
        const float3 a = sym_descale(d, s, mass[b]);
        out[3 * b] = a.x;
        out[3 * b + 1] = a.y;
        out[3 * b + 2] = a.z;
    }
}

// Whether M is one of the three vpu_* ablations (the pinned launches).
constexpr bool sym_ablation(int m) {
    return m == VPU_NOJ || m == VPU_FIX0 || m == VPU_RC;
}

// The dynamic shared memory each vpu_* pair launch reserves, by SymMath:
// 0, but while nbt_sym_abl_pin holds the form at its control's CTAs per
// SM.  No kernel reads it.
static int abl_dyn_smem[VPU_RC + 1] = {};

template <int M>
static int launch_pairs(const float* pos, const float* mass, long long n,
                        long long nb, long long d_lo, long long dc,
                        float eps2, float* si, float* sj, void* stream) {
    if (dc <= 0) return 0;
    sym_pairs_kernel<M><<<(unsigned)(nb * dc), SYM_TILE,
                           sym_ablation(M) ? abl_dyn_smem[M] : 0,
                           (cudaStream_t)stream>>>(pos, mass, n, nb, d_lo,
                                                   eps2, si, sj);
    return (int)cudaGetLastError();
}

template <bool K7>
static int launch_reduce(const float* pos, const float* mass, long long n,
                         long long nb, long long d_lo, long long dc,
                         const float* si, const float* sj, float* raw,
                         int first, int last, float eps2, float* out,
                         void* stream) {
    sym_reduce_kernel<K7><<<(unsigned)nb, SYM_TILE, 0,
                            (cudaStream_t)stream>>>(
        pos, mass, n, nb, d_lo, dc, si, sj, raw, first, last, eps2, out);
    return (int)cudaGetLastError();
}

// The pair and reduce passes of K2 (nbt_sym_*) and of K7 (nbt_sym_vpu_*),
// with one signature each.
extern "C" int nbt_sym_pairs(const float* pos, const float* mass,
                             long long n, long long nb, long long d_lo,
                             long long dc, float eps2, float* si, float* sj,
                             void* stream) {
    return launch_pairs<SYM_K2>(pos, mass, n, nb, d_lo, dc, eps2, si, sj,
                                stream);
}

extern "C" int nbt_sym_reduce(const float* pos, const float* mass,
                              long long n, long long nb, long long d_lo,
                              long long dc, const float* si, const float* sj,
                              float* raw, int first, int last, float eps2,
                              float* out, void* stream) {
    return launch_reduce<false>(pos, mass, n, nb, d_lo, dc, si, sj, raw,
                                first, last, eps2, out, stream);
}

extern "C" int nbt_sym_vpu_pairs(const float* pos, const float* mass,
                                 long long n, long long nb, long long d_lo,
                                 long long dc, float eps2, float* si,
                                 float* sj, void* stream) {
    return launch_pairs<SYM_K7>(pos, mass, n, nb, d_lo, dc, eps2, si, sj,
                                stream);
}

extern "C" int nbt_sym_vpu_reduce(const float* pos, const float* mass,
                                  long long n, long long nb, long long d_lo,
                                  long long dc, const float* si,
                                  const float* sj, float* raw, int first,
                                  int last, float eps2, float* out,
                                  void* stream) {
    return launch_reduce<true>(pos, mass, n, nb, d_lo, dc, si, sj, raw,
                               first, last, eps2, out, stream);
}

// ---------------------------------------------------------------------
// K14d: the fold schedule (nbody_tpu/ops/forces_pallas_sym.py:
// _make_sym_kernel_fold, variants "vpu2" and "vpu"), K2's and K7's math on
// superblocks of u = sub * SYM_TILE bodies.  nb counts superblocks here.
// A work item is (superblock I, circular superblock offset d): the sub row
// tiles of I against the sub column tiles of J = (I + d) mod nb.  Offsets
// are superblock offsets, so there are sub times fewer of them, and fewer
// slots, than in the classic sweep; halving, chunks and the fixed-order
// reduce are K2's, with superblocks for tiles.
//
// One item runs on a thread-block cluster of sub CTAs (fold_item).  CTA
// rank r runs the pair tile, sym_pair_core with K2's or K7's math, of row
// tile r against the column tiles c = 0 .. sub-1 in turn: row tile r's
// sums are the tiles' row sums added in column-tile order, written once to
// its i-side slot.  The rank keeps its sub column partials and, after the
// last tile, puts them in its SymPairSmem::part; after a cluster barrier
// rank c reads column tile c's partials of ranks 0 .. sub-1 through
// distributed shared memory, adds them in row-tile order and writes the
// tile's one j-side slot (negated).  This is the JAX fold's grouping
// (acc_i_ref[row] += ai a row tile, jsc_ref += aj across si).  A second
// cluster barrier keeps every CTA until its partials have been read.
// Where the items alone fill the card's CTA slots (at N = 1,048,576), one
// CTA takes an item instead and runs its row tiles in turn, folding the
// column partials in row-tile order: the same bits, without the clusters'
// cost there (fold_ctas).
//
// The diagonal superblocks are one-sided exact over their u bodies (m_j
// weights), as _diag_call does at block_u = u: fold_diag_kernel runs K1's
// one-sided tile (onesided_rows, onesided_tile.cuh) with FOLD_DIAG_R rows
// a lane and the superblock's columns split among the eight warps, the
// warps' partials added in warp order; the reduce's last chunk adds them.
// K2's math recomputes a real massless row one-sided over all N bodies
// there, since its mass-scaled slots cannot be descaled.
//
// What bounds it on the card: FP32 FMA and MUFU issue, as K2 (17 issue
// slots a pair on the pair tile).  At N = 8192 (U = 1024) the clusters
// launch 112 CTAs where one CTA an item launched 28 on 132 SMs: on an
// H100 80GB HBM3 at 700 W the card takes 0.0435 ms an evaluation with
// K2's math (0.0448 with K7's) against 0.2038 (0.1918) before, and 0.1167
// with one CTA an item.  At N = 1,048,576 one CTA an item takes 375.6 ms
// (396.2) against 502.7 (502.4), 370.7 of it the pair passes, 1.3% under
// K2's on the same tile with a quarter of the slot bytes; a cluster an
// item took 423.2 there (chip_smoke.py check_redesign and
// tools/fold_variants.py).  The pair kernels take 126 / 123 registers
// (two CTAs an SM) and a 96-byte stack frame for the column partials.

#define FOLD_SUB_MAX 8
static_assert(FOLD_SUB_MAX <= SYM_WARPS,
              "a rank's column partials must fit in SymPairSmem::part");

// One fold item, called by every thread of the item's CTAs: the sub row
// tiles at i0 of (pos_r, mass_r) against the sub column tiles at j0 of
// (pos_c, mass_c), on one CTA (ctas = 1) or a cluster of ctas = sub, rank
// q taking row tile q.  Row tile r's sums go to si_rows[r * SYM_TILE + t],
// column tile c's negated sums to sj_cols[c * SYM_TILE + t] (three floats
// a body).  Either way column tile c's sum is 0 + cs(0, c) + cs(1, c) +
// ... in row-tile order, so the two give the same bits.
template <int M>
__device__ __forceinline__ void fold_item(
        const float* pos_r, const float* __restrict__ mass_r, long long n_r,
        long long i0, const float* pos_c, const float* __restrict__ mass_c,
        long long n_c, long long j0, int sub, int ctas, float eps2,
        float* __restrict__ si_rows, float* __restrict__ sj_cols,
        SymPairSmem& sm) {
    const int q = ctas > 1 ? (int)cg::this_cluster().block_rank() : 0;
    const int t = threadIdx.x;
    float3 col[FOLD_SUB_MAX];                 // column t of each column tile
    for (int c = 0; c < sub; ++c) col[c] = make_float3(0.f, 0.f, 0.f);
    for (int r = q; r < sub; r += ctas) {
        float3 row = make_float3(0.f, 0.f, 0.f);
        for (int c = 0; c < sub; ++c) {
            float3 rs, cs;
            sym_pair_core<M>(pos_r, mass_r, i0 + r * SYM_TILE + t, n_r,
                             pos_c, mass_c, j0 + c * SYM_TILE + t, n_c, eps2,
                             sm, rs, cs);
            row.x += rs.x;
            row.y += rs.y;
            row.z += rs.z;
            col[c].x += cs.x;
            col[c].y += cs.y;
            col[c].z += cs.z;
        }
        float* si_t = si_rows + 3 * (r * SYM_TILE + t);
        si_t[0] = row.x;
        si_t[1] = row.y;
        si_t[2] = row.z;
    }
    if (ctas == 1) {
        for (int c = 0; c < sub; ++c) {
            float* sj_t = sj_cols + 3 * (c * SYM_TILE + t);
            sj_t[0] = -col[c].x;
            sj_t[1] = -col[c].y;
            sj_t[2] = -col[c].z;
        }
        return;
    }
    // Thread t reads and writes floats 3t .. 3t+2 of part's rows only, as
    // at the end of sym_pair_core, so no block barrier is needed here.
    for (int c = 0; c < sub; ++c) {
        sm.part[c][3 * t] = col[c].x;
        sm.part[c][3 * t + 1] = col[c].y;
        sm.part[c][3 * t + 2] = col[c].z;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                           // every rank's partials are in
    float3 s = make_float3(0.f, 0.f, 0.f);
    for (int k = 0; k < ctas; ++k) {
        const float* p = cluster.map_shared_rank(sm.part[q], k) + 3 * t;
        s.x += p[0];
        s.y += p[1];
        s.z += p[2];
    }
    float* sj_t = sj_cols + 3 * (q * SYM_TILE + t);
    sj_t[0] = -s.x;
    sj_t[1] = -s.y;
    sj_t[2] = -s.z;
    cluster.sync();                           // no rank leaves while read
}

// One item per (superblock I, offset d) of the chunk d = d_lo ..
// d_lo+dc-1, on ctas CTAs; the slots are K2's with superblocks for tiles.
template <int M>
__global__ void __launch_bounds__(SYM_TILE)
sym_fold_pairs_kernel(const float* __restrict__ pos,
                      const float* __restrict__ mass, long long n,
                      long long nb, long long d_lo, float eps2, int sub,
                      int ctas, float* __restrict__ si,
                      float* __restrict__ sj) {
    __shared__ SymPairSmem sm;
    const long long item = blockIdx.x / ctas;
    const long long dk = item / nb;
    const long long I = item - dk * nb;
    const long long d = d_lo + dk;
    if (2 * d == nb && 2 * I >= nb) return;   // even nb: half offset
    const long long J = (I + d) % nb;
    const long long u = (long long)sub * SYM_TILE;
    const long long slot = dk * nb * u * 3;
    fold_item<M>(pos, mass, n, I * u, pos, mass, n, J * u, sub, ctas, eps2,
                 si + slot + 3 * I * u, sj + slot + 3 * J * u, sm);
}

// How a fold pass spreads its items (nbt_sym_fold_mode).  FOLD_AUTO takes
// a cluster of sub CTAs an item where one CTA an item would leave some of
// the card's CTA slots empty (fewer items than SMs times the kernel's CTAs
// an SM: 28 items at N = 8192, U = 1024), else one CTA an item (at N =
// 1,048,576 the clusters took 11-13% longer on an H100: PERF.md §6).
// The two give the same bits; FOLD_CLUSTER and FOLD_CTA force one, for
// timing and checks.
enum FoldMode { FOLD_AUTO = 0, FOLD_CLUSTER = 1, FOLD_CTA = 2 };
static int fold_mode = FOLD_AUTO;

// CTAs of `kernel` an SM, or minus the error of a failed query.
template <typename K>
static int fold_per_sm(K kernel) {
    int per_sm = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, SYM_TILE, 0);
    return err != cudaSuccess ? -(int)err : per_sm;
}

// Launches `kernel` with `args` on `items` fold items of ctas CTAs, each
// item a cluster where ctas > 1.  A refused launch returns its error;
// nothing falls back.
template <typename... Exp, typename... Act>
static int launch_fold(long long items, int ctas, void* stream,
                       void (*kernel)(Exp...), Act&&... args) {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = (unsigned)ctas;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(items * ctas));
    cfg.blockDim = dim3(SYM_TILE);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
    const cudaError_t last = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : last);
}

// The CTAs an item of `kernel` takes under fold_mode: sub or 1, or minus
// the error of a failed query of the card.
template <typename K>
static int fold_ctas(K kernel, long long items, int sub) {
    if (fold_mode == FOLD_CLUSTER) return sub;
    if (fold_mode == FOLD_CTA) return 1;
    const int per_sm = fold_per_sm(kernel);
    if (per_sm < 0) return per_sm;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return -(int)err;
    return items < (long long)sms * per_sm ? sub : 1;
}

// Rows a lane holds in fold_diag_kernel, and rows a CTA takes.
#define FOLD_DIAG_R 2
#define FOLD_DIAG_ROWS (32 * FOLD_DIAG_R)

// The diagonal superblocks: CTA k takes rows k * FOLD_DIAG_ROWS .. of
// superblock I (lane l rows l + 32 r, r < FOLD_DIAG_R, in registers) and
// warp w the u / SYM_WARPS columns from I * u + w * u / SYM_WARPS, in
// column order; the warps' partials are added in warp order.  Writes row
// b's one-sided sum over I's u bodies to diag[b] for b < n.
__global__ void __launch_bounds__(SYM_TILE)
fold_diag_kernel(const float* __restrict__ pos,
                 const float* __restrict__ mass, long long n, int sub,
                 float eps2, float* __restrict__ diag) {
    __shared__ float4 cols[FOLD_SUB_MAX * SYM_TILE];
    __shared__ float4 rows[FOLD_DIAG_ROWS];
    __shared__ float part[SYM_WARPS][FOLD_DIAG_ROWS * 3];
    const long long u = (long long)sub * SYM_TILE;
    const long long b0 = (long long)blockIdx.x * FOLD_DIAG_ROWS;
    const long long base = b0 / u * u;
    const int t = threadIdx.x;
    const int w = t >> 5;
    const int l = t & 31;
    for (int k = t; k < u; k += SYM_TILE)
        cols[k] = load_body(pos, mass, base + k, n);
    if (t < FOLD_DIAG_ROWS) rows[t] = load_body(pos, mass, b0 + t, n);
    __syncthreads();

    float4 br[FOLD_DIAG_R];
    float ax[FOLD_DIAG_R], ay[FOLD_DIAG_R], az[FOLD_DIAG_R];
#pragma unroll
    for (int r = 0; r < FOLD_DIAG_R; ++r) {
        br[r] = rows[l + 32 * r];
        ax[r] = 0.f;
        ay[r] = 0.f;
        az[r] = 0.f;
    }
    const int wcols = sub * (SYM_TILE / SYM_WARPS);
    onesided_rows<W_MJ, FOLD_DIAG_R>(cols + w * wcols, wcols, br, eps2, ax,
                                     ay, az);
#pragma unroll
    for (int r = 0; r < FOLD_DIAG_R; ++r) {
        const int row = l + 32 * r;
        part[w][3 * row] = ax[r];
        part[w][3 * row + 1] = ay[r];
        part[w][3 * row + 2] = az[r];
    }
    __syncthreads();
    const long long b = b0 + t;
    if (t >= FOLD_DIAG_ROWS || b >= n) return;
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int v = 0; v < SYM_WARPS; ++v) {
        sx += part[v][3 * t];
        sy += part[v][3 * t + 1];
        sz += part[v][3 * t + 2];
    }
    diag[3 * b] = sx;
    diag[3 * b + 1] = sy;
    diag[3 * b + 2] = sz;
}

// One thread a body (nb * sub CTAs of SYM_TILE): the chunk's slots of body
// b (superblock I = b / u) added offset by offset, i-side before j-side,
// into the running sum; on the last chunk, the diagonal superblock's sum
// that fold_diag_kernel left in out and, for K2, the 1/m descale (a real
// massless body: its whole row one-sided over all N bodies, rect_finish
// with every body as the other set).
template <bool K7>
__global__ void __launch_bounds__(SYM_TILE)
sym_fold_reduce_kernel(const float* __restrict__ pos,
                       const float* __restrict__ mass, long long n,
                       long long nb, long long d_lo, long long dc,
                       const float* __restrict__ si,
                       const float* __restrict__ sj, float* __restrict__ raw,
                       int first, int last, float eps2, int sub,
                       float* __restrict__ out) {
    const long long u = (long long)sub * SYM_TILE;
    const long long n_pad = nb * u;
    const long long b = (long long)blockIdx.x * SYM_TILE + threadIdx.x;
    const long long I = b / u;

    float3 s = first ? make_float3(0.f, 0.f, 0.f)
                     : make_float3(raw[3 * b], raw[3 * b + 1], raw[3 * b + 2]);
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
    if (!last) {
        raw[3 * b] = s.x;
        raw[3 * b + 1] = s.y;
        raw[3 * b + 2] = s.z;
        return;
    }
    if (b >= n) return;
    const float3 d = make_float3(out[3 * b], out[3 * b + 1], out[3 * b + 2]);
    float3 a;
    if (K7)
        a = make_float3(d.x + s.x, d.y + s.y, d.z + s.z);
    else if (mass[b] == 0.f)
        a = rect_finish(s, 0.f, load_body(pos, mass, b, n), pos, mass, n, 1,
                        eps2);
    else
        a = sym_descale(d, s, mass[b]);
    out[3 * b] = a.x;
    out[3 * b + 1] = a.y;
    out[3 * b + 2] = a.z;
}

template <int M>
static int launch_fold_pairs(const float* pos, const float* mass,
                             long long n, long long nb, long long d_lo,
                             long long dc, float eps2, float* si, float* sj,
                             int sub, void* stream) {
    if (sub < 1 || sub > FOLD_SUB_MAX) return (int)cudaErrorInvalidValue;
    if (dc <= 0) return 0;
    const int ctas = fold_ctas(sym_fold_pairs_kernel<M>, nb * dc, sub);
    if (ctas < 0) return -ctas;
    return launch_fold(nb * dc, ctas, stream, sym_fold_pairs_kernel<M>, pos,
                       mass, n, nb, d_lo, eps2, sub, ctas, si, sj);
}

template <bool K7>
static int launch_fold_reduce(const float* pos, const float* mass,
                              long long n, long long nb, long long d_lo,
                              long long dc, const float* si, const float* sj,
                              float* raw, int first, int last, float eps2,
                              float* out, int sub, void* stream) {
    if (sub < 1 || sub > FOLD_SUB_MAX) return (int)cudaErrorInvalidValue;
    if (last) {
        fold_diag_kernel<<<(unsigned)((n + FOLD_DIAG_ROWS - 1)
                                      / FOLD_DIAG_ROWS),
                           SYM_TILE, 0, (cudaStream_t)stream>>>(
            pos, mass, n, sub, eps2, out);
        const int err = (int)cudaGetLastError();
        if (err) return err;
    }
    sym_fold_reduce_kernel<K7><<<(unsigned)(nb * sub), SYM_TILE, 0,
                                 (cudaStream_t)stream>>>(
        pos, mass, n, nb, d_lo, dc, si, sj, raw, first, last, eps2, sub,
        out);
    return (int)cudaGetLastError();
}

// The fold schedule's pair and reduce passes for K2's math (nbt_sym_fold_*)
// and K7's (nbt_sym_vpu_fold_*): K2's signatures, nb in superblocks, plus
// the superblock's row-tile count sub.
extern "C" int nbt_sym_fold_pairs(const float* pos, const float* mass,
                                  long long n, long long nb, long long d_lo,
                                  long long dc, float eps2, float* si,
                                  float* sj, int sub, void* stream) {
    return launch_fold_pairs<SYM_K2>(pos, mass, n, nb, d_lo, dc, eps2, si,
                                     sj, sub, stream);
}

extern "C" int nbt_sym_fold_reduce(const float* pos, const float* mass,
                                   long long n, long long nb, long long d_lo,
                                   long long dc, const float* si,
                                   const float* sj, float* raw, int first,
                                   int last, float eps2, float* out, int sub,
                                   void* stream) {
    return launch_fold_reduce<false>(pos, mass, n, nb, d_lo, dc, si, sj, raw,
                                     first, last, eps2, out, sub, stream);
}

extern "C" int nbt_sym_vpu_fold_pairs(const float* pos, const float* mass,
                                      long long n, long long nb,
                                      long long d_lo, long long dc,
                                      float eps2, float* si, float* sj,
                                      int sub, void* stream) {
    return launch_fold_pairs<SYM_K7>(pos, mass, n, nb, d_lo, dc, eps2, si,
                                     sj, sub, stream);
}

extern "C" int nbt_sym_vpu_fold_reduce(const float* pos, const float* mass,
                                       long long n, long long nb,
                                       long long d_lo, long long dc,
                                       const float* si, const float* sj,
                                       float* raw, int first, int last,
                                       float eps2, float* out, int sub,
                                       void* stream) {
    return launch_fold_reduce<true>(pos, mass, n, nb, d_lo, dc, si, sj, raw,
                                    first, last, eps2, out, sub, stream);
}

// ---------------------------------------------------------------------
// K2-rect with K2's and K7's math (nbody_tpu/ops/forces_pallas_sym.py:
// _make_rect_kernel variants "vpu2" and "vpu", and _make_rect_kernel_fold),
// launched once per column chunk by _rect_call's counterpart in
// ops/forces_sym.py.  One work item per (row superblock IA of A, column
// superblock JB of B), superblocks of u = sub * SYM_TILE bodies: sub = 1 is
// the classic rect sweep, sub > 1 the fold schedule (JAX's rect fold: the
// A superblock's row tiles sweep the sub column tiles of JB, the column
// sums fold across the row tiles, in row-tile order, into one j-side slot
// write per (IA, JB)).  The classic sweep runs the pair tile,
// sym_pair_core, with K2's math (vpu2, rect_k2_pairs_kernel) or K7's (vpu,
// rect_k7_pairs_kernel): eight rows a lane in registers, one shared load
// and three shuffles for every eight pairs, d2 as three FMAs,
// rsqrt_normal; the row partials added in warp order, so the tile is
// bit-reproducible.  The folds run K14d's fold_item on the same tile, one
// item a cluster of sub CTAs (rect_fold_pairs_kernel).  Slots, chunks and
// the reduce pass are in rect_common.cuh.  The work is the square sweep's
// without the diagonal: FP32 FMA and MUFU issue bound, 23 (K2) or 26 (K7)
// flops a pair.  On an H100 80GB HBM3 at 700 W the vpu2 sweep of the 1M
// ring's 262,144 x 262,144 shard pair takes 49.1 ms (17.5 slots a pair at
// 73% of the issue rate, as K2; 65.7 ms on sym_tile_core), at 80
// registers, no spill, three CTAs an SM, and the 4-shard ring's step 425.6
// ms against 491.6 (chip_smoke.py).  At validate --shards 4's 2048 x 2048
// (64 CTAs on 132 SMs) the card takes 0.0137 ms a sweep against 0.0151;
// the host's launch path, ~0.03 ms, is the rest.  The vpu sweep takes 50.0
// ms at 262,144 x 262,144 (66.2 on sym_tile_core) and 0.0141 ms of the
// card's time at 2048 x 2048 (0.0148).
//
// K15's rect vpu_* forms run the pair tile below: vpu_noj
// rect_noj_pairs_kernel (A's row slots only, K2-rect vpu's bit for bit),
// vpu_rc rect_rc_pairs_kernel, and vpu_fix0 K2-rect vpu's classic kernel
// itself, rect_k7_pairs_kernel, since a column slot here is the writer's
// own (IA, JB) already; only fix0's reduce, which adds every column slot
// into B's superblock 0, is its own.

// K2-rect's classic sweep (sub = 1) on the pair tile, K2's math (vpu2),
// K7's (vpu) or K15's vpu_rc / vpu_noj: CTA (IA, JB) runs sym_pair_core
// with row tile IA of A and column tile JB of B, and writes its row sums
// and (but for VPU_NOJ) its negated column sums to the slots above.
template <int M>
__device__ __forceinline__ void rect_pair_tile(
        const float* __restrict__ pos_a, const float* __restrict__ mass_a,
        long long na, const float* __restrict__ pos_b,
        const float* __restrict__ mass_b, long long nb, long long na_s,
        long long j_lo, long long jc, float eps2, float* __restrict__ si,
        float* __restrict__ sj) {
    __shared__ SymPairSmem sm;
    const long long bid = blockIdx.x;
    const long long jk = bid / na_s;
    const long long IA = bid - jk * na_s;
    const int t = threadIdx.x;
    const long long i = IA * SYM_TILE + t;
    float3 rs, cs;
    sym_pair_core<M>(pos_a, mass_a, i, na, pos_b, mass_b,
                     (j_lo + jk) * SYM_TILE + t, nb, eps2, sm, rs, cs);
    const long long o = (jk * na_s * SYM_TILE + i) * 3;
    si[o] = rs.x;
    si[o + 1] = rs.y;
    si[o + 2] = rs.z;
    if constexpr (M == VPU_NOJ) return;
    const long long oj = ((IA * jc + jk) * SYM_TILE + t) * 3;
    sj[oj] = -cs.x;
    sj[oj + 1] = -cs.y;
    sj[oj + 2] = -cs.z;
}

// K2-rect vpu2's classic sweep.
__global__ void __launch_bounds__(SYM_TILE)
rect_k2_pairs_kernel(const float* __restrict__ pos_a,
                     const float* __restrict__ mass_a, long long na,
                     const float* __restrict__ pos_b,
                     const float* __restrict__ mass_b, long long nb,
                     long long na_s, long long j_lo, long long jc,
                     float eps2, float* __restrict__ si,
                     float* __restrict__ sj) {
    rect_pair_tile<SYM_K2>(pos_a, mass_a, na, pos_b, mass_b, nb, na_s, j_lo,
                           jc, eps2, si, sj);
}

// K2-rect vpu's classic sweep.
__global__ void __launch_bounds__(SYM_TILE)
rect_k7_pairs_kernel(const float* __restrict__ pos_a,
                     const float* __restrict__ mass_a, long long na,
                     const float* __restrict__ pos_b,
                     const float* __restrict__ mass_b, long long nb,
                     long long na_s, long long j_lo, long long jc,
                     float eps2, float* __restrict__ si,
                     float* __restrict__ sj) {
    rect_pair_tile<SYM_K7>(pos_a, mass_a, na, pos_b, mass_b, nb, na_s, j_lo,
                           jc, eps2, si, sj);
}

// K15's rect vpu_rc: K2-rect vpu's classic sweep with the differences
// recomputed for the accumulate (K2-rect vpu's bits on both sides).
__global__ void __launch_bounds__(SYM_TILE)
rect_rc_pairs_kernel(const float* __restrict__ pos_a,
                     const float* __restrict__ mass_a, long long na,
                     const float* __restrict__ pos_b,
                     const float* __restrict__ mass_b, long long nb,
                     long long na_s, long long j_lo, long long jc,
                     float eps2, float* __restrict__ si,
                     float* __restrict__ sj) {
    rect_pair_tile<VPU_RC>(pos_a, mass_a, na, pos_b, mass_b, nb, na_s, j_lo,
                           jc, eps2, si, sj);
}

// K15's rect vpu_noj: K2-rect vpu's classic sweep, A's row sums only (K2-rect
// vpu's row slots bit for bit); B's slots are not written.
__global__ void __launch_bounds__(SYM_TILE)
rect_noj_pairs_kernel(const float* __restrict__ pos_a,
                      const float* __restrict__ mass_a, long long na,
                      const float* __restrict__ pos_b,
                      const float* __restrict__ mass_b, long long nb,
                      long long na_s, long long j_lo, long long jc,
                      float eps2, float* __restrict__ si,
                      float* __restrict__ sj) {
    rect_pair_tile<VPU_NOJ>(pos_a, mass_a, na, pos_b, mass_b, nb, na_s, j_lo,
                            jc, eps2, si, sj);
}

// The rect folds: one cluster of sub CTAs per (IA, JB) of the chunk (jk =
// JB - j_lo), K14d's fold_item on rect_common.cuh's slots.
template <int M>
__global__ void __launch_bounds__(SYM_TILE)
rect_fold_pairs_kernel(const float* __restrict__ pos_a,
                       const float* __restrict__ mass_a, long long na,
                       const float* __restrict__ pos_b,
                       const float* __restrict__ mass_b, long long nb,
                       long long na_s, long long j_lo, long long jc,
                       float eps2, int sub, int ctas,
                       float* __restrict__ si, float* __restrict__ sj) {
    __shared__ SymPairSmem sm;
    const long long item = blockIdx.x / ctas;
    const long long jk = item / na_s;
    const long long IA = item - jk * na_s;
    const long long u = (long long)sub * SYM_TILE;
    fold_item<M>(pos_a, mass_a, na, IA * u, pos_b, mass_b, nb,
                 (j_lo + jk) * u, sub, ctas, eps2,
                 si + (jk * na_s * u + IA * u) * 3,
                 sj + (IA * jc + jk) * u * 3, sm);
}

// The rect pair passes with K2's math (nbt_rect_sym_pairs) and K7's
// (nbt_rect_sym_vpu_pairs): the pair tile at sub = 1 (classic), the
// cluster fold at sub > 1.
template <int M>
static int launch_rect_sym_pairs(const float* pos_a, const float* mass_a,
                                 long long na, const float* pos_b,
                                 const float* mass_b, long long nb,
                                 long long na_s, long long j_lo, long long jc,
                                 float eps2, int sub, float* si, float* sj,
                                 void* stream) {
    if (sub < 1 || sub > FOLD_SUB_MAX) return (int)cudaErrorInvalidValue;
    if (jc <= 0 || na_s <= 0) return 0;
    if (sub > 1) {
        const int ctas = fold_ctas(rect_fold_pairs_kernel<M>, na_s * jc, sub);
        if (ctas < 0) return -ctas;
        return launch_fold(na_s * jc, ctas, stream, rect_fold_pairs_kernel<M>,
                           pos_a, mass_a, na, pos_b, mass_b, nb, na_s, j_lo,
                           jc, eps2, sub, ctas, si, sj);
    }
    const unsigned grid = (unsigned)(na_s * jc);
    if (M == SYM_K2)
        rect_k2_pairs_kernel<<<grid, SYM_TILE, 0, (cudaStream_t)stream>>>(
            pos_a, mass_a, na, pos_b, mass_b, nb, na_s, j_lo, jc, eps2, si,
            sj);
    else
        rect_k7_pairs_kernel<<<grid, SYM_TILE, 0, (cudaStream_t)stream>>>(
            pos_a, mass_a, na, pos_b, mass_b, nb, na_s, j_lo, jc, eps2, si,
            sj);
    return (int)cudaGetLastError();
}

extern "C" int nbt_rect_sym_pairs(const float* pos_a, const float* mass_a,
                                  long long na, const float* pos_b,
                                  const float* mass_b, long long nb,
                                  long long na_s, long long j_lo,
                                  long long jc, float eps2, int sub,
                                  float* si, float* sj, void* stream) {
    return launch_rect_sym_pairs<SYM_K2>(pos_a, mass_a, na, pos_b, mass_b,
                                         nb, na_s, j_lo, jc, eps2, sub, si,
                                         sj, stream);
}

extern "C" int nbt_rect_sym_vpu_pairs(const float* pos_a,
                                      const float* mass_a, long long na,
                                      const float* pos_b,
                                      const float* mass_b, long long nb,
                                      long long na_s, long long j_lo,
                                      long long jc, float eps2, int sub,
                                      float* si, float* sj, void* stream) {
    return launch_rect_sym_pairs<SYM_K7>(pos_a, mass_a, na, pos_b, mass_b,
                                         nb, na_s, j_lo, jc, eps2, sub, si,
                                         sj, stream);
}

// The rect reduce pass (rect_common.cuh); descale for K2's mass-scaled
// sums.
extern "C" int nbt_rect_reduce(const float* pos_a, const float* mass_a,
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

// ---------------------------------------------------------------------
// K15: the bench-only ablations (nbody_tpu/ops/ablation_sym.py: _make_tri
// and _make_rect, launched through _sym_call and _rect_call once
// ablation_sym.enable() has registered them).  Each prices one mechanism
// of the production tiles; four of the seven compute wrong physics on
// purpose, and none is reachable from run, validate or bench.  The pair
// passes are K7's (vpu_*, above) and K5's (tmm_*, forces_sym_tc.cu) on
// the classic schedule; the diagonal tiles stay exact and one-sided, as
// JAX's _diag_call.  The vpu_* forms ablate K7's pair tile and are timed
// against K7, the tmm_* forms against K5.  vpu_noj, K7's row side alone,
// is FP32 issue bound as K7 is: 13.28 issue slots a pair against K7's
// 17.69, at 79 registers and K7's three CTAs an SM; on an H100 80GB HBM3
// at 700 W it takes 298.5 ms at N = 1,048,576 against K7's 405.1, so the
// j side is 26% of K7 (chip_smoke.py check_redesign).  How each one's
// j-side sums reach the bodies:
//   slots  K7's and K5's own slot sum (vpu_rc, tmm_full);
//   none   no j-side sums: the reduce reads the row slots only (vpu_noj,
//          tmm_noj, tmm_nomm; in the rect sweep B gets 0);
//   fix0   every column sum lands on tile 0's (B's superblock 0's) bodies,
//          lane by lane, as JAX's acc_jT[0] += ... does (vpu_fix0,
//          tmm_noscat).  JAX adds into slot 0 one grid step at a time; the
//          card has no sequential grid, so each CTA keeps one writer per
//          slot (its own row slot sj[d][I] in the square sweep, its own
//          (IA, JB) slot in the rect sweep), and the reduce adds the slots
//          in a fixed order: per offset (per column superblock), the sum
//          over row tiles first, so results are bit-reproducible and the
//          same for any chunking.

// The vpu_* pair passes, K7's signature.
#define ABL_SYM_PAIRS(NAME, M)                                               \
    extern "C" int NAME(const float* pos, const float* mass, long long n,    \
                        long long nb, long long d_lo, long long dc,          \
                        float eps2, float* si, float* sj, void* stream) {    \
        return launch_pairs<M>(pos, mass, n, nb, d_lo, dc, eps2, si, sj,     \
                               stream);                                      \
    }
ABL_SYM_PAIRS(nbt_sym_vpu_noj_pairs, VPU_NOJ)
ABL_SYM_PAIRS(nbt_sym_vpu_fix0_pairs, VPU_FIX0)
ABL_SYM_PAIRS(nbt_sym_vpu_rc_pairs, VPU_RC)

// vpu_rc's and vpu_noj's rect pair passes: kernel K, one CTA a tile pair.
using RectTileKernel = void (*)(const float*, const float*, long long,
                                const float*, const float*, long long,
                                long long, long long, long long, float,
                                float*, float*);
template <RectTileKernel K>
static int launch_rect_tile(const float* pos_a, const float* mass_a,
                            long long na, const float* pos_b,
                            const float* mass_b, long long nb, long long na_s,
                            long long j_lo, long long jc, float eps2,
                            float* si, float* sj, void* stream) {
    if (jc <= 0 || na_s <= 0) return 0;
    K<<<(unsigned)(na_s * jc), SYM_TILE, 0, (cudaStream_t)stream>>>(
        pos_a, mass_a, na, pos_b, mass_b, nb, na_s, j_lo, jc, eps2, si, sj);
    return (int)cudaGetLastError();
}

// vpu_fix0's is K2-rect vpu's classic sweep itself.
static int launch_rect_fix0(const float* pos_a, const float* mass_a,
                            long long na, const float* pos_b,
                            const float* mass_b, long long nb,
                            long long na_s, long long j_lo, long long jc,
                            float eps2, float* si, float* sj, void* stream) {
    return launch_rect_sym_pairs<SYM_K7>(pos_a, mass_a, na, pos_b, mass_b,
                                         nb, na_s, j_lo, jc, eps2, 1, si, sj,
                                         stream);
}

#define ABL_RECT_PAIRS(NAME, LAUNCH)                                         \
    extern "C" int NAME(const float* pos_a, const float* mass_a,             \
                        long long na, const float* pos_b,                    \
                        const float* mass_b, long long nb, long long na_s,   \
                        long long j_lo, long long jc, float eps2, float* si, \
                        float* sj, void* stream) {                           \
        return LAUNCH(pos_a, mass_a, na, pos_b, mass_b, nb, na_s, j_lo, jc,  \
                      eps2, si, sj, stream);                                 \
    }
ABL_RECT_PAIRS(nbt_rect_vpu_noj_pairs,
               launch_rect_tile<rect_noj_pairs_kernel>)
ABL_RECT_PAIRS(nbt_rect_vpu_fix0_pairs, launch_rect_fix0)
ABL_RECT_PAIRS(nbt_rect_vpu_rc_pairs, launch_rect_tile<rect_rc_pairs_kernel>)

// The occupancy pin, a knob for timing the split only.  An ablation that
// takes fewer registers than its control fits more CTAs on an SM, and a
// time taken that way prices the residency with the mechanism the
// ablation removes.  The control of all three vpu_* forms is K7
// (sym_pairs_kernel<SYM_K7>).  nbt_sym_abl_pin(1) finds for
// each form the least dynamic shared memory, in 256-byte steps, at which
// its pair kernel runs exactly its control's CTAs per SM, holds those for
// their launches and returns the largest (-1, all unpinned, if a form has
// none); nbt_sym_abl_pin(0) unpins.  nbt_sym_pairs_ctas(m) is the CTAs
// per SM of the pair kernel of SymMath m as it launches now.
// An ablation's launch at more than 48 KB of shared memory in all needs
// the opt-in, which pairs_ctas sets to the bytes it asks about.
template <int M>
static int pairs_ctas(int dyn) {
    int ctas = -1;
    if (sym_ablation(M) &&
        cudaFuncSetAttribute(sym_pairs_kernel<M>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn) != cudaSuccess)
        return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &ctas, sym_pairs_kernel<M>, SYM_TILE, (size_t)dyn) != cudaSuccess)
        return -1;
    return ctas;
}

extern "C" int nbt_sym_pairs_ctas(int m) {
    const int dyn = sym_ablation(m) ? abl_dyn_smem[m] : 0;
    switch (m) {
        case SYM_K7: return pairs_ctas<SYM_K7>(dyn);
        case VPU_NOJ: return pairs_ctas<VPU_NOJ>(dyn);
        case VPU_FIX0: return pairs_ctas<VPU_FIX0>(dyn);
        case VPU_RC: return pairs_ctas<VPU_RC>(dyn);
    }
    return -1;
}

// The least dynamic shared memory at which form M runs exactly control
// C's CTAs per SM, or -1.
template <int M, int C>
static int pin_dyn() {
    const int want = pairs_ctas<C>(0);
    for (int dyn = 0; dyn <= 96 * 1024; dyn += 256) {
        const int ctas = pairs_ctas<M>(dyn);
        if (ctas > want) continue;
        return (want >= 1 && ctas == want) ? dyn : -1;
    }
    return -1;
}

extern "C" int nbt_sym_abl_pin(int on) {
    for (int& dyn : abl_dyn_smem) dyn = 0;
    if (!on) return 0;
    const int fix0 = pin_dyn<VPU_FIX0, SYM_K7>();
    const int rc = pin_dyn<VPU_RC, SYM_K7>();
    const int noj = pin_dyn<VPU_NOJ, SYM_K7>();
    if (fix0 < 0 || rc < 0 || noj < 0) return -1;
    abl_dyn_smem[VPU_FIX0] = fix0;
    abl_dyn_smem[VPU_RC] = rc;
    abl_dyn_smem[VPU_NOJ] = noj;
    return std::max(fix0, std::max(rc, noj));
}

enum AblJ { ABL_NONE = 0, ABL_FIX0 = 1 };

// fix0, square sweep: for each offset dk of the chunk, the column slots of
// all its writers (row tiles I; the rows I < nb/2 at an even nb's half
// offset) summed per component into the slot of writer 0, in place.  A
// block takes 32 of the 768 (lane, component) columns of one offset; warp
// w sums the writers I = w, w + 8, ..., and the eight warp sums are added
// in warp order.
__global__ void __launch_bounds__(SYM_TILE)
abl_fix0_colsum_kernel(long long nb, long long d_lo, float* sj) {
    __shared__ float part[SYM_WARPS][32];
    const long long dk = blockIdx.x / (3 * SYM_TILE / 32);
    const int c = (int)(blockIdx.x % (3 * SYM_TILE / 32)) * 32
                  + (threadIdx.x & 31);
    const int w = threadIdx.x >> 5;
    const long long writers = (2 * (d_lo + dk) == nb) ? nb / 2 : nb;
    float* slot = sj + dk * nb * SYM_TILE * 3;
    float s = 0.f;
    for (long long I = w; I < writers; I += SYM_WARPS)
        s += slot[I * SYM_TILE * 3 + c];
    part[w][threadIdx.x & 31] = s;
    __syncthreads();
    if (w) return;
    float total = 0.f;
#pragma unroll
    for (int v = 0; v < SYM_WARPS; ++v) total += part[v][threadIdx.x];
    slot[c] = total;
}

// The square sweep's reduce for the none / fix0 ablations: as K7's, with
// the row slots only, and for tile 0's bodies (fix0) each offset's summed
// column slots after its row slot.  Non-mass-scaled sums: the diagonal is
// the exact one-sided tile (sym_diag_tile).
template <int J>
__global__ void __launch_bounds__(SYM_TILE)
abl_reduce_kernel(const float* __restrict__ pos,
                  const float* __restrict__ mass, long long n, long long nb,
                  long long d_lo, long long dc, const float* __restrict__ si,
                  const float* __restrict__ sj, float* __restrict__ raw,
                  int first, int last, float eps2, float* __restrict__ out) {
    __shared__ float4 tile[SYM_TILE];
    const long long I = blockIdx.x;
    const long long b = I * SYM_TILE + threadIdx.x;
    const long long n_pad = nb * SYM_TILE;

    float3 s = first ? make_float3(0.f, 0.f, 0.f)
                     : make_float3(raw[3 * b], raw[3 * b + 1], raw[3 * b + 2]);
    for (long long dk = 0; dk < dc; ++dk) {
        const bool half = 2 * (d_lo + dk) == nb;
        const long long o = (dk * n_pad + b) * 3;
        if (!half || 2 * I < nb) {
            s.x += si[o];
            s.y += si[o + 1];
            s.z += si[o + 2];
        }
        if (J == ABL_FIX0 && I == 0) {
            s.x += sj[o];
            s.y += sj[o + 1];
            s.z += sj[o + 2];
        }
    }
    if (!last) {
        raw[3 * b] = s.x;
        raw[3 * b + 1] = s.y;
        raw[3 * b + 2] = s.z;
        return;
    }
    const float3 d = sym_diag_tile(pos, mass, n, b, eps2, tile);
    if (b < n) {
        out[3 * b] = d.x + s.x;
        out[3 * b + 1] = d.y + s.y;
        out[3 * b + 2] = d.z + s.z;
    }
}

template <int J>
static int launch_abl_reduce(const float* pos, const float* mass, long long n,
                             long long nb, long long d_lo, long long dc,
                             const float* si, const float* sj, float* raw,
                             int first, int last, float eps2, float* out,
                             void* stream) {
    if (J == ABL_FIX0 && dc > 0) {
        abl_fix0_colsum_kernel<<<(unsigned)(dc * (3 * SYM_TILE / 32)),
                                 SYM_TILE, 0, (cudaStream_t)stream>>>(
            nb, d_lo, const_cast<float*>(sj));
        const int err = (int)cudaGetLastError();
        if (err) return err;
    }
    abl_reduce_kernel<J><<<(unsigned)nb, SYM_TILE, 0,
                           (cudaStream_t)stream>>>(
        pos, mass, n, nb, d_lo, dc, si, sj, raw, first, last, eps2, out);
    return (int)cudaGetLastError();
}

// The square reduce passes of the none and fix0 ablations (vpu_* and
// tmm_* alike), K7's reduce signature.
extern "C" int nbt_sym_noj_reduce(const float* pos, const float* mass,
                                  long long n, long long nb, long long d_lo,
                                  long long dc, const float* si,
                                  const float* sj, float* raw, int first,
                                  int last, float eps2, float* out,
                                  void* stream) {
    return launch_abl_reduce<ABL_NONE>(pos, mass, n, nb, d_lo, dc, si, sj,
                                       raw, first, last, eps2, out, stream);
}

extern "C" int nbt_sym_fix0_reduce(const float* pos, const float* mass,
                                   long long n, long long nb, long long d_lo,
                                   long long dc, const float* si,
                                   const float* sj, float* raw, int first,
                                   int last, float eps2, float* out,
                                   void* stream) {
    return launch_abl_reduce<ABL_FIX0>(pos, mass, n, nb, d_lo, dc, si, sj,
                                       raw, first, last, eps2, out, stream);
}

// The rect sweep's reduce for the none / fix0 ablations (classic, u =
// SYM_TILE, sums not mass-scaled).  A's side is rect_reduce_kernel's.
// B's side: none writes 0 for every B body; fix0 sums each column slot
// over the row superblocks, as rect_reduce_kernel does, but stores the sum
// in place in row superblock 0's slot and writes 0 for the bodies outside
// B's superblock 0; abl_rect_fix0_kernel then adds the chunk's column sums
// in column order into superblock 0's bodies, carried in acc_b from chunk
// to chunk.
template <int J>
__global__ void __launch_bounds__(SYM_TILE)
abl_rect_reduce_kernel(long long na, long long nb, long long na_s,
                       long long j_lo, long long jc,
                       const float* __restrict__ si, float* sj,
                       float* __restrict__ raw_a, int first, int last,
                       float* __restrict__ acc_a,
                       float* __restrict__ acc_b) {
    const long long u = SYM_TILE;
    const long long na_pad = na_s * u;
    const long long blk = blockIdx.x;
    if (blk < na_s) {
        const long long i = blk * SYM_TILE + threadIdx.x;
        float3 s = first ? make_float3(0.f, 0.f, 0.f)
                         : make_float3(raw_a[3 * i], raw_a[3 * i + 1],
                                       raw_a[3 * i + 2]);
        for (long long jk = 0; jk < jc; ++jk) {
            const long long o = (jk * na_pad + i) * 3;
            s.x += si[o];
            s.y += si[o + 1];
            s.z += si[o + 2];
        }
        float* dst = last ? acc_a : raw_a;
        if (last && i >= na) return;
        dst[3 * i] = s.x;
        dst[3 * i + 1] = s.y;
        dst[3 * i + 2] = s.z;
        return;
    }
    const long long local = (blk - na_s) * SYM_TILE + threadIdx.x;
    const long long j = j_lo * u + local;
    if (J == ABL_FIX0) {
        float3 s = make_float3(0.f, 0.f, 0.f);
        for (long long IA = 0; IA < na_s; ++IA) {
            const long long o = (IA * jc * u + local) * 3;
            s.x += sj[o];
            s.y += sj[o + 1];
            s.z += sj[o + 2];
        }
        sj[3 * local] = s.x;
        sj[3 * local + 1] = s.y;
        sj[3 * local + 2] = s.z;
    }
    if (j >= nb || (J == ABL_FIX0 && j < u)) return;
    acc_b[3 * j] = 0.f;
    acc_b[3 * j + 1] = 0.f;
    acc_b[3 * j + 2] = 0.f;
}

// fix0, rect sweep: B's superblock 0 body t (t < nb) adds the column sums
// of the chunk's superblocks, in column order, to its running sum.
__global__ void __launch_bounds__(SYM_TILE)
abl_rect_fix0_kernel(long long nb, long long jc, const float* sj, int first,
                     float* __restrict__ acc_b) {
    const long long t = threadIdx.x;
    if (t >= nb) return;
    float3 s = first ? make_float3(0.f, 0.f, 0.f)
                     : make_float3(acc_b[3 * t], acc_b[3 * t + 1],
                                   acc_b[3 * t + 2]);
    for (long long jk = 0; jk < jc; ++jk) {
        const long long o = (jk * SYM_TILE + t) * 3;
        s.x += sj[o];
        s.y += sj[o + 1];
        s.z += sj[o + 2];
    }
    acc_b[3 * t] = s.x;
    acc_b[3 * t + 1] = s.y;
    acc_b[3 * t + 2] = s.z;
}

template <int J>
static int launch_abl_rect_reduce(long long na, long long nb, long long na_s,
                                  long long u, long long j_lo, long long jc,
                                  const float* si, const float* sj,
                                  float* raw_a, int first, int last,
                                  int descale, float* acc_a, float* acc_b,
                                  void* stream) {
    if (u != SYM_TILE || descale) return (int)cudaErrorInvalidValue;
    abl_rect_reduce_kernel<J><<<(unsigned)(na_s + jc), SYM_TILE, 0,
                                (cudaStream_t)stream>>>(
        na, nb, na_s, j_lo, jc, si, const_cast<float*>(sj), raw_a, first,
        last, acc_a, acc_b);
    int err = (int)cudaGetLastError();
    if (err || J != ABL_FIX0) return err;
    abl_rect_fix0_kernel<<<1, SYM_TILE, 0, (cudaStream_t)stream>>>(
        nb, jc, sj, first, acc_b);
    return (int)cudaGetLastError();
}

// The rect reduce passes of the none and fix0 ablations (vpu_* and tmm_*
// alike), K2-rect's reduce signature (u = SYM_TILE, descale 0).
#define ABL_RECT_REDUCE(NAME, J)                                             \
    extern "C" int NAME(const float* pos_a, const float* mass_a,             \
                        long long na, const float* pos_b,                    \
                        const float* mass_b, long long nb, long long na_s,   \
                        long long u, long long j_lo, long long jc,           \
                        const float* si, const float* sj, float* raw_a,      \
                        int first, int last, int descale, float eps2,        \
                        float* acc_a, float* acc_b, void* stream) {          \
        (void)pos_a; (void)mass_a; (void)pos_b; (void)mass_b; (void)eps2;    \
        return launch_abl_rect_reduce<J>(na, nb, na_s, u, j_lo, jc, si, sj,  \
                                         raw_a, first, last, descale, acc_a, \
                                         acc_b, stream);                     \
    }
ABL_RECT_REDUCE(nbt_rect_noj_reduce, ABL_NONE)
ABL_RECT_REDUCE(nbt_rect_fix0_reduce, ABL_FIX0)

// The fold passes' spread (FoldMode: 0 auto, 1 clusters, 2 one CTA an
// item), for every fold launch from here on; returns the mode, or -1 if
// there is none such.
extern "C" int nbt_sym_fold_mode(int mode) {
    if (mode < FOLD_AUTO || mode > FOLD_CTA) return -1;
    fold_mode = mode;
    return mode;
}

// CTAs an SM of the fold pair kernel with K7's math (k7) or K2's, square or
// rect, or minus the error of a failed query.
extern "C" int nbt_sym_fold_per_sm(int k7, int rect) {
    if (rect)
        return k7 ? fold_per_sm(rect_fold_pairs_kernel<SYM_K7>)
                  : fold_per_sm(rect_fold_pairs_kernel<SYM_K2>);
    return k7 ? fold_per_sm(sym_fold_pairs_kernel<SYM_K7>)
              : fold_per_sm(sym_fold_pairs_kernel<SYM_K2>);
}

extern "C" int nbt_sym_fold_sub_max(void) { return FOLD_SUB_MAX; }

extern "C" int nbt_sym_tile(void) { return SYM_TILE; }
