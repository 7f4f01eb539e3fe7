// K2 and K7: Newton's-third-law exact all-pairs forces for Hopper (sm_90a).
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
// What bounds it on the card: FP32 FMA and MUFU issue.  A pair costs about
// 23 flops for two interactions (3 sub, 3 FMA for d2 + eps2, 2 mul for the
// cube, 1 rsqrt, 2 mul for F, 3 mul for F*r, 3 + 3 adds into the row and
// column sums) plus one MUFU rsqrt, three warp shuffles and one shared
// load.  The column sums rotate around the warp: at step k lane l pairs its
// row with column (l + k) mod 32 of a 32-column chunk and then takes the
// column accumulator of lane l + 1, so after 32 steps lane l holds column
// l's partial sum with no shared-memory traffic.  The slots add about 48
// bytes of device traffic per body per offset, small beside the pair work.
//
// Left for later: wgmma accumulation of the row and column sums on the
// tensor cores, TMA-fed tiles, and a persistent schedule that keeps the
// i-side in registers across offsets.
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
// 23).  K2's device code in sym_common.cuh is untouched: K3/K4 stay
// bit-equal to per-step K2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include "sym_common.cuh"

// K7's pair tile: sym_pair_tile (K2) with the two one-sided weights
// fi = m_j inv and fj = m_i inv in place of the shared F = m_i m_j inv.
__device__ __forceinline__ void sym_vpu_pair_tile(
        const float* __restrict__ pos, const float* __restrict__ mass,
        long long n, long long nb, long long I, long long d, long long dk,
        float eps2, float* __restrict__ si, float* __restrict__ sj,
        SymPairSmem& sm) {
    const long long J = (I + d) % nb;
    const int t = threadIdx.x;
    const int w = t >> 5;
    const int l = t & 31;
    const long long i = I * SYM_TILE + t;
    const long long j = J * SYM_TILE + t;

    const float4 bi = load_body(pos, mass, i, n);
    sm.tile[t] = load_body(pos, mass, j, n);
    __syncthreads();

    float ax = 0.f, ay = 0.f, az = 0.f;
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
            const float fj = bi.w * inv;
            ax += fi * dx;
            ay += fi * dy;
            az += fi * dz;
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
    const long long slot = dk * nb * SYM_TILE * 3;
    si[slot + 3 * i] = ax;
    si[slot + 3 * i + 1] = ay;
    si[slot + 3 * i + 2] = az;
    sj[slot + 3 * j] = -sx;
    sj[slot + 3 * j + 1] = -sy;
    sj[slot + 3 * j + 2] = -sz;
}

// One CTA per (row tile I, offset d) of the chunk d = d_lo .. d_lo+dc-1;
// K2's tile, or K7's.
template <bool K7>
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
    if (K7)
        sym_vpu_pair_tile(pos, mass, n, nb, I, d, dk, eps2, si, sj, sm);
    else
        sym_pair_tile(pos, mass, n, nb, I, d, dk, eps2, si, sj, sm);
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

template <bool K7>
static int launch_pairs(const float* pos, const float* mass, long long n,
                        long long nb, long long d_lo, long long dc,
                        float eps2, float* si, float* sj, void* stream) {
    if (dc <= 0) return 0;
    sym_pairs_kernel<K7><<<(unsigned)(nb * dc), SYM_TILE, 0,
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
    return launch_pairs<false>(pos, mass, n, nb, d_lo, dc, eps2, si, sj,
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
    return launch_pairs<true>(pos, mass, n, nb, d_lo, dc, eps2, si, sj,
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

extern "C" int nbt_sym_tile(void) { return SYM_TILE; }
