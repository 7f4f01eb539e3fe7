// K2: Newton's-third-law exact all-pairs forces for Hopper (sm_90a).
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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include <cuda_runtime.h>

#define SYM_TILE 256
#define SYM_WARPS (SYM_TILE / 32)

__device__ __forceinline__ float4 load_body(const float* __restrict__ pos,
                                            const float* __restrict__ mass,
                                            long long b, long long n) {
    return (b < n) ? make_float4(pos[3 * b], pos[3 * b + 1], pos[3 * b + 2],
                                 mass[b])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
}

// One CTA per (row tile I, offset d) of the chunk d = d_lo .. d_lo+dc-1.
__global__ void __launch_bounds__(SYM_TILE)
sym_pairs_kernel(const float* __restrict__ pos,
                 const float* __restrict__ mass, long long n, long long nb,
                 long long d_lo, float eps2, float* __restrict__ si,
                 float* __restrict__ sj) {
    __shared__ float4 tile[SYM_TILE];
    __shared__ float part[SYM_WARPS][SYM_TILE * 3];
    const long long bid = blockIdx.x;
    const long long dk = bid / nb;
    const long long I = bid - dk * nb;
    const long long d = d_lo + dk;
    if (2 * d == nb && 2 * I >= nb) return;   // even nb: half offset
    const long long J = (I + d) % nb;
    const int t = threadIdx.x;
    const int w = t >> 5;
    const int l = t & 31;
    const long long i = I * SYM_TILE + t;
    const long long j = J * SYM_TILE + t;

    const float4 bi = load_body(pos, mass, i, n);
    tile[t] = load_body(pos, mass, j, n);
    __syncthreads();

    float ax = 0.f, ay = 0.f, az = 0.f;
    for (int c = 0; c < SYM_TILE / 32; ++c) {
        float bx = 0.f, by = 0.f, bz = 0.f;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
            const float4 q = tile[c * 32 + ((l + k) & 31)];
            const float dx = q.x - bi.x;
            const float dy = q.y - bi.y;
            const float dz = q.z - bi.z;
            const float d2 = dx * dx + dy * dy + dz * dz + eps2;
            const float f = (bi.w * q.w) * rsqrtf(d2 * d2 * d2);
            const float px = f * dx;
            const float py = f * dy;
            const float pz = f * dz;
            ax += px;
            ay += py;
            az += pz;
            bx += px;
            by += py;
            bz += pz;
            const int src = (l + 1) & 31;
            bx = __shfl_sync(0xffffffffu, bx, src);
            by = __shfl_sync(0xffffffffu, by, src);
            bz = __shfl_sync(0xffffffffu, bz, src);
        }
        const int col = c * 32 + l;
        part[w][3 * col] = bx;
        part[w][3 * col + 1] = by;
        part[w][3 * col + 2] = bz;
    }
    __syncthreads();
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int v = 0; v < SYM_WARPS; ++v) {
        sx += part[v][3 * t];
        sy += part[v][3 * t + 1];
        sz += part[v][3 * t + 2];
    }
    const long long slot = dk * nb * SYM_TILE * 3;
    si[slot + 3 * i] = ax;
    si[slot + 3 * i + 1] = ay;
    si[slot + 3 * i + 2] = az;
    sj[slot + 3 * j] = -sx;
    sj[slot + 3 * j + 1] = -sy;
    sj[slot + 3 * j + 2] = -sz;
}

// One CTA per tile: folds the chunk's slots into the running sum, and on the
// last chunk adds the one-sided diagonal tile and applies the 1/m descale.
__global__ void __launch_bounds__(SYM_TILE)
sym_reduce_kernel(const float* __restrict__ pos,
                  const float* __restrict__ mass, long long n, long long nb,
                  long long d_lo, long long dc, const float* __restrict__ si,
                  const float* __restrict__ sj, float* __restrict__ raw,
                  int first, int last, float eps2, float* __restrict__ out) {
    __shared__ float4 tile[SYM_TILE];
    const long long I = blockIdx.x;
    const int t = threadIdx.x;
    const long long b = I * SYM_TILE + t;
    const long long n_pad = nb * SYM_TILE;

    float sx = 0.f, sy = 0.f, sz = 0.f;
    if (!first) {
        sx = raw[3 * b];
        sy = raw[3 * b + 1];
        sz = raw[3 * b + 2];
    }
    for (long long dk = 0; dk < dc; ++dk) {
        const bool half = 2 * (d_lo + dk) == nb;
        const long long o = (dk * n_pad + b) * 3;
        if (!half || 2 * I < nb) {
            sx += si[o];
            sy += si[o + 1];
            sz += si[o + 2];
        }
        if (!half || 2 * I >= nb) {
            sx += sj[o];
            sy += sj[o + 1];
            sz += sj[o + 2];
        }
    }
    if (!last) {
        raw[3 * b] = sx;
        raw[3 * b + 1] = sy;
        raw[3 * b + 2] = sz;
        return;
    }

    tile[t] = load_body(pos, mass, b, n);
    __syncthreads();
    if (b >= n) return;
    const float4 bi = tile[t];
    float ax = 0.f, ay = 0.f, az = 0.f;
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
        const float inv_m = 1.0f / bi.w;
        ax += sx * inv_m;
        ay += sy * inv_m;
        az += sz * inv_m;
    } else {
        // A real massless body: its raw sums are all 0, so sweep its row
        // one-sided over every body instead.
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
    out[3 * b] = ax;
    out[3 * b + 1] = ay;
    out[3 * b + 2] = az;
}

extern "C" int nbt_sym_pairs(const float* pos, const float* mass,
                             long long n, long long nb, long long d_lo,
                             long long dc, float eps2, float* si, float* sj,
                             void* stream) {
    if (dc <= 0) return 0;
    sym_pairs_kernel<<<(unsigned)(nb * dc), SYM_TILE, 0,
                       (cudaStream_t)stream>>>(pos, mass, n, nb, d_lo, eps2,
                                               si, sj);
    return (int)cudaGetLastError();
}

extern "C" int nbt_sym_reduce(const float* pos, const float* mass,
                              long long n, long long nb, long long d_lo,
                              long long dc, const float* si, const float* sj,
                              float* raw, int first, int last, float eps2,
                              float* out, void* stream) {
    sym_reduce_kernel<<<(unsigned)nb, SYM_TILE, 0, (cudaStream_t)stream>>>(
        pos, mass, n, nb, d_lo, dc, si, sj, raw, first, last, eps2, out);
    return (int)cudaGetLastError();
}

extern "C" int nbt_sym_tile(void) { return SYM_TILE; }
