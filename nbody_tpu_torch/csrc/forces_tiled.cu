// K1 and K11: one-sided exact all-pairs force tiles for Hopper (sm_90a).
//
// Replaces nbody_tpu/ops/forces_pallas.py:_force_kernel_vpu (K1) and
// :_force_kernel_vpu_kahan (K11), driven there by _forces_pallas_padded,
// forces_pallas and rect_forces_pallas.
//
// Computes, for every body i of the i-set,
//     acc_i = sum_j m_j * r_ij * rsqrt((|r_ij|^2 + eps2)^3),  r_ij = x_j - x_i
// with no i != j guard: the self-pair vanishes because r = 0, exactly as in
// the JAX kernel and the reference's tiled kernel.  The ragged edges are
// masked at load time: a j slot past Nj is staged as a zero-mass body at
// the origin (it contributes exactly 0), and rows past Ni store nothing.
// Indices are 64-bit.
//
// K1's design.  The grid is (row block, j slice).  A row block is
// K1_BLOCK_ROWS rows, K1_ROWS a lane in registers (K1_BLOCK_ROWS / K1_ROWS
// threads); a slice is `tps` consecutive j tiles of K1_TILE bodies, staged
// through shared memory as float4 {x, y, z, m} and read by broadcast, one
// shared load for a lane's K1_ROWS pairs.  The pair math is onesided_rows
// (onesided_tile.cuh), 13 issue slots a pair.  Each tile's contribution is
// summed from zero and then added to the slice's sum, as JAX's kernel adds
// each block_j tile's sum to its accumulator.  A (row block, slice) work
// item writes its rows' sums to its own slot (slice, Ni, 3); a second
// launch adds the slots in slice order, so there are no atomics and the
// result is bit-reproducible.  With one slice the item writes the
// accelerations and there is no second launch.  The wrapper
// (ops/forces_tiled.py, k1_slices) takes the slice count from Ni and Nj:
// enough items to fill the card (at N = 8192, 16 row blocks x 64 slices of
// one tile; 512 x 4 on the 1M ring's 262,144-body sweep), and one slice
// where the row blocks alone fill it.  The plain
// twin takes the same tiles, slices and order.
//
// What bounds it on the card: FP32 and MUFU issue, 13 slots a pair (the
// MUFU's quarter rate is 4 slots' worth, below the other 12); the staging
// and slot traffic are small beside it.  On an H100 80GB HBM3 at 700.00 W
// one evaluation at N = 8192 takes 0.0416 ms against the earlier design's
// 0.2167 (one thread a row, one float32 running sum a row, 64 blocks), and
// the 1M ring's 262,144 x 262,144 antipodal sweep 34.27 ms against 45.36
// with 1024 work items (chip_smoke.py check_redesign, medians of four
// alternating rounds); with 2048, as now, 33.12 ms (its float32 bound
// 19.49): the loop's 13 slots a pair and a quarter slot of shared load
// issue at 82% of the rate at the 1980 MHz boost clock.  Four rows a lane
// beat eight (34.03 against 36.87 ms; 62 registers against 96), and 1024
// or 512 items lose to 2048 (tools/k1_ring_variants.py).  The tile and
// slice partials also take the 262,144-term running sum's error out of
// the ring's antipodal sweep: 1.869e-6 of |a| against float64 where the
// earlier design reached 1.193e-3.
//
// K11 (the compensated tier) takes K1's work items, tiles, slice plan and
// pair loop whole.  Within an item each tile's sum starts from zero and
// enters the slice's running sum (s, c) through a Kahan two-sum with a
// carried compensation (y = t - c; s' = s + y; c = (s' - s) - y), as the
// Pallas kernel adds each block_j tile's sum to its acc / comp buffers.
// Across items the compensation is carried too: a slice writes both s and
// c to its slots (2, slices, Ni, 3), and the second launch merges the
// slots in slice order.  The value a slot stands for is s - c; the merge
// adds the sums with Knuth's exact two-sum (six adds, no condition on the
// operands' sizes) and carries their errors with the slots'
// compensations, then folds the carried term in once:
//     S, C = s_0, c_0;  for k >= 1:  S', e = two_sum(S, s_k)  (S + s_k =
//     S' + e exactly);  C = (C + c_k) - e;  S = S';   result S - C.
// A Kahan add of s_k into (S, C) would round s_k - C at the size of s_k,
// the size of the whole sum when there are few slices, and lost 6-8% of
// the compensation's gain at two slices (the twin, on the CPU).  With
// one tile a slice (N = 8192 gives 16 row blocks x 64 slices of one tile)
// every c_k is 0: S alone would be the plain sum of the tiles, K1's
// result, and the fold of C is what compensates.  With one slice (N = 1M:
// 2048 row blocks) the item writes s, as the Pallas kernel returns acc
// and drops the last comp, and there is no second launch.  No atomics:
// bit-reproducible.  The two-sums are written with __fadd_rn /
// __fsub_rn, and the build passes no --use_fast_math, so nvcc neither
// contracts nor reassociates them (reassociated, c and e fold to 0).
// They cost 4 adds a tile and component, nothing a pair; the slots take
// twice K1's bytes (12.6 MB at N = 8192).  K11's item runs at 72
// registers (K1's 62), no spill.  On an H100 80GB HBM3 at 700.00 W an
// evaluation takes 552.6 ms at N = 1,048,576 (K1's 534 ms of pair work
// plus 3.5%) and 0.0453 ms of the card's time at N = 8192, against 688.3
// and 0.2023 before this design, which kept one thread a row in 128-thread
// blocks (64 blocks at N = 8192) with one running sum over the whole j-set
// (chip_smoke.py check_redesign, medians of four alternating rounds).  Its
// error against float64 is the earlier design's to within 1%.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math: it flushes denormals and
//        swaps the IEEE divide and rsqrt for approximations).

#include <cuda_runtime.h>

#include "onesided_tile.cuh"

// K1 and K11: rows a lane, rows a block, j-tile width.
#define K1_ROWS 4
#define K1_BLOCK_ROWS 512
#define K1_TILE 128

// s += t with the carried compensation c (a Kahan two-sum).
__device__ __forceinline__ void kahan_add(float& s, float& c, float t) {
    const float y = __fsub_rn(t, c);
    const float u = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(u, s), y);
    s = u;
}

// The work item (row block blockIdx.x, slice blockIdx.y) of K1 and, with
// KAHAN, of K11: the slice's tiles tps * blockIdx.y .. against the block's
// rows.  Each tile's sum starts from zero; K1 adds it to the slice's sum,
// K11 two-sums it into the slice's (s, c).  The sums go to slot
// out[blockIdx.y]; K11's compensations to comp[blockIdx.y] where comp is
// not null (more than one slice).
template <bool KAHAN>
__device__ __forceinline__ void k1_item(const float* pos_i, long long ni,
                                        const float* pos_j,
                                        const float* __restrict__ mass_j,
                                        long long nj, long long tps,
                                        float eps2, float* __restrict__ out,
                                        float* __restrict__ comp) {
    constexpr int THREADS = K1_BLOCK_ROWS / K1_ROWS;
    __shared__ float4 tile[K1_TILE];
    const int t = threadIdx.x;
    const long long row0 = (long long)blockIdx.x * K1_BLOCK_ROWS
                           + (t >> 5) * 32 * K1_ROWS + (t & 31);
    float4 br[K1_ROWS];
    float ax[K1_ROWS], ay[K1_ROWS], az[K1_ROWS];
    float cx[K1_ROWS], cy[K1_ROWS], cz[K1_ROWS];     // K11's compensation
#pragma unroll
    for (int r = 0; r < K1_ROWS; ++r) {
        const long long i = row0 + 32 * r;
        br[r] = i < ni ? make_float4(pos_i[3 * i], pos_i[3 * i + 1],
                                     pos_i[3 * i + 2], 0.f)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        ax[r] = 0.f;
        ay[r] = 0.f;
        az[r] = 0.f;
        cx[r] = 0.f;
        cy[r] = 0.f;
        cz[r] = 0.f;
    }
    const long long tiles = (nj + K1_TILE - 1) / K1_TILE;
    const long long t_lo = (long long)blockIdx.y * tps;
    const long long t_hi = t_lo + tps < tiles ? t_lo + tps : tiles;
    for (long long T = t_lo; T < t_hi; ++T) {
        for (int k = t; k < K1_TILE; k += THREADS)
            tile[k] = load_body(pos_j, mass_j, T * K1_TILE + k, nj);
        __syncthreads();
        float tx[K1_ROWS], ty[K1_ROWS], tz[K1_ROWS];
#pragma unroll
        for (int r = 0; r < K1_ROWS; ++r) {
            tx[r] = 0.f;
            ty[r] = 0.f;
            tz[r] = 0.f;
        }
        onesided_rows<W_MJ, K1_ROWS>(tile, K1_TILE, br, eps2, tx, ty, tz);
#pragma unroll
        for (int r = 0; r < K1_ROWS; ++r) {
            if (KAHAN) {
                kahan_add(ax[r], cx[r], tx[r]);
                kahan_add(ay[r], cy[r], ty[r]);
                kahan_add(az[r], cz[r], tz[r]);
            } else {
                ax[r] += tx[r];
                ay[r] += ty[r];
                az[r] += tz[r];
            }
        }
        __syncthreads();
    }
    float* slot = out + (long long)blockIdx.y * ni * 3;
#pragma unroll
    for (int r = 0; r < K1_ROWS; ++r) {
        const long long i = row0 + 32 * r;
        if (i < ni) {
            slot[3 * i] = ax[r];
            slot[3 * i + 1] = ay[r];
            slot[3 * i + 2] = az[r];
        }
    }
    if (!KAHAN || comp == nullptr) return;
    float* cslot = comp + (long long)blockIdx.y * ni * 3;
#pragma unroll
    for (int r = 0; r < K1_ROWS; ++r) {
        const long long i = row0 + 32 * r;
        if (i < ni) {
            cslot[3 * i] = cx[r];
            cslot[3 * i + 1] = cy[r];
            cslot[3 * i + 2] = cz[r];
        }
    }
}

// K1's work item.
__global__ void __launch_bounds__(K1_BLOCK_ROWS / K1_ROWS)
k1_tile_kernel(const float* pos_i, long long ni, const float* pos_j,
               const float* __restrict__ mass_j, long long nj, long long tps,
               float eps2, float* __restrict__ out) {
    k1_item<false>(pos_i, ni, pos_j, mass_j, nj, tps, eps2, out, nullptr);
}

// K11's work item: sums to out, compensations to comp (null: one slice,
// out is the result).
__global__ void __launch_bounds__(K1_BLOCK_ROWS / K1_ROWS)
k11_tile_kernel(const float* pos_i, long long ni, const float* pos_j,
                const float* __restrict__ mass_j, long long nj, long long tps,
                float eps2, float* __restrict__ out,
                float* __restrict__ comp) {
    k1_item<true>(pos_i, ni, pos_j, mass_j, nj, tps, eps2, out, comp);
}

// acc = ((slot 0 + slot 1) + slot 2) ..., component by component.
__global__ void __launch_bounds__(256)
k1_reduce_kernel(const float* __restrict__ slots, long long n3, int slices,
                 float* __restrict__ acc) {
    const long long x = (long long)blockIdx.x * 256 + threadIdx.x;
    if (x >= n3) return;
    float v = slots[x];
    for (int s = 1; s < slices; ++s) v += slots[s * n3 + x];
    acc[x] = v;
}

// a + b = s + e exactly (Knuth's two-sum); returns s, sets e.
__device__ __forceinline__ float two_sum(float a, float b, float& e) {
    const float s = __fadd_rn(a, b);
    const float bb = __fsub_rn(s, a);
    e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
    return s;
}

// K11's merge of the slots (sums, then compensations) in slice order: the
// sums two-summed exactly, their errors and the slots' compensations
// carried in c, folded in once at the end (the header states the form).
__global__ void __launch_bounds__(256)
k11_reduce_kernel(const float* __restrict__ sums,
                  const float* __restrict__ comps, long long n3, int slices,
                  float* __restrict__ acc) {
    const long long x = (long long)blockIdx.x * 256 + threadIdx.x;
    if (x >= n3) return;
    float s = sums[x];
    float c = comps[x];
    for (int k = 1; k < slices; ++k) {
        float e;
        s = two_sum(s, sums[k * n3 + x], e);
        c = __fsub_rn(__fadd_rn(c, comps[k * n3 + x]), e);
    }
    acc[x] = __fsub_rn(s, c);
}

// K1 (kahan 0) or K11 (kahan 1) over `slices` slices of tps j tiles each
// (tps * slices tiles covering Nj); with more than one slice `slots` holds
// (slices, Ni, 3) floats for K1, and for K11 the sums' (slices, Ni, 3)
// followed by the compensations'.
static int launch(const float* pos_i, long long ni, const float* pos_j,
                  const float* mass_j, long long nj, long long tps, int slices,
                  float eps2, float* slots, float* acc, void* stream,
                  bool kahan) {
    if (ni <= 0) return 0;
    if (tps < 1 || slices < 1 || (slices > 1 && slots == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid((unsigned)((ni + K1_BLOCK_ROWS - 1) / K1_BLOCK_ROWS),
                    (unsigned)slices);
    const long long n3 = ni * 3;
    float* out = slices > 1 ? slots : acc;
    if (kahan)
        k11_tile_kernel<<<grid, K1_BLOCK_ROWS / K1_ROWS, 0, s>>>(
            pos_i, ni, pos_j, mass_j, nj, tps, eps2, out,
            slices > 1 ? slots + slices * n3 : nullptr);
    else
        k1_tile_kernel<<<grid, K1_BLOCK_ROWS / K1_ROWS, 0, s>>>(
            pos_i, ni, pos_j, mass_j, nj, tps, eps2, out);
    if (slices > 1) {
        const unsigned blocks = (unsigned)((n3 + 255) / 256);
        if (kahan)
            k11_reduce_kernel<<<blocks, 256, 0, s>>>(
                slots, slots + slices * n3, n3, slices, acc);
        else
            k1_reduce_kernel<<<blocks, 256, 0, s>>>(slots, n3, slices, acc);
    }
    return (int)cudaGetLastError();
}

extern "C" int nbt_forces_tiled(const float* pos_i, long long ni,
                                const float* pos_j, const float* mass_j,
                                long long nj, long long tps, int slices,
                                float eps2, float* slots, float* acc,
                                void* stream) {
    return launch(pos_i, ni, pos_j, mass_j, nj, tps, slices, eps2, slots,
                  acc, stream, false);
}

// K11: K1's signature, slots of twice K1's size.
extern "C" int nbt_forces_tiled_kahan(const float* pos_i, long long ni,
                                      const float* pos_j,
                                      const float* mass_j, long long nj,
                                      long long tps, int slices, float eps2,
                                      float* slots, float* acc,
                                      void* stream) {
    return launch(pos_i, ni, pos_j, mass_j, nj, tps, slices, eps2, slots,
                  acc, stream, true);
}

extern "C" int nbt_forces_tiled_geometry(int what) {
    return what == 0 ? K1_TILE : K1_BLOCK_ROWS;
}
