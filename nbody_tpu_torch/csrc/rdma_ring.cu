// K13: the fused ring for Hopper (sm_90a), one launch per card per force
// evaluation over the shards of a mesh that the card holds.
//
// Replaces nbody_tpu/parallel/rdma_ring.py:277 _make_ring_kernel (launched
// by rdma_forces_local :587, its pallas_call at :637), with its tiles
// _tile_both :186 and _tile_i :217 and the transposed pack twins :117-166.
//
// The JAX kernel runs the whole P-phase ring of one device: the self sweep,
// then D data hops, each forwarding an (8, C) payload [posT; mass; travel
// acc] to the right neighbour by remote DMA and computing against it, then
// a return hop that ships each travel partial home.  D = floor((P-1)/2)
// for odd P and P/2 for even P on the pair-symmetric ("sym") ladder, P - 1
// for the one-sided family (pallas -> vpu, pallas_turbo -> turbo).  Here
// every shard lives on this card, and one launch runs the ring of all P
// shards at once: the payloads really move from shard to shard in device
// memory, and the travel accumulator goes back to its home shard.
//
// Layout.  The wrapper packs the shards into pos (P*C, 3), mass (P*C),
// shard s at rows s*C, C a multiple of SYM_TILE.  Each shard owns a double-
// buffered payload: data slots dpos/dmass (2, P*C, 3)/(2, P*C) and travel
// slots trav (2, P*C, 3), body-major as load_body reads them (JAX's
// transposed (8, C) rows are a Mosaic layout workaround, rdma_ring.py:
// 364-371, 623-634).  Phase d's payload lies in slot d % 2.
//
// Schedule (grid phases separated by cooperative_groups grid syncs):
//   phase 0, self sweep, one-sided: every (shard s, row tile I, column tile
//     J) of s against its own bodies, the variant's one-sided tile (JAX's
//     _tile_i): for vpu2 and vpu onesided_pair_rows (onesided_tile.cuh,
//     K1's pair loop, m_i m_j or m_j weights), for the tensor-core variants
//     ring_tc_tile_i; the self pair masked by index for turbo, turbo2 and
//     mxu (rdma_ring.py:352, 386-392), unmasked for vpu and vpu2 (r = 0).
//     In the same grid phase the payload of phase 0 or 1 is seeded;
//   phase d = 1 .. D: forward (each shard's slot (d-1)%2 into its right
//     neighbour's slot d%2, data and travel; grid sync), then compute
//     against slot d%2: two-sided for d <= floor((P-1)/2) on the sym
//     ladder (the i side into the shard's accumulator, the j side into the
//     slot's travel rows; vpu2 on K2's pair tile sym_pair_core, vpu on
//     K7's sym_tile_core, the tensor-core variants on sym_tc_tile),
//     one-sided (the variant's _tile_i) for the even-P antipodal phase and
//     every phase of the one-sided family;
//   finish: shard s's travel (slot D%2) is added into shard (s - D) mod P's
//     accumulator (the return hop), then for vpu2 the sum is divided by the
//     body's mass, and a body of mass 0 gets its row recomputed one-sided
//     over all P*C bodies with m_j weights (JAX's _inv_mass_scale maps 1/0
//     to 0 and leaves a real massless body with an acceleration of exactly
//     0 under --comm rdma, rdma_ring.py:667).
//
// overlap (comm="rdma_overlap", rdma_ring.py:487-529): no forward grid
// phase.  The data of phase d+1 is copied in the grid phase that computes
// phase d (the copy work items ride the same work list, as the JAX kernel
// forwards the data rows on receipt), and the travel rows trail one phase:
// the travel of phase d arrives in phase d's compute grid phase, the j
// side of phase d sums from zero (JAX's private jacc, here the reduce's
// register sum), and the reduce folds it in as travel + jacc (:509-523).
// Results differ from the sequential protocol at rounding only, and repeat
// bit for bit.
//
// The two protocols.  The JAX kernel orders its hops by DMA semaphores,
// acks and a barrier semaphore.  On one card, rdma_ring_kernel orders them
// by grid syncs instead: the grid phase that writes a slot and the one that
// reads it are separated by a cooperative_groups grid sync.  Across cards
// no grid spans both, and rdma_flag_kernel (below) keeps the JAX protocol:
// each card's launch runs the shards it holds, one group of CTAs a shard;
// a payload is pushed into the right neighbour's slot by peer stores
// (NVLink) and announced by a flag released at system scope in the
// neighbour's memory, which the neighbour's CTAs acquire before they read;
// an ack a phase tells the left neighbour a slot is free again, with the
// prophylactic ack before the loop and the drain after it; the return hop
// pushes each travel partial into its home shard; flags count up by epoch
// across launches (collective_id's role).  Within a shard the slots, tiles
// and fixed-order reduce are the grid-sync kernel's, so both give the same
// bits; the wrapper takes the grid-sync kernel for a mesh on one card and
// the flag kernel across cards (see the wrapper for why both stay).
//
// Reductions are deterministic, with no atomics: one-writer slots and a
// fixed-order reduce, the design of rect_common.cuh, in JAX's association
// order at the port's 256-wide tiles.  Work item (s, I, J) writes its row
// sums to slot si[s][J - j_lo][I's rows] and its column sums to slot
// sj[s][I][J - j_lo]; the reduce then adds, per body and phase, the row
// slots over J in order (JAX's tile + ai over the j tiles, :406-409) into
// a running sum, and the phase sum into the accumulator in phase order
// (:412-417); and per visiting body the column slots over I in order into
// the travel rows ((t + aj_0) + aj_1 ..., JAX's t += ajT per i-block,
// :393-402).  The column tiles run in chunks of jcw whose slots fit the
// wrapper's budget, with a grid sync after each chunk's compute and after
// its reduce; the sums do not depend on the chunking.  At N = 1M on 4
// shards unchunked slots would take 2 * 1024 * 262,144 * 12 B = 6.4 GB a
// shard.
//
// Positions, slots and sums are read through plain (not __restrict__)
// pointers: other blocks write them between grid syncs, and the read-only
// data path is not coherent with those writes (sym_common.cuh).
//
// The exact tiles.  A one-sided item (256 rows against 256 columns) is
// K2's geometry without the column side: warp w takes columns 32w ..
// 32w+31 against all 256 rows, eight rows a lane in registers, one shared
// load a column for eight pairs, 13 issue slots a pair (14 for vpu2's
// m_i m_j), and the warps' row partials are added in warp order.  The
// two-sided vpu2 item is K2's pair tile (17.5 slots a pair for both
// sides); the two-sided vpu item keeps K7's tile, one row a thread.
//
// What bounds it on the card: the tiles' FP32 and MUFU issue (the
// tensor-core variants add their bf16 mma); the copies move 28 B a body a
// hop and the slots ~48 B a body a column chunk, small beside the pair
// work.  The ring does one-sided work twice where the separate kernels run
// the pair-symmetric diagonal: the self sweep is one-sided over C x C, as
// JAX's, and a pair-symmetric self sweep would halve its pairs.  On an
// H100 80GB HBM3 at 700.00 W, vpu2 at N = 1M on 4 shards takes 564.950 ms
// against the earlier tiles' 744.580, and vpu (one CTA an SM) 681.817
// against 706.340 (tools/k1_ring_variants.py, medians of three rounds;
// chip_smoke.py check_redesign times vpu2 and its phases in every run).
// The grid is the card's co-resident CTA count for the variant.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no --use_fast_math).

#include <cooperative_groups.h>

#include "onesided_tile.cuh"
#include "rect_common.cuh"
#include "sym_common.cuh"
#include "sym_tc_tile.cuh"
#include "sym_tile.cuh"

namespace cg = cooperative_groups;

// The ring's tile variants, JAX's names: the sym ladder vpu2, vpu, turbo,
// mxu, turbo2; RING_VPU and RING_TURBO also serve the one-sided family.
enum RingVariant { RING_VPU2 = 0, RING_VPU = 1, RING_TURBO = 2, RING_MXU = 3,
                   RING_TURBO2 = 4 };

__host__ __device__ constexpr bool ring_is_tc(int v) {
    return v >= RING_TURBO;
}

__host__ __device__ constexpr int ring_tc_variant(int v) {
    return v == RING_TURBO ? (int)TURBO : (v == RING_MXU ? (int)MXU
                                                         : (int)TURBO2);
}

template <int V> struct RingSmem { typedef SymPairSmem type; };
template <> struct RingSmem<RING_TURBO> { typedef SymTcSmem type; };
template <> struct RingSmem<RING_MXU> { typedef SymTcSmem type; };
template <> struct RingSmem<RING_TURBO2> { typedef SymTcSmem type; };

struct RingArgs {
    const float* pos;    // (P*C, 3) every shard's own bodies
    const float* mass;   // (P*C)
    float* dpos;         // data slots (2, P*C, 3)
    float* dmass;        // (2, P*C)
    float* trav;         // travel slots (2, P*C, 3)
    float* si;           // row slots (P, jcw, C, 3)
    float* sj;           // column slots (P, nt, jcw * SYM_TILE, 3)
    float* raw;          // a phase's running row sum across chunks (P*C, 3)
    float* acc;          // the row sum over phases (P*C, 3)
    float* out;          // accelerations (P*C, 3)
    long long p, c, nt, jcw;
    int half;            // two-sided phases, floor((P-1)/2) or 0
    int d_final;         // D
    int phases;          // ring phases run: D + 1 (fewer only to time parts)
    int overlap, descale;
    float eps2;
};

// A payload copy of one grid phase: for each shard s, its bodies at
// (pos, mass) go to shard (s + shift) % P of (to_pos, to_mass), and its
// travel rows at trav (zeros if null) to to_trav.  Null destinations are
// skipped.
struct RingCopy {
    const float* pos;
    const float* mass;
    float* to_pos;
    float* to_mass;
    const float* trav;
    float* to_trav;
    int shift;
};

// Copy work item k = s * nt + T: body T * SYM_TILE + threadIdx.x of shard s.
__device__ __forceinline__ void ring_copy(const RingArgs& a,
                                          const RingCopy& cp, long long k) {
    const long long s = k / a.nt;
    const long long b = (k - s * a.nt) * SYM_TILE + threadIdx.x;
    const long long from = s * a.c + b;
    const long long to = ((s + cp.shift) % a.p) * a.c + b;
    if (cp.to_pos != nullptr) {
        for (int e = 0; e < 3; ++e)
            cp.to_pos[3 * to + e] = cp.pos[3 * from + e];
        cp.to_mass[to] = cp.mass[from];
    }
    if (cp.to_trav != nullptr)
        for (int e = 0; e < 3; ++e)
            cp.to_trav[3 * to + e] = cp.trav ? cp.trav[3 * from + e] : 0.f;
}

// The one-sided tensor-core tile (JAX's _tile_i for turbo, turbo2, mxu):
// the i side of sym_tc_tile's pair work alone, row tile I of (pos_i,
// mass_i) against column tile J of (pos_j, mass_j), the self pair's weight
// zeroed when `mask_self` and I == J (the bf16-weight tiers cancel r = 0
// only in exact arithmetic, rdma_ring.py:224-230).  Row sums go to
// si_tile[3 * r].  Every thread of the block calls it.
template <int TV>
__device__ __forceinline__ void ring_tc_tile_i(
        const float* pos_i, const float* mass_i, long long I,
        const float* pos_j, const float* mass_j, long long J, long long n,
        float eps2, bool mask_self, float* si_tile, SymTcSmem& sm) {
    const int tid = threadIdx.x;
    const int w = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const float4 own_j = load_body(pos_j, mass_j, J * SYM_TILE + tid, n);
    sm.tile[tid] = own_j;
    pack_body<TV>(sm.pack_j, tid, own_j);
    float4 xr[2][2];
    const int r0 = 32 * w + g;
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
        xr[rb][0] = load_body(pos_i, mass_i, I * SYM_TILE + r0 + 16 * rb, n);
        xr[rb][1] = load_body(pos_i, mass_i, I * SYM_TILE + r0 + 16 * rb + 8,
                              n);
    }
    __syncthreads();
    const bool mask = mask_self && I == J;
    float di[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < SYM_TILE; k0 += 16) {
        const int c = k0 + 2 * t;
        const float4 q[4] = {sm.tile[c], sm.tile[c + 1], sm.tile[c + 8],
                             sm.tile[c + 9]};
        uint32_t bj0, bj1;
        load_b(sm.pack_j, SYM_LD, k0, g, t, bj0, bj1);
#pragma unroll
        for (int rb = 0; rb < 2; ++rb) {
            // Fragment register r: row r0 + 16 rb (+ 8 for odd r) against
            // columns c + 4 qa and c + 4 qa + 1, qa = 0 (r < 2) or 2.
            float inv[8];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float4 x = xr[rb][r & 1];
                const int qa = (r >> 1) * 2;
                inv[2 * r] = pair_inv(x, q[qa], eps2);
                inv[2 * r + 1] = pair_inv(x, q[qa + 1], eps2);
                if (mask) {
                    const int row = r0 + 16 * rb + 8 * (r & 1);
                    const int col = c + 4 * qa;
                    if (row == col) inv[2 * r] = 0.f;
                    if (row == col + 1) inv[2 * r + 1] = 0.f;
                }
            }
            uint32_t a[4];
            if (TV == MXU) {
                uint32_t lo[4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    split_rn(inv[2 * r], inv[2 * r + 1], a[r], lo[r]);
                mma_bf16(di[rb], a, bj0, bj1);
                mma_bf16(di[rb], lo, bj0, bj1);
            } else {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int qa = (r >> 1) * 2;
                    a[r] = TV == TURBO2
                        ? pack_rn(inv[2 * r], inv[2 * r + 1])
                        : pack_rn(__fmul_rn(q[qa].w, inv[2 * r]),
                                  __fmul_rn(q[qa + 1].w, inv[2 * r + 1]));
                }
                mma_bf16(di[rb], a, bj0, bj1);
            }
        }
    }
#pragma unroll
    for (int rb = 0; rb < 2; ++rb) {
        const float ca = tile_correction(di[rb][0], di[rb][1],
                                         component(xr[rb][0], t));
        const float cb = tile_correction(di[rb][2], di[rb][3],
                                         component(xr[rb][1], t));
        if (t < 3) {
            si_tile[3 * (r0 + 16 * rb) + t] = ca;
            si_tile[3 * (r0 + 16 * rb + 8) + t] = cb;
        }
    }
}

// Work item (row tile I, column tile J) of a phase for one shard: rows
// are the shard's own bodies (pos_i, mass_i), columns its payload of the
// phase (cpos, cmass), c bodies each.  Two-sided: row sums to si_tile,
// column sums (the force on the visiting bodies) to sj_tile; one-sided:
// row sums only.
template <int V>
__device__ __forceinline__ void ring_tile(const float* pos_i,
                                          const float* mass_i,
                                          const float* cpos,
                                          const float* cmass, long long c,
                                          long long I, long long J,
                                          float eps2, bool two, bool self,
                                          float* si_tile, float* sj_tile,
                                          typename RingSmem<V>::type& sm) {
    if constexpr (ring_is_tc(V)) {
        constexpr int TV = ring_tc_variant(V);
        if (two)
            sym_tc_tile<TV>(pos_i, mass_i, c, I, cpos, cmass, c, J, eps2,
                            si_tile, sj_tile, sm);
        else
            ring_tc_tile_i<TV>(pos_i, mass_i, I, cpos, cmass, J, c, eps2,
                               self, si_tile, sm);
    } else if (!two) {
        const float3 rs = onesided_pair_rows<V == RING_VPU2 ? W_MIMJ : W_MJ>(
            pos_i, mass_i, I * SYM_TILE + threadIdx.x, c, cpos, cmass,
            J * SYM_TILE + threadIdx.x, c, eps2, sm);
        const int t = threadIdx.x;
        si_tile[3 * t] = rs.x;
        si_tile[3 * t + 1] = rs.y;
        si_tile[3 * t + 2] = rs.z;
    } else if (V == RING_VPU2) {
        float3 rs, cs;
        sym_pair_core(pos_i, mass_i, I * SYM_TILE + threadIdx.x, c, cpos,
                      cmass, J * SYM_TILE + threadIdx.x, c, eps2, sm, rs, cs);
        const int t = threadIdx.x;
        si_tile[3 * t] = rs.x;
        si_tile[3 * t + 1] = rs.y;
        si_tile[3 * t + 2] = rs.z;
        sj_tile[3 * t] = -cs.x;
        sj_tile[3 * t + 1] = -cs.y;
        sj_tile[3 * t + 2] = -cs.z;
    } else {
        const int t = threadIdx.x;
        const float4 bi = load_body(pos_i, mass_i, I * SYM_TILE + t, c);
        sm.tile[t] = load_body(cpos, cmass, J * SYM_TILE + t, c);
        __syncthreads();
        float ax = 0.f, ay = 0.f, az = 0.f;
        const float3 col = sym_tile_core<SYM_K7>(bi, eps2, ax, ay, az, sm);
        si_tile[3 * t] = ax;
        si_tile[3 * t + 1] = ay;
        si_tile[3 * t + 2] = az;
        sj_tile[3 * t] = -col.x;
        sj_tile[3 * t + 1] = -col.y;
        sj_tile[3 * t + 2] = -col.z;
    }
    __syncthreads();   // sm is restaged by the next item
}

// The reduce of one column chunk j_lo .. j_lo+jc-1 of phase d: each body's
// row slots over the chunk's column tiles in order into the running sum,
// finished into the accumulator on the last chunk; with `tslot` (two-sided
// phases) each visiting body of the chunk's columns, its column slots over
// the row tiles in order, into its travel rows.
__device__ __forceinline__ void ring_reduce(const RingArgs& a, int d,
                                            bool first, bool last,
                                            long long j_lo, long long jc,
                                            float* tslot) {
    const long long rows = a.p * a.c;
    const long long cols = tslot ? a.p * jc * SYM_TILE : 0;
    const long long stride = (long long)gridDim.x * SYM_TILE;
    for (long long x = (long long)blockIdx.x * SYM_TILE + threadIdx.x;
         x < rows + cols; x += stride) {
        if (x < rows) {
            const long long s = x / a.c;
            const long long i = x - s * a.c;
            float3 v = first ? make_float3(0.f, 0.f, 0.f)
                             : make_float3(a.raw[3 * x], a.raw[3 * x + 1],
                                           a.raw[3 * x + 2]);
            for (long long jk = 0; jk < jc; ++jk) {
                const long long o = ((s * a.jcw + jk) * a.c + i) * 3;
                v.x += a.si[o];
                v.y += a.si[o + 1];
                v.z += a.si[o + 2];
            }
            float* dst = last ? a.acc : a.raw;
            if (last && d > 0) {
                v.x = a.acc[3 * x] + v.x;
                v.y = a.acc[3 * x + 1] + v.y;
                v.z = a.acc[3 * x + 2] + v.z;
            }
            dst[3 * x] = v.x;
            dst[3 * x + 1] = v.y;
            dst[3 * x + 2] = v.z;
            continue;
        }
        const long long y = x - rows;
        const long long s = y / (jc * SYM_TILE);
        const long long l = y - s * jc * SYM_TILE;
        const long long jk = l / SYM_TILE;
        const long long col = l - jk * SYM_TILE;
        const long long b = (s * a.c + (j_lo + jk) * SYM_TILE + col) * 3;
        const float3 t = make_float3(tslot[b], tslot[b + 1], tslot[b + 2]);
        float3 v = a.overlap ? make_float3(0.f, 0.f, 0.f) : t;
        for (long long I = 0; I < a.nt; ++I) {
            const long long o = (((s * a.nt + I) * a.jcw + jk) * SYM_TILE
                                 + col) * 3;
            v.x += a.sj[o];
            v.y += a.sj[o + 1];
            v.z += a.sj[o + 2];
        }
        if (a.overlap) {   // travel + jacc
            v.x = t.x + v.x;
            v.y = t.y + v.y;
            v.z = t.z + v.z;
        }
        tslot[b] = v.x;
        tslot[b + 1] = v.y;
        tslot[b + 2] = v.z;
    }
}

// One phase: its column chunks, each a compute grid phase (the work items,
// and on the first chunk the copy items of `cp`) and a reduce grid phase.
template <int V>
__device__ __forceinline__ void ring_phase(const RingArgs& a, int d,
                                           const float* cpos,
                                           const float* cmass, float* tslot,
                                           const RingCopy* cp,
                                           cg::grid_group& grid,
                                           typename RingSmem<V>::type& sm) {
    for (long long j_lo = 0; j_lo < a.nt; j_lo += a.jcw) {
        const long long jc = a.nt - j_lo < a.jcw ? a.nt - j_lo : a.jcw;
        const long long tiles = a.p * a.nt * jc;
        const long long copies = (j_lo == 0 && cp) ? a.p * a.nt : 0;
        for (long long w = blockIdx.x; w < tiles + copies; w += gridDim.x) {
            if (w >= tiles) {
                ring_copy(a, *cp, w - tiles);
                continue;
            }
            const long long s = w / (a.nt * jc);
            const long long r = w - s * a.nt * jc;
            const long long I = r / jc;
            const long long jk = r - I * jc;
            ring_tile<V>(a.pos + s * a.c * 3, a.mass + s * a.c,
                         cpos + s * a.c * 3, cmass + s * a.c, a.c, I,
                         j_lo + jk, a.eps2, tslot != nullptr, d == 0,
                         a.si + ((s * a.jcw + jk) * a.c + I * SYM_TILE) * 3,
                         a.sj + ((s * a.nt + I) * a.jcw + jk) * SYM_TILE * 3,
                         sm);
        }
        grid.sync();
        ring_reduce(a, d, j_lo == 0, j_lo + jc == a.nt, j_lo, jc, tslot);
        grid.sync();
    }
}

// The return hop and the finish: body b of shard s gets shard
// (s + D) % P's travel rows of slot D % 2, then the vpu2 descale.
__device__ __forceinline__ void ring_finish(const RingArgs& a) {
    const long long n = a.p * a.c;
    const long long stride = (long long)gridDim.x * SYM_TILE;
    const float* tr = a.trav + (a.d_final % 2) * n * 3;
    for (long long x = (long long)blockIdx.x * SYM_TILE + threadIdx.x; x < n;
         x += stride) {
        float3 v = make_float3(a.acc[3 * x], a.acc[3 * x + 1],
                               a.acc[3 * x + 2]);
        if (a.half > 0) {
            const long long s = x / a.c;
            const long long h = ((s + a.d_final) % a.p) * a.c + (x - s * a.c);
            v.x += tr[3 * h];
            v.y += tr[3 * h + 1];
            v.z += tr[3 * h + 2];
        }
        if (a.descale)
            v = rect_finish(v, a.mass[x], load_body(a.pos, a.mass, x, n),
                            a.pos, a.mass, n, 1, a.eps2);
        a.out[3 * x] = v.x;
        a.out[3 * x + 1] = v.y;
        a.out[3 * x + 2] = v.z;
    }
}

// ---------------------------------------------------------------------------
// The flag protocol: one launch per card over the shards that card holds,
// each shard's work done by its own group of the launch's CTAs.  The grid
// syncs above order every shard of one card inside one launch; across cards
// no grid spans both, so each hop is ordered as the JAX kernel orders it,
// by signals in the receiver's memory: the payload is written by peer stores
// (NVLink; on one card plain stores), then a flag is released at system
// scope, and the receiver acquires it before it reads.
//
// A shard's flag words (u64, on its card, kept across launches by the
// wrapper).  A word holds epoch + k, epoch = (evaluation number) <<
// RING_EPOCH_SHIFT, and only grows: a wait for k of this evaluation cannot
// be met by an earlier evaluation's signal, which is what JAX's "every
// semaphore returns to zero" buys it.
//   RF_DATA + k   phase d's payload has landed in slot k = d % 2 (k = d);
//                 sequential: data and travel rows, overlap: data rows
//   RF_TRAV + k   overlap: phase d's travel rows in slot k (k = d)
//   RF_ACK        the right neighbour's acks: 0 when it has entered the
//                 launch (JAX's prophylactic ack), then d once a phase: its
//                 slot (d-1) % 2 is free (sequential, after its forward) or
//                 its slot d % 2 is (overlap, at the end of its phase d)
//   RF_RET        the return hop's rows have landed (k = 1)
//   RF_ENTER      this shard's launch has started: its bodies are in place
//   RF_DONE + r   reader r's massless finish has read this shard's bodies
#define RING_MAX_SHARDS 64
#define RING_EPOCH_SHIFT 20
enum RingFlag { RF_DATA = 0, RF_TRAV = 2, RF_ACK = 4, RF_RET = 5,
                RF_ENTER = 6, RF_DONE = 8,
                RF_WORDS = RF_DONE + RING_MAX_SHARDS };
// The wait that ran out, in the card's error word as (kind << 8) | shard.
enum RingWait { RW_ACK = 1, RW_DATA = 2, RW_TRAV = 3, RW_RET = 4,
                RW_ENTER = 5, RW_DONE = 6, RW_GROUP = 7 };

// A shard's payload buffers, one allocation of RING_PEER_FLOATS floats a
// body, written by its neighbours: data slots (2, C, 3) and (2, C), travel
// slots (2, C, 3), and the rows of its return hop (C, 3).
#define RING_PEER_FLOATS 17
__device__ __forceinline__ float* peer_dpos(float* b, long long c, int k) {
    return b + k * 3 * c;
}
__device__ __forceinline__ float* peer_dmass(float* b, long long c, int k) {
    return b + 6 * c + k * c;
}
__device__ __forceinline__ float* peer_trav(float* b, long long c, int k) {
    return b + 8 * c + k * 3 * c;
}
__device__ __forceinline__ float* peer_ret(float* b, long long c) {
    return b + 14 * c;
}

// Shard q of the mesh as every launch of one evaluation sees it: pointers
// into its card's memory (peer pointers from another card).
struct RingShard {
    const float* pos;             // (C, 3) its bodies
    const float* mass;            // (C)
    float* peer;                  // its payload buffers
    unsigned long long* flags;    // its RF_WORDS flag words
};

struct FlagArgs {
    RingShard q[RING_MAX_SHARDS];
    int local[RING_MAX_SHARDS];   // the shard of each group of this launch
    int groups;
    float* si;                    // row slots (G, jcw, C, 3)
    float* sj;                    // column slots (G, nt, jcw * SYM_TILE, 3)
    float* raw;                   // (G*C, 3), as RingArgs by group
    float* acc;                   // (G*C, 3)
    float* out;                   // (G*C, 3)
    unsigned long long* bar;      // a barrier counter a group, zero at launch
    unsigned long long* err;      // the card's error word
    unsigned long long* err_host; // its mirror in pinned host memory
    long long p, c, nt, jcw;
    int half, d_final, phases, overlap, descale;
    float eps2;
    unsigned long long epoch;     // this evaluation's epoch << SHIFT
    unsigned long long spin_ns;   // the bound of every wait
    unsigned long long readers;   // bit s: shard s's finish reads all bodies
};

struct RingGroup {
    int g;               // the group's index in the launch
    long long s;         // its shard
    long long rank;      // this CTA's rank in the group
    long long size;      // the group's CTAs
};

// A relaxed read at system scope: the spins poll with it (an acquire load
// would drop the SM's L1 lines, the other CTA's too, at every poll) and
// fence once the flag has come.
__device__ __forceinline__ unsigned long long flag_poll(
        const unsigned long long* f) {
    unsigned long long v;
    asm volatile("ld.relaxed.sys.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(f) : "memory");
    return v;
}

__device__ __forceinline__ unsigned long long counter_poll(
        const unsigned long long* f) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(f) : "memory");
    return v;
}

__device__ __forceinline__ void flag_store(unsigned long long* f,
                                           unsigned long long v) {
    asm volatile("st.release.sys.global.u64 [%0], %1;"
                 :: "l"(f), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ring_clock() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// One thread spins until *f >= want, then fences (the acquire of a
// relaxed poll; at system scope for a flag, at card scope for a group's
// barrier counter).  Every spin is bounded: past spin_ns it records `code`
// in the card's error word and its host mirror (the first error stays)
// and gives up, as it does at once when another wait on the card has
// failed, so a schedule that is not co-resident, or a protocol fault, ends
// the launch with an error instead of hanging the card.
__device__ __forceinline__ bool spin_until(
        const FlagArgs& a, const unsigned long long* f,
        unsigned long long want, unsigned long long code,
        bool gpu_scope = false) {
    bool ok = true;
    auto load = [&]() {
        return gpu_scope ? counter_poll(f) : flag_poll(f);
    };
    if (load() < want) {
        const unsigned long long t0 = ring_clock();
        while (load() < want) {
            __nanosleep(32);
            if (*(volatile unsigned long long*)a.err != 0) {
                ok = false;
                break;
            }
            if (ring_clock() - t0 > a.spin_ns) {
                if (atomicCAS(a.err, 0ULL, code) == 0ULL)
                    *(volatile unsigned long long*)a.err_host = code;
                ok = false;
                break;
            }
        }
    }
    if (gpu_scope)
        __threadfence();
    else
        __threadfence_system();
    return ok;
}

__device__ __forceinline__ unsigned long long wait_code(int kind,
                                                        long long s) {
    return ((unsigned long long)kind << 8) | (unsigned long long)s;
}

// Every CTA of the group waits for the flag itself: its own acquire orders
// the payload reads that follow (written by another card or CTA).
__device__ __forceinline__ void cta_wait(const FlagArgs& a,
                                         const unsigned long long* f,
                                         unsigned long long want, int kind,
                                         long long s) {
    if (threadIdx.x == 0) spin_until(a, f, want, wait_code(kind, s));
    __syncthreads();
}

// The group's barrier (a grid sync over the group's CTAs): a counter that
// each CTA adds one to and that only grows within the launch.
__device__ __forceinline__ void group_sync(const FlagArgs& a, const RingGroup& G) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        unsigned long long* ctr = a.bar + G.g;
        const unsigned long long old = atomicAdd(ctr, 1ULL);
        const unsigned long long want =
            (old / (unsigned long long)G.size + 1) * (unsigned long long)G.size;
        spin_until(a, ctr, want, wait_code(RW_GROUP, G.s), true);
    }
    __syncthreads();
}

// A payload push of one tile (body T * SYM_TILE + threadIdx.x): bodies
// (pos, mass) to (to_pos, to_mass) when to_pos is set, travel rows trav
// (zeros when null) to to_trav when it is set.
struct RingPush {
    const float* pos;
    const float* mass;
    float* to_pos;
    float* to_mass;
    const float* trav;
    float* to_trav;
};

__device__ __forceinline__ void push_tile(const RingPush& cp, long long T) {
    const long long b = T * SYM_TILE + threadIdx.x;
    if (cp.to_pos != nullptr) {
        for (int e = 0; e < 3; ++e) cp.to_pos[3 * b + e] = cp.pos[3 * b + e];
        cp.to_mass[b] = cp.mass[b];
    }
    if (cp.to_trav != nullptr)
        for (int e = 0; e < 3; ++e)
            cp.to_trav[3 * b + e] = cp.trav ? cp.trav[3 * b + e] : 0.f;
}

// Up to two flags the group's leader releases once a push has landed.
struct RingSignal {
    unsigned long long* f[2];
    unsigned long long v[2];
};

__device__ __forceinline__ bool group_leader(const RingGroup& G) {
    return G.rank == 0 && threadIdx.x == 0;
}

// The end of a push by the group's CTAs: each makes its stores visible at
// system scope, the group meets, and the leader releases the signal.
__device__ __forceinline__ void push_done(const FlagArgs& a, const RingGroup& G,
                          const RingSignal* sig) {
    __threadfence_system();
    group_sync(a, G);
    if (sig != nullptr && group_leader(G))
        for (int k = 0; k < 2; ++k)
            if (sig->f[k] != nullptr) flag_store(sig->f[k], sig->v[k]);
}

// ring_reduce for one group's shard: its row slots into its running sum
// and accumulator, and with `tslot` its visiting bodies' column slots into
// their travel rows; the same sums in the same order.
__device__ __forceinline__ void group_reduce(const FlagArgs& a, const RingGroup& G, int d,
                             bool first, bool last, long long j_lo,
                             long long jc, float* tslot) {
    const long long rows = a.c;
    const long long cols = tslot ? jc * SYM_TILE : 0;
    const float* si = a.si + G.g * a.jcw * a.c * 3;
    const float* sj = a.sj + G.g * a.nt * a.jcw * SYM_TILE * 3;
    float* raw = a.raw + G.g * a.c * 3;
    float* acc = a.acc + G.g * a.c * 3;
    const long long stride = G.size * SYM_TILE;
    for (long long x = G.rank * SYM_TILE + threadIdx.x; x < rows + cols;
         x += stride) {
        if (x < rows) {
            float3 v = first ? make_float3(0.f, 0.f, 0.f)
                             : make_float3(raw[3 * x], raw[3 * x + 1],
                                           raw[3 * x + 2]);
            for (long long jk = 0; jk < jc; ++jk) {
                const long long o = (jk * a.c + x) * 3;
                v.x += si[o];
                v.y += si[o + 1];
                v.z += si[o + 2];
            }
            float* dst = last ? acc : raw;
            if (last && d > 0) {
                v.x = acc[3 * x] + v.x;
                v.y = acc[3 * x + 1] + v.y;
                v.z = acc[3 * x + 2] + v.z;
            }
            dst[3 * x] = v.x;
            dst[3 * x + 1] = v.y;
            dst[3 * x + 2] = v.z;
            continue;
        }
        const long long y = x - rows;
        const long long jk = y / SYM_TILE;
        const long long col = y - jk * SYM_TILE;
        const long long b = ((j_lo + jk) * SYM_TILE + col) * 3;
        const float3 t = make_float3(tslot[b], tslot[b + 1], tslot[b + 2]);
        float3 v = a.overlap ? make_float3(0.f, 0.f, 0.f) : t;
        for (long long I = 0; I < a.nt; ++I) {
            const long long o = ((I * a.jcw + jk) * SYM_TILE + col) * 3;
            v.x += sj[o];
            v.y += sj[o + 1];
            v.z += sj[o + 2];
        }
        if (a.overlap) {   // travel + jacc
            v.x = t.x + v.x;
            v.y = t.y + v.y;
            v.z = t.z + v.z;
        }
        tslot[b] = v.x;
        tslot[b + 1] = v.y;
        tslot[b + 2] = v.z;
    }
}

// ring_phase for one group's shard: per column chunk its work items (and
// on the first chunk the push `cp`, released by `sig` once it has landed)
// and its reduce, a group barrier after each; under overlap the reduce of a
// two-sided phase first waits for the phase's travel rows (`trav_flag`).
// TWO: a two-sided phase (travel rows `tslot`), else one-sided; a loop of
// one kind of tile apiece, as the grid-sync kernel's self sweep has.
template <int V, bool TWO>
__device__ __forceinline__ void group_phase(
        const FlagArgs& a, const RingGroup& G, int d, const float* cpos,
        const float* cmass, float* tslot, const RingPush* cp,
        const RingSignal* sig, const unsigned long long* trav_flag,
        typename RingSmem<V>::type& sm) {
    const float* pos = a.q[G.s].pos;
    const float* mass = a.q[G.s].mass;
    float* si = a.si + G.g * a.jcw * a.c * 3;
    float* sj = a.sj + G.g * a.nt * a.jcw * SYM_TILE * 3;
    for (long long j_lo = 0; j_lo < a.nt; j_lo += a.jcw) {
        const long long jc = a.nt - j_lo < a.jcw ? a.nt - j_lo : a.jcw;
        const long long tiles = a.nt * jc;
        const long long copies = (j_lo == 0 && cp) ? a.nt : 0;
        for (long long w = G.rank; w < tiles + copies; w += G.size) {
            if (w >= tiles) {
                push_tile(*cp, w - tiles);
                continue;
            }
            const long long I = w / jc;
            const long long jk = w - I * jc;
            ring_tile<V>(pos, mass, cpos, cmass, a.c, I, j_lo + jk,
                         a.eps2, TWO, d == 0,
                         si + (jk * a.c + I * SYM_TILE) * 3,
                         sj + (I * a.jcw + jk) * SYM_TILE * 3, sm);
        }
        if (copies)
            push_done(a, G, sig);
        else
            group_sync(a, G);
        if (j_lo == 0 && trav_flag != nullptr)
            cta_wait(a, trav_flag, a.epoch + d, RW_TRAV, G.s);
        group_reduce(a, G, d, j_lo == 0, j_lo + jc == a.nt, j_lo, jc,
                     TWO ? tslot : nullptr);
        group_sync(a, G);
    }
}

// The rows of a body of mass 0 under the vpu2 descale: one-sided over the
// bodies of every shard in shard order (rect_finish's loop over P*C bodies,
// read through each shard's pointer).
__device__ __forceinline__ float3 ring_massless(const FlagArgs& a, float4 bi) {
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (long long q = 0; q < a.p; ++q) {
        const float* pos_o = a.q[q].pos;
        const float* mass_o = a.q[q].mass;
        for (long long jj = 0; jj < a.c; ++jj) {
            const float dx = pos_o[3 * jj] - bi.x;
            const float dy = pos_o[3 * jj + 1] - bi.y;
            const float dz = pos_o[3 * jj + 2] - bi.z;
            const float d2 = dx * dx + dy * dy + dz * dz + a.eps2;
            const float f = mass_o[jj] * rsqrtf(d2 * d2 * d2);
            ax += f * dx;
            ay += f * dy;
            az += f * dz;
        }
    }
    return make_float3(ax, ay, az);
}

// The ring of one shard under the flags (JAX's _make_ring_kernel protocol,
// its docstring :47-57 and overlap :487-529, with its ack accounting made
// to hold for overlap): the self sweep, D hops, the return hop, the finish.
// One call site of each kind of group_phase.
template <int V>
__device__ __forceinline__ void group_ring(const FlagArgs& a,
                                           const RingGroup& G,
                                           typename RingSmem<V>::type& sm) {
    const long long s = G.s, p = a.p, c = a.c;
    const RingShard& me = a.q[s];
    const RingShard& rq = a.q[(s + 1) % p];
    unsigned long long* left_ack = a.q[(s + p - 1) % p].flags + RF_ACK;
    const unsigned long long E = a.epoch;
    const bool lead = group_leader(G);
    const bool any_trav = a.half > 0;
    const int D = a.d_final;
    // Entered: this launch's bodies and payload buffers are in place, and
    // the prophylactic ack lets the left neighbour send.
    if (lead) {
        flag_store(me.flags + RF_ENTER, E + 1);
        if (p > 1) flag_store(left_ack, E);
    }
    for (int d = 0; d < a.phases; ++d) {
        const int src = (d + 1) % 2, dst = d % 2;
        const bool two = d > 0 && d <= a.half;
        const bool next = d < D;
        const float* cpos = peer_dpos(me.peer, c, dst);
        const float* cmass = peer_dmass(me.peer, c, dst);
        float* trav = peer_trav(me.peer, c, dst);
        RingPush cp = {cpos, cmass, peer_dpos(rq.peer, c, src),
                       peer_dmass(rq.peer, c, src), nullptr, nullptr};
        RingSignal sig = {{rq.flags + RF_DATA + src, nullptr},
                          {E + d + 1, 0}};
        const unsigned long long* trav_flag = nullptr;
        if (d == 0) {
            // The self sweep, with the first payload riding it: the
            // shard's own slot 0 (sequential) or, once the right neighbour
            // has entered, its slot 1 with the zero travel rows of phase 1
            // (overlap).
            cpos = me.pos;
            cmass = me.mass;
            cp = {me.pos, me.mass, peer_dpos(me.peer, c, 0),
                  peer_dmass(me.peer, c, 0), nullptr,
                  any_trav ? peer_trav(me.peer, c, 0) : nullptr};
            sig = {{nullptr, nullptr}, {0, 0}};
            if (a.overlap && next) {
                cta_wait(a, me.flags + RF_ACK, E, RW_ACK, s);
                cp.to_pos = peer_dpos(rq.peer, c, 1);
                cp.to_mass = peer_dmass(rq.peer, c, 1);
                cp.to_trav = any_trav ? peer_trav(rq.peer, c, 1) : nullptr;
                sig = {{rq.flags + RF_DATA + 1,
                        any_trav ? rq.flags + RF_TRAV + 1 : nullptr},
                       {E + 1, E + 1}};
            }
        } else if (!a.overlap) {
            // Consume an ack (the right neighbour's slot dst is free),
            // forward slot src there, ack the left neighbour (slot src is
            // now free), wait for this phase's payload, compute.
            cta_wait(a, me.flags + RF_ACK, E + d - 1, RW_ACK, s);
            const RingPush fwd = {
                peer_dpos(me.peer, c, src), peer_dmass(me.peer, c, src),
                peer_dpos(rq.peer, c, dst), peer_dmass(rq.peer, c, dst),
                peer_trav(me.peer, c, src),
                any_trav ? peer_trav(rq.peer, c, dst) : nullptr};
            for (long long T = G.rank; T < a.nt; T += G.size)
                push_tile(fwd, T);
            const RingSignal arrived = {{rq.flags + RF_DATA + dst, left_ack},
                                        {E + d, E + d}};
            push_done(a, G, &arrived);
            cta_wait(a, me.flags + RF_DATA + dst, E + d, RW_DATA, s);
        } else {
            // Overlap: the data of phase d+1 rides this phase's compute
            // once the right neighbour's slot src is free; this phase's
            // travel rows arrive during it (the reduce waits for them) and
            // are forwarded at its end.
            cta_wait(a, me.flags + RF_DATA + dst, E + d, RW_DATA, s);
            if (next) cta_wait(a, me.flags + RF_ACK, E + d - 1, RW_ACK, s);
            if (two) trav_flag = me.flags + RF_TRAV + dst;
        }
        const RingPush* ride =
            (d == 0 ? next : a.overlap && next) ? &cp : nullptr;
        if (two)
            group_phase<V, true>(a, G, d, cpos, cmass, trav, ride, &sig,
                                 trav_flag, sm);
        else
            group_phase<V, false>(a, G, d, cpos, cmass, nullptr, ride, &sig,
                                  nullptr, sm);
        if (!a.overlap || d == 0) continue;
        if (any_trav && !two)   // the antipodal phase: travel for the return
            cta_wait(a, me.flags + RF_TRAV + dst, E + d, RW_TRAV, s);
        if (any_trav && next) {
            const RingPush tp = {nullptr, nullptr, nullptr, nullptr, trav,
                                 peer_trav(rq.peer, c, src)};
            for (long long T = G.rank; T < a.nt; T += G.size)
                push_tile(tp, T);
            const RingSignal t = {{rq.flags + RF_TRAV + src, nullptr},
                                  {E + d + 1, 0}};
            push_done(a, G, &t);
        }
        if (next && lead) flag_store(left_ack, E + d);   // slot dst is free
    }
    // The return hop: this shard's travel rows (slot D % 2) go to shard
    // (s - D) mod P, and shard (s + D) mod P's arrive here.
    if (any_trav) {
        const RingShard& home = a.q[(s + p - D) % p];
        const RingPush rp = {nullptr, nullptr, nullptr, nullptr,
                             peer_trav(me.peer, c, D % 2),
                             peer_ret(home.peer, c)};
        for (long long T = G.rank; T < a.nt; T += G.size) push_tile(rp, T);
        const RingSignal ret = {{home.flags + RF_RET, nullptr}, {E + 1, 0}};
        push_done(a, G, &ret);
        cta_wait(a, me.flags + RF_RET, E + 1, RW_RET, s);
    }
    if (a.overlap && D > 0 && a.phases == D + 1 && lead)
        flag_store(left_ack, E + D);   // the last slot is free
    // The finish.  A shard whose bodies include one of mass 0 under the
    // descale reads every shard's bodies: only once each has entered.
    const bool reads = a.descale && ((a.readers >> s) & 1ULL);
    if (reads && threadIdx.x == 0)
        for (long long q = 0; q < p; ++q)
            spin_until(a, a.q[q].flags + RF_ENTER, E + 1,
                       wait_code(RW_ENTER, s));
    __syncthreads();
    const float* ret_rows = peer_ret(me.peer, c);
    const float* acc = a.acc + G.g * c * 3;
    float* out = a.out + G.g * c * 3;
    for (long long x = G.rank * SYM_TILE + threadIdx.x; x < c;
         x += G.size * SYM_TILE) {
        float3 v = make_float3(acc[3 * x], acc[3 * x + 1], acc[3 * x + 2]);
        if (any_trav) {
            v.x += ret_rows[3 * x];
            v.y += ret_rows[3 * x + 1];
            v.z += ret_rows[3 * x + 2];
        }
        if (a.descale) {
            const float4 bi = load_body(me.pos, me.mass, x, c);
            v = bi.w != 0.f ? rect_finish(v, bi.w, bi, nullptr, nullptr, 0, 1,
                                          a.eps2)
                            : ring_massless(a, bi);
        }
        out[3 * x] = v.x;
        out[3 * x + 1] = v.y;
        out[3 * x + 2] = v.z;
    }
    // The positions barrier: no shard's launch ends, and so no card's
    // integrator moves (or frees) its bodies, while a massless finish may
    // still read them.
    if (reads) {
        __threadfence_system();
        group_sync(a, G);
        if (lead)
            for (long long q = 0; q < p; ++q)
                if (q != s) flag_store(a.q[q].flags + RF_DONE + s, E + 1);
    }
    if (lead && a.descale)
        for (long long r = 0; r < p; ++r)
            if (r != s && ((a.readers >> r) & 1ULL))
                spin_until(a, me.flags + RF_DONE + r, E + 1,
                           wait_code(RW_DONE, s));
    // JAX's drain: the right neighbour's last ack.
    if (lead && p > 1)
        spin_until(a, me.flags + RF_ACK, E + a.phases - 1,
                   wait_code(RW_ACK, s));
}

// CTAs an SM the variant's kernel is built for: two (128 registers, no
// spills), but one for vpu (253 registers), which spills at two and runs
// 6% slower at N = 1M on 4 shards than at one (tools/k1_ring_variants.py).
// One kernel holds every path of the ring, and capped at the standalone
// tiles' 80 registers (three CTAs, K7 80, K5 77) its tile loops spill.
__host__ __device__ constexpr int ring_ctas(int v) {
    return v == RING_VPU ? 1 : 2;
}

template <int V>
__global__ void __launch_bounds__(SYM_TILE, ring_ctas(V))
rdma_ring_kernel(RingArgs a) {
    __shared__ __align__(16) typename RingSmem<V>::type sm;
    cg::grid_group grid = cg::this_grid();
    const long long n3 = a.p * a.c * 3;
    const bool any_trav = a.half > 0;
    // Phase 0: the self sweep against each shard's own bodies, seeding the
    // payload: slot 0 (sequential) or the right neighbour's slot 1
    // (overlap: the data of phase 1 rides under the self sweep, with the
    // zero travel rows of phase 1).
    const int seed_slot = a.overlap ? 1 : 0;
    const RingCopy seed = {a.pos, a.mass, a.dpos + seed_slot * n3,
                           a.dmass + seed_slot * a.p * a.c, nullptr,
                           any_trav ? a.trav + seed_slot * n3 : nullptr,
                           seed_slot};
    ring_phase<V>(a, 0, a.pos, a.mass, nullptr,
                  a.d_final > 0 ? &seed : nullptr, grid, sm);
    for (int d = 1; d < a.phases; ++d) {
        const int src = (d - 1) % 2, dst = d % 2;
        float* dpos = a.dpos + dst * n3;
        float* dmass = a.dmass + dst * a.p * a.c;
        float* trav = a.trav + dst * n3;
        RingCopy cp = {nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                       1};
        if (!a.overlap) {
            // Forward first: slot (d-1)%2 into the right neighbour's slot
            // d%2, data and travel.
            cp = {a.dpos + src * n3, a.dmass + src * a.p * a.c, dpos, dmass,
                  a.trav + src * n3, any_trav ? trav : nullptr, 1};
            for (long long k = blockIdx.x; k < a.p * a.nt; k += gridDim.x)
                ring_copy(a, cp, k);
            grid.sync();
        } else {
            // The data of phase d+1 and the travel of phase d (which
            // trails the data by one phase) ride under this phase.
            if (d < a.d_final) {
                cp.pos = dpos;
                cp.mass = dmass;
                cp.to_pos = a.dpos + src * n3;
                cp.to_mass = a.dmass + src * a.p * a.c;
            }
            if (any_trav && d >= 2) {
                cp.trav = a.trav + src * n3;
                cp.to_trav = trav;
            }
        }
        const bool two = d <= a.half;
        const bool ride = a.overlap && (cp.to_pos || cp.to_trav);
        ring_phase<V>(a, d, dpos, dmass, two ? trav : nullptr,
                      ride ? &cp : nullptr, grid, sm);
    }
    ring_finish(a);
}

// Blocks of SYM_TILE threads the card holds at once for the variant's
// kernel: the largest grid a cooperative launch accepts.
static int coresident_blocks(const void* kernel) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return -1;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
        != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      SYM_TILE, 0)
        != cudaSuccess) return -1;
    return per_sm * sms;
}

static const void* ring_kernel(int variant) {
    switch (variant) {
        case RING_VPU2: return (const void*)rdma_ring_kernel<RING_VPU2>;
        case RING_VPU: return (const void*)rdma_ring_kernel<RING_VPU>;
        case RING_TURBO: return (const void*)rdma_ring_kernel<RING_TURBO>;
        case RING_MXU: return (const void*)rdma_ring_kernel<RING_MXU>;
        case RING_TURBO2: return (const void*)rdma_ring_kernel<RING_TURBO2>;
    }
    return nullptr;
}

// The co-resident CTAs of the variant's kernel (its cooperative grid).
extern "C" int nbt_rdma_ring_max_blocks(int variant) {
    const void* k = ring_kernel(variant);
    return k ? coresident_blocks(k) : -1;
}

// One force evaluation of the ring over p shards of c bodies (c a multiple
// of SYM_TILE), column tiles in chunks of jcw, the slots and outputs
// allocated by the wrapper (sizes in RingArgs).  `phases` < D + 1 runs
// the first phases only (a timing knob; the output is then not the
// acceleration).
extern "C" int nbt_rdma_ring(int variant, const float* pos, const float* mass,
                             long long p, long long c, long long jcw,
                             int one_sided, int overlap, int phases,
                             float eps2, float* dpos, float* dmass,
                             float* trav, float* si, float* sj, float* raw,
                             float* acc, float* out, void* stream) {
    const void* kernel = ring_kernel(variant);
    if (kernel == nullptr || p < 1 || c < SYM_TILE || c % SYM_TILE || jcw < 1
        || (one_sided && variant != RING_VPU && variant != RING_TURBO))
        return (int)cudaErrorInvalidValue;
    RingArgs a;
    a.pos = pos;
    a.mass = mass;
    a.dpos = dpos;
    a.dmass = dmass;
    a.trav = trav;
    a.si = si;
    a.sj = sj;
    a.raw = raw;
    a.acc = acc;
    a.out = out;
    a.p = p;
    a.c = c;
    a.nt = c / SYM_TILE;
    a.jcw = jcw < a.nt ? jcw : a.nt;
    a.half = one_sided ? 0 : (int)((p - 1) / 2);
    a.d_final = one_sided ? (int)(p - 1) : (int)(p % 2 ? (p - 1) / 2 : p / 2);
    a.phases = (phases < 1 || phases > a.d_final + 1) ? a.d_final + 1
                                                      : phases;
    a.overlap = overlap;
    a.descale = variant == RING_VPU2;
    a.eps2 = eps2;
    const int cap = coresident_blocks(kernel);
    if (cap <= 0) return (int)cudaErrorInvalidConfiguration;
    const long long work = p * a.nt * (a.jcw + 1);
    const unsigned grid = (unsigned)(work < cap ? work : cap);
    void* args[] = {&a};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        kernel, dim3(grid), dim3(SYM_TILE), args, 0, (cudaStream_t)stream);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The flag protocol's kernel: group g of the launch is the CTAs b with
// floor(b * G / grid) == g, and runs shard local[g].
template <int V>
__global__ void __launch_bounds__(SYM_TILE, ring_ctas(V))
rdma_flag_kernel(FlagArgs a) {
    __shared__ __align__(16) typename RingSmem<V>::type sm;
    RingGroup G;
    const long long grid = gridDim.x, groups = a.groups;
    G.g = (int)((long long)blockIdx.x * groups / grid);
    const long long lo = (G.g * grid + groups - 1) / groups;
    const long long hi = ((G.g + 1) * grid + groups - 1) / groups;
    G.rank = blockIdx.x - lo;
    G.size = hi - lo;
    G.s = a.local[G.g];
    group_ring<V>(a, G, sm);
}

static const void* flag_kernel(int variant) {
    switch (variant) {
        case RING_VPU2: return (const void*)rdma_flag_kernel<RING_VPU2>;
        case RING_VPU: return (const void*)rdma_flag_kernel<RING_VPU>;
        case RING_TURBO: return (const void*)rdma_flag_kernel<RING_TURBO>;
        case RING_MXU: return (const void*)rdma_flag_kernel<RING_MXU>;
        case RING_TURBO2: return (const void*)rdma_flag_kernel<RING_TURBO2>;
    }
    return nullptr;
}

// The co-resident CTAs of the variant's flag kernel on the current card.
extern "C" int nbt_rdma_flags_max_blocks(int variant) {
    const void* k = flag_kernel(variant);
    return k ? coresident_blocks(k) : -1;
}

// One card's launch of a force evaluation under the flag protocol: the
// `groups` shards local[] of p, each c bodies (c a multiple of SYM_TILE);
// `table` holds every shard's (pos, mass, peer, flags) pointers, 4 p
// values; si .. out are this card's, packed by group; `bar` holds `groups`
// zeroed counters; `err` is the card's error word and `err_host` its mirror
// in pinned host memory, which the host reads without waiting for the card.  `grid` CTAs (0: the
// co-resident count, never more), cooperative when `coop` (a launch that
// must be co-resident with itself), else a plain launch (the test form of G
// launches on G streams of one card, whose grids together fit the card).
extern "C" int nbt_rdma_flags(int variant, long long p, long long c,
                              long long jcw, int one_sided, int overlap,
                              int phases, float eps2, int groups,
                              const int* local, const long long* table,
                              unsigned long long epoch,
                              unsigned long long spin_ns,
                              unsigned long long readers, float* si,
                              float* sj, float* raw, float* acc, float* out,
                              unsigned long long* bar,
                              unsigned long long* err,
                              unsigned long long* err_host, int grid,
                              int coop, void* stream) {
    const void* kernel = flag_kernel(variant);
    if (kernel == nullptr || p < 1 || p > RING_MAX_SHARDS || c < SYM_TILE
        || c % SYM_TILE || jcw < 1 || groups < 1 || groups > p
        || (one_sided && variant != RING_VPU && variant != RING_TURBO))
        return (int)cudaErrorInvalidValue;
    FlagArgs a;
    for (long long q = 0; q < p; ++q) {
        a.q[q].pos = (const float*)table[4 * q];
        a.q[q].mass = (const float*)table[4 * q + 1];
        a.q[q].peer = (float*)table[4 * q + 2];
        a.q[q].flags = (unsigned long long*)table[4 * q + 3];
    }
    for (int g = 0; g < groups; ++g) {
        if (local[g] < 0 || local[g] >= p) return (int)cudaErrorInvalidValue;
        a.local[g] = local[g];
    }
    a.groups = groups;
    a.si = si;
    a.sj = sj;
    a.raw = raw;
    a.acc = acc;
    a.out = out;
    a.bar = bar;
    a.err = err;
    if (cudaHostGetDevicePointer((void**)&a.err_host, err_host, 0)
        != cudaSuccess)
        return (int)cudaErrorInvalidValue;
    a.p = p;
    a.c = c;
    a.nt = c / SYM_TILE;
    a.jcw = jcw < a.nt ? jcw : a.nt;
    a.half = one_sided ? 0 : (int)((p - 1) / 2);
    a.d_final = one_sided ? (int)(p - 1) : (int)(p % 2 ? (p - 1) / 2 : p / 2);
    a.phases = (phases < 1 || phases > a.d_final + 1) ? a.d_final + 1
                                                      : phases;
    a.overlap = overlap;
    a.descale = variant == RING_VPU2;
    a.eps2 = eps2;
    a.epoch = epoch << RING_EPOCH_SHIFT;
    a.spin_ns = spin_ns;
    a.readers = readers;
    const int cap = coresident_blocks(kernel);
    if (cap <= 0) return (int)cudaErrorInvalidConfiguration;
    const int blocks = grid > 0 && grid < cap ? grid : cap;
    if (blocks < groups) return (int)cudaErrorInvalidConfiguration;
    void* args[] = {&a};
    const cudaError_t e =
        coop ? cudaLaunchCooperativeKernel(kernel, dim3(blocks),
                                           dim3(SYM_TILE), args, 0,
                                           (cudaStream_t)stream)
             : cudaLaunchKernel(kernel, dim3(blocks), dim3(SYM_TILE), args, 0,
                                (cudaStream_t)stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The flag protocol's layout, for the wrapper to check its own against:
// 0 the flag words a shard, 1 the most shards, 2 the epoch shift, 3 the
// payload floats a body, 4 + k the word index of RingFlag k in
// (RF_DATA, RF_TRAV, RF_ACK, RF_RET, RF_ENTER, RF_DONE).
extern "C" long long nbt_rdma_flag_geometry(int k) {
    const long long words[] = {RF_DATA, RF_TRAV, RF_ACK, RF_RET, RF_ENTER,
                               RF_DONE};
    switch (k) {
        case 0: return RF_WORDS;
        case 1: return RING_MAX_SHARDS;
        case 2: return RING_EPOCH_SHIFT;
        case 3: return RING_PEER_FLOATS;
    }
    return k >= 4 && k < 10 ? words[k - 4] : -1;
}

// Peer access between every ordered pair of the n cards devs[], enabled
// once (a pair that has it already counts as enabled).  Returns 0, 1 + i *
// n + j when card devs[i] cannot map card devs[j]'s memory, or -(CUDA
// error).  The current card is restored.
extern "C" int nbt_rdma_enable_peers(const int* devs, int n) {
    int cur = 0;
    if (cudaGetDevice(&cur) != cudaSuccess) return -1;
    int rc = 0;
    for (int i = 0; i < n && rc == 0; ++i)
        for (int j = 0; j < n && rc == 0; ++j) {
            if (devs[i] == devs[j]) continue;
            int ok = 0;
            cudaError_t e = cudaDeviceCanAccessPeer(&ok, devs[i], devs[j]);
            if (e != cudaSuccess) { rc = -(int)e; break; }
            if (!ok) { rc = 1 + i * n + j; break; }
            if ((e = cudaSetDevice(devs[i])) != cudaSuccess) {
                rc = -(int)e;
                break;
            }
            e = cudaDeviceEnablePeerAccess(devs[j], 0);
            if (e == cudaErrorPeerAccessAlreadyEnabled)
                cudaGetLastError();
            else if (e != cudaSuccess)
                rc = -(int)e;
        }
    cudaSetDevice(cur);
    return rc;
}

extern "C" int nbt_rdma_ring_tile(void) { return SYM_TILE; }
