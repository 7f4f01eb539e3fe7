// K2-rect: the reduce pass shared by the rectangular pair-symmetric sweeps
// of forces_sym.cu (vpu2, vpu, fold) and forces_sym_tc.cu (turbo, mxu,
// turbo2, turbof, turbop).
//
// Replaces the accumulator side of nbody_tpu/ops/forces_pallas_sym.py:
// _rect_call (its blocked acc_a output and resident acc_bT scatter buffer,
// the _unscatter relayout and the 1/m of _inv_mass_scale, as
// _rect_sym_padded composes them).
//
// The rect sweep.  For two disjoint body sets A (na bodies) and B (nb),
// every A x B pair is computed once and feeds both sides.  A is cut into
// na_s row superblocks and B into nb_s column superblocks of u bodies
// (u = SYM_TILE for the classic and tensor-core sweeps, sub * SYM_TILE for
// the fold schedule); tails are masked at load time (a slot past na or nb
// loads as a zero-mass body at the origin, which adds exactly 0 on both
// sides).  Every (IA, JB) superblock pair is one CTA: no diagonal, no
// self-pair mask.  Column superblocks run in chunks j_lo .. j_lo+jc-1 whose
// slots fit the wrapper's budget.  CTA (IA, JB) writes
//   its row sums    to slot si[JB - j_lo][IA's rows]      (na_pad x 3 each)
//   its column sums to slot sj[IA][JB - j_lo][JB's cols]  (u x 3 each)
// so every slot has one writer and no atomics are used.  This pass then
// adds, for each A body, its jc row slots in column order into the running
// sum raw_a (finished on the last chunk), and for each B body of the
// chunk, its na_s column slots in row order (finished at once: a column
// superblock lives in one chunk).  Results are bit-reproducible.
//
// Mass-scaled sums (vpu2, turbof: the shared weight F = m_i m_j inv) are
// divided by the receiving body's mass.  A real body of mass 0 cannot be
// descaled; its cross sum is recomputed one-sided over the other set
// (m_j weights), where JAX's _inv_mass_scale maps 1/0 to 0 and leaves it
// with nothing from the other set.

#pragma once

#include "sym_common.cuh"

// A real body's cross acceleration from its summed slots s: s itself, or
// with `descale` s / m, and for m = 0 its row swept one-sided over the
// n_o bodies of the other set.
__device__ __forceinline__ float3 rect_finish(
        float3 s, float m, float4 bi, const float* __restrict__ pos_o,
        const float* __restrict__ mass_o, long long n_o, int descale,
        float eps2) {
    if (!descale) return s;
    if (m != 0.f) {
        const float inv_m = 1.0f / m;
        return make_float3(s.x * inv_m, s.y * inv_m, s.z * inv_m);
    }
    float ax = 0.f, ay = 0.f, az = 0.f;
    for (long long jj = 0; jj < n_o; ++jj) {
        const float dx = pos_o[3 * jj] - bi.x;
        const float dy = pos_o[3 * jj + 1] - bi.y;
        const float dz = pos_o[3 * jj + 2] - bi.z;
        const float d2 = dx * dx + dy * dy + dz * dz + eps2;
        const float f = mass_o[jj] * rsqrtf(d2 * d2 * d2);
        ax += f * dx;
        ay += f * dy;
        az += f * dz;
    }
    return make_float3(ax, ay, az);
}

// Grid: na_s * u / SYM_TILE blocks for the A side, then jc * u / SYM_TILE
// blocks for the chunk's B columns.
__global__ void __launch_bounds__(SYM_TILE)
rect_reduce_kernel(const float* __restrict__ pos_a,
                   const float* __restrict__ mass_a, long long na,
                   const float* __restrict__ pos_b,
                   const float* __restrict__ mass_b, long long nb,
                   long long na_s, long long u, long long j_lo, long long jc,
                   const float* __restrict__ si,
                   const float* __restrict__ sj, float* __restrict__ raw_a,
                   int first, int last, int descale, float eps2,
                   float* __restrict__ acc_a, float* __restrict__ acc_b) {
    const long long na_pad = na_s * u;
    const long long a_blocks = na_pad / SYM_TILE;
    const long long blk = blockIdx.x;
    if (blk < a_blocks) {
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
        if (!last) {
            raw_a[3 * i] = s.x;
            raw_a[3 * i + 1] = s.y;
            raw_a[3 * i + 2] = s.z;
            return;
        }
        if (i >= na) return;
        const float3 a = rect_finish(s, mass_a[i],
                                     load_body(pos_a, mass_a, i, na), pos_b,
                                     mass_b, nb, descale, eps2);
        acc_a[3 * i] = a.x;
        acc_a[3 * i + 1] = a.y;
        acc_a[3 * i + 2] = a.z;
        return;
    }
    const long long local = (blk - a_blocks) * SYM_TILE + threadIdx.x;
    const long long j = j_lo * u + local;
    float3 s = make_float3(0.f, 0.f, 0.f);
    for (long long IA = 0; IA < na_s; ++IA) {
        const long long o = (IA * jc * u + local) * 3;
        s.x += sj[o];
        s.y += sj[o + 1];
        s.z += sj[o + 2];
    }
    if (j >= nb) return;
    const float3 b = rect_finish(s, mass_b[j],
                                 load_body(pos_b, mass_b, j, nb), pos_a,
                                 mass_a, na, descale, eps2);
    acc_b[3 * j] = b.x;
    acc_b[3 * j + 1] = b.y;
    acc_b[3 * j + 2] = b.z;
}

static int launch_rect_reduce(const float* pos_a, const float* mass_a,
                              long long na, const float* pos_b,
                              const float* mass_b, long long nb,
                              long long na_s, long long u, long long j_lo,
                              long long jc, const float* si, const float* sj,
                              float* raw_a, int first, int last, int descale,
                              float eps2, float* acc_a, float* acc_b,
                              void* stream) {
    if (u % SYM_TILE) return (int)cudaErrorInvalidValue;
    const long long blocks = (na_s + jc) * (u / SYM_TILE);
    rect_reduce_kernel<<<(unsigned)blocks, SYM_TILE, 0,
                         (cudaStream_t)stream>>>(
        pos_a, mass_a, na, pos_b, mass_b, nb, na_s, u, j_lo, jc, si, sj,
        raw_a, first, last, descale, eps2, acc_a, acc_b);
    return (int)cudaGetLastError();
}
