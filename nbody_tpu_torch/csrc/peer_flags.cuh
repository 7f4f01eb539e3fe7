// The signal words of a hop between cards: K13's flag kernel
// (rdma_ring.cu, rdma_flag_kernel) and the peer-copy probe (probes.cu,
// the counterpart of scripts/r8_mosaic_rules.py's remote copy) push a
// payload by peer stores, then release a flag at system scope in the
// receiver's memory; the receiver polls it relaxed and fences once it has
// come, so that its payload reads follow the acquire.

#pragma once

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

__device__ __forceinline__ void flag_store(unsigned long long* f,
                                           unsigned long long v) {
    asm volatile("st.release.sys.global.u64 [%0], %1;"
                 :: "l"(f), "l"(v) : "memory");
}

// Nanoseconds on the card's global timer: the bound of every spin.
__device__ __forceinline__ unsigned long long ring_clock() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
