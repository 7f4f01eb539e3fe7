#!/usr/bin/env python3
"""K13's two protocols on one card, taken apart: where the flag kernel's
extra time goes against the grid-sync kernel.

    python3 tools/k13_protocols.py [--rounds R]

Builds ``csrc/rdma_ring.cu``, prints each kernel's registers and spills
(ptxas) and, for the vpu2 and vpu instantiations of ``rdma_ring_kernel``
(grid syncs) and ``rdma_flag_kernel`` (flags), every loop of its SASS that
holds a MUFU rsqrt: instructions, MUFU, local and shared loads (the pair
loops are the ones with 32 MUFU).  Then, in alternating rounds of the
card's time alone (``chip_smoke.device_ms``), vpu2 sequential at N = 1M on
4 shards run to its first 1, 2 and 3 phases (the self sweep, then the
two-sided phase, then the antipodal one) under each protocol, one shard of
262,144 bodies (no hop: the flag kernel as one group of every CTA), and at
N = 8192 on 4 shards the card's time and the host's enqueue time a call
of the grid-sync kernel, the flag kernel, and the flag kernel as two
launches on two streams.  Each output is held bit-equal to the grid-sync
kernel's.  Needs the card (about a minute and a half).
"""

import argparse
import os
import re
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def mufu_loops(so):
    """{demangled kernel: [(instructions, MUFU, LDL, LDS), ...]} of the
    vpu2 / vpu instantiations of K13's two kernels: every loop (a backward
    branch's span) with a MUFU."""
    from ptxas_compare import _BRA, demangle, opcode, sass
    dump = sass(so)
    names = demangle(list(dump))
    out = {}
    for fn, insns in dump.items():
        name = names[fn]
        if not re.search(r"rdma_(ring|flag)_kernel<[01]>", name):
            continue
        at = {a: i for i, (a, _) in enumerate(insns)}
        loops = set()
        for i, (addr, insn) in enumerate(insns):
            m = _BRA.search(insn)
            target = int(m.group(1), 16) if m else addr
            if target < addr and target in at:
                ops = [opcode(x) for _, x in insns[at[target]:i + 1]]
                if "MUFU" in ops:
                    loops.add((len(ops), ops.count("MUFU"), ops.count("LDL"),
                               ops.count("LDS")))
        out[name] = sorted(loops)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.parallel import rdma_ring as k13
    from nbody_tpu_torch.utils.device import nvidia_smi_line
    smi = nvidia_smi_line()
    print(f"[k13] {smi}")
    _build.build_all(["rdma_ring"])
    _build.load("rdma_ring")
    for line in _build.BUILD_LOG["rdma_ring"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[k13] {line.strip()}")
    for name, loops in mufu_loops(str(_build.library_path("rdma_ring"))
                                  ).items():
        print(f"[k13] {name}: MUFU loops (instructions, MUFU, LDL, LDS) "
              f"{loops}")

    dev = torch.device("cuda")
    eps2 = 0.002
    budget = k13.SLOT_BUDGET_BYTES

    def forms(pos, mass, p, phases, streams=False):
        out = {proto: (lambda proto=proto: k13._launch(
            pos, mass, p, eps2, "vpu2", False, False, budget, phases=phases,
            protocol=proto)) for proto in ("grid", "flags")}
        if streams:
            out["flags, 2 launches"] = lambda: k13._launch(
                pos, mass, p, eps2, "vpu2", False, False, budget,
                phases=phases, protocol="flags", streams=2)
        return out

    def rounds(what, fns, host=False):
        want = fns["grid"]()
        for k, fn in fns.items():
            cs.check(torch.equal(fn(), want), f"{what}: {k} differs")
        names = list(fns)
        times = {k: [] for k in names}
        for r in range(args.rounds):
            for k in (names if r % 2 == 0 else names[::-1]):
                times[k].append(cs.device_ms(fns[k], 1))
        k13.check_errors()
        med = {k: statistics.median(v) for k, v in times.items()}
        line = ", ".join(f"{k} {med[k]:.3f}" for k in names)
        if host:
            enq = {}
            for k, fn in fns.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(50):
                    fn()
                enq[k] = (time.perf_counter() - t) / 50 * 1e3
                torch.cuda.synchronize()
            line += "; the host's enqueue ms a call: " + ", ".join(
                f"{k} {v:.4f}" for k, v in enq.items())
        print(f"[k13] {what}, card ms (median of {args.rounds} rounds): "
              f"{line}; flags / grid {med['flags'] / med['grid']:.4f} "
              f"({smi})")

    pos, mass = cs.rdma_shards(1 << 20, 4, 5, dev)
    for phases in (1, 2, 3):
        rounds(f"1M on 4 shards, the first {phases} phase(s)",
               forms(pos, mass, 4, phases))
    one, one_m = cs.rdma_shards(1 << 18, 1, 5, dev)
    rounds("262,144 on one shard", forms(one, one_m, 1, 0))
    small, small_m = cs.rdma_shards(8192, 4, 5, dev)
    rounds("8192 on 4 shards", forms(small, small_m, 4, 0, streams=True),
           host=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
