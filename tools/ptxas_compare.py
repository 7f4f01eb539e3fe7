#!/usr/bin/env python3
"""Compare the compiled kernels of two copies of the port's CUDA sources.

    python3 tools/ptxas_compare.py OLD_CSRC NEW_CSRC [name ...] [--ops]
        [--allow PATTERN ...]

Builds ``<name>.cu`` (default: forces_sym, forces_sym_tc) from both source
directories with the port's nvcc flags (``ops/_build.py``), reads ptxas's
``-v`` report for every kernel (registers, spill stores and loads, shared
memory) and disassembles both libraries with ``cuobjdump -sass``.  For each
kernel it prints its numbers in OLD and NEW and whether its SASS is the
same instruction for instruction; kernels only in NEW are listed with
their numbers.  With ``--ops`` it also prints, for every kernel of NEW,
how many of its SASS instructions are of each of the opcodes in ``OPS``
(a static count of the code, not of what runs), and the same for every
kernel of OLD whose SASS differs (``old: `` lines).  Kernels are matched
by their demangled names, with
template arguments ``true``/``false`` read as ``1``/``0`` (a template on
a bool that became one on an int keeps its instantiations' names).
Exits 1 if a kernel of OLD is missing in NEW or its SASS differs, unless
its name matches one of the ``--allow`` regular expressions: the kernels a
change means to redesign, whose numbers are printed all the same.

Needs the CUDA toolkit (nvcc, cuobjdump, cu++filt); builds under
``build/ptxas_compare/``.  To compare a commit with its parent:

    git archive HEAD~1 nbody_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/ptxas_compare.py build/parent/nbody_tpu_torch/csrc \\
        nbody_tpu_torch/csrc
"""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from nbody_tpu_torch.ops._build import NVCC_FLAGS, find_nvcc  # noqa: E402

WORK = os.path.join(ROOT, "build", "ptxas_compare")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
# The opcodes of the pair loops: float32 add / fma / mul, the MUFU rsqrt
# and the compare of rsqrtf's subnormal fix-up (FSETP), warp shuffles,
# shared loads and stores, tensor-core mma, bf16 converts (F2FP), global
# stores, movmatrix.
OPS = ("FADD", "FFMA", "FMUL", "MUFU", "FSETP", "SHFL", "LDS", "STS", "HMMA",
       "F2FP", "STG", "MOVM")


def op_counts(insns):
    counts = dict.fromkeys(OPS, 0)
    for insn in insns:
        op = re.sub(r"^@!?U?P\w+\s+", "", insn).split()[0].split(".")[0]
        if op in counts:
            counts[op] += 1
    return " ".join(f"{k} {v}" for k, v in counts.items())


def tool(name):
    return os.path.join(os.path.dirname(find_nvcc()), name)


def demangle(names):
    out = subprocess.run([tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    plain = out.strip().splitlines()
    return {m: re.sub(r"\(\w+\)(-?\d+)", r"\1",
                      p.replace("<true>", "<1>").replace("<false>", "<0>"))
            for m, p in zip(names, plain)}


def build(csrc, name, tag):
    """(kernel -> {"regs", "spill_st", "spill_ld", "smem"}, kernel ->
    [SASS instructions]) of ``csrc/<name>.cu``, keyed by normalised
    demangled name."""
    os.makedirs(WORK, exist_ok=True)
    so = os.path.join(WORK, f"{tag}_{name}.so")
    log = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", so,
                          os.path.join(csrc, f"{name}.cu")],
                         capture_output=True, text=True, check=True)
    stats, fn = {}, None
    for line in (log.stdout + log.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            stats[fn] = {}
        elif fn and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            stats[fn].update(spill_st=int(st), spill_ld=int(ld))
        elif fn and "Used" in line and "registers" in line:
            stats[fn]["regs"] = int(re.search(r"Used (\d+) registers",
                                              line).group(1))
            m = re.search(r"(\d+) bytes smem", line)
            stats[fn]["smem"] = int(m.group(1)) if m else 0
    sass, fn = {}, None
    dump = subprocess.run([tool("cuobjdump"), "-sass", so],
                          capture_output=True, text=True, check=True).stdout
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            sass[fn] = []
        elif fn:
            m = _INSN.search(line)
            if m:
                sass[fn].append(m.group(1))
    names = demangle(sorted(set(stats) | set(sass)))
    return ({names[k]: v for k, v in stats.items()},
            {names[k]: v for k, v in sass.items()})


def main(argv):
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    ops = "--ops" in argv
    args, allow = [], []
    it = iter(a for a in argv if a != "--ops")
    for a in it:
        if a == "--allow":
            allow.append(re.compile(next(it)))
        else:
            args.append(a)
    old_dir, new_dir, *libs = args
    ok = True
    for lib in libs or ("forces_sym", "forces_sym_tc"):
        old_stats, old_sass = build(old_dir, lib, "old")
        new_stats, new_sass = build(new_dir, lib, "new")
        print(f"== {lib}.cu: registers, spill stores/loads (bytes), smem "
              f"(bytes); old -> new")
        for k in sorted(old_stats):
            o = old_stats[k]
            n = new_stats.get(k)
            allowed = any(a.search(k) for a in allow)
            if n is None:
                print(f"  MISSING in new{' (allowed)' if allowed else ''}: "
                      f"{k}")
                ok &= allowed
                continue
            same = old_sass.get(k) == new_sass.get(k)
            ok &= same or allowed
            print(f"  {k}: {o['regs']} -> {n['regs']} regs, "
                  f"{o['spill_st']}/{o['spill_ld']} -> "
                  f"{n['spill_st']}/{n['spill_ld']} spill, {o['smem']} -> "
                  f"{n['smem']} smem, {len(old_sass.get(k, []))} -> "
                  f"{len(new_sass.get(k, []))} instructions, SASS "
                  f"{'identical' if same else 'DIFFERS'}"
                  f"{' (allowed)' if allowed and not same else ''}")
        for k in sorted(set(new_stats) - set(old_stats)):
            n = new_stats[k]
            print(f"  new: {k}: {n['regs']} regs, {n['spill_st']}/"
                  f"{n['spill_ld']} spill, {n['smem']} smem, "
                  f"{len(new_sass.get(k, []))} instructions")
        if ops:
            print(f"== {lib}.cu (new): SASS instructions by opcode")
            for k in sorted(new_sass):
                print(f"  {k}: {op_counts(new_sass[k])}")
            for k in sorted(k for k in old_sass
                            if old_sass[k] != new_sass.get(k)):
                print(f"  old: {k}: {op_counts(old_sass[k])}")
    print("ptxas_compare: every old kernel's SASS is unchanged"
          + (" but the allowed ones" if allow else "") if ok else
          "ptxas_compare: FAILED: a kernel is missing or its SASS changed")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
