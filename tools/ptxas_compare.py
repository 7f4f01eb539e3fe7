#!/usr/bin/env python3
"""Compare the compiled kernels of two copies of the port's CUDA sources.

    python3 tools/ptxas_compare.py OLD_CSRC NEW_CSRC [name ...] [--ops]
        [--allow PATTERN ...] [--same OLD_PATTERN NEW_PATTERN ...]

Builds ``<name>.cu`` (default: forces_sym, forces_sym_tc) from both source
directories with the port's nvcc flags (``ops/_build.py``), reads ptxas's
``-v`` report for every kernel (registers, spill stores and loads, shared
memory) and disassembles both libraries with ``cuobjdump -sass``.  For each
kernel it prints its numbers in OLD and NEW and whether its SASS is the
same instruction for instruction; kernels only in NEW are listed with
their numbers.  With ``--ops`` it also prints, for every kernel of NEW,
how many of its SASS instructions are of each of the opcodes in ``OPS``
(a static count of the code, not of what runs) and, for a kernel with a
loop, the instructions and MUFU of its longest loop and their ratio, the
issue slots a pair of a pair loop (one rsqrt a pair); and the same for
every kernel of OLD whose SASS differs (``old: `` lines).  Kernels are matched
by their demangled names, with
template arguments ``true``/``false`` read as ``1``/``0`` (a template on
a bool that became one on an int keeps its instantiations' names).
Exits 1 if a kernel of OLD is missing in NEW or its SASS differs, unless
its name matches one of the ``--allow`` regular expressions: the kernels a
change means to redesign, whose numbers are printed all the same.  Each
``--same OLD_PATTERN NEW_PATTERN`` names an old kernel that lives on
under another name (a new template argument): the one kernel of OLD
matching the first pattern and the one of NEW matching the second, in
one library, must have the same SASS, or the exit is 1.

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
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\b.*?\b0x([0-9a-f]+)")
# The opcodes of the pair loops: float32 add / fma / mul, the MUFU rsqrt
# and the compare of rsqrtf's subnormal fix-up (FSETP), warp shuffles,
# shared loads and stores, tensor-core mma, bf16 converts (F2FP), global
# stores, movmatrix.
OPS = ("FADD", "FFMA", "FMUL", "MUFU", "FSETP", "SHFL", "LDS", "STS", "HMMA",
       "F2FP", "STG", "MOVM")


def opcode(insn):
    return re.sub(r"^@!?U?P\w+\s+", "", insn).split()[0].split(".")[0]


def main_loop(insns):
    """The instructions of a kernel's longest loop, from the target of its
    longest backward branch to that branch, of its (address, instruction)
    pairs; None without one.  The pair loops take one MUFU (the rsqrt) a
    pair, so instructions / MUFU are their issue slots a pair."""
    span = None
    for addr, insn in insns:
        m = _BRA.search(insn)
        target = int(m.group(1), 16) if m else addr
        if target < addr and (span is None
                              or addr - target > span[1] - span[0]):
            span = (target, addr)
    if span is None:
        return None
    return [insn for addr, insn in insns if span[0] <= addr <= span[1]]


def op_counts(insns):
    counts = dict.fromkeys(OPS, 0)
    for _, insn in insns:
        op = opcode(insn)
        if op in counts:
            counts[op] += 1
    text = " ".join(f"{k} {v}" for k, v in counts.items())
    loop = main_loop(insns) or ()
    mufu = sum(opcode(insn) == "MUFU" for insn in loop)
    if mufu:
        text += (f"; loop {len(loop)} instructions, {mufu} MUFU: "
                 f"{len(loop) / mufu:.2f} a pair")
    return text


def tool(name):
    return os.path.join(os.path.dirname(find_nvcc()), name)


def demangle(names):
    out = subprocess.run([tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, check=True).stdout
    plain = out.strip().splitlines()
    return {m: re.sub(r"\(\w+\)(-?\d+)", r"\1",
                      p.replace("<true>", "<1>").replace("<false>", "<0>"))
            for m, p in zip(names, plain)}


def sass(so):
    """mangled kernel name -> [(address, SASS instruction)] of the library
    ``so``."""
    out, fn = {}, None
    dump = subprocess.run([tool("cuobjdump"), "-sass", so],
                          capture_output=True, text=True, check=True).stdout
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = []
        elif fn:
            m = _INSN.search(line)
            if m:
                out[fn].append((int(m.group(1), 16), m.group(2)))
    return out


def loop_slots(so, prefix, ops=("LOP3",)):
    """(issue slots, then each opcode of ``ops``) a pair of the longest
    loop of the kernel of library ``so`` whose mangled name starts with
    ``prefix`` (its instructions over its MUFU, one rsqrt a pair), or
    None."""
    for fn, insns in sass(so).items():
        if fn.startswith(prefix):
            body = main_loop(insns)
            mufu = sum(opcode(i) == "MUFU" for i in body or ())
            if not mufu:
                return None
            return (len(body) / mufu,
                    *(sum(opcode(i) == op for i in body) / mufu
                      for op in ops))
    return None


def build(csrc, name, tag):
    """(kernel -> {"regs", "spill_st", "spill_ld", "smem"}, kernel ->
    [(address, SASS instruction)]) of ``csrc/<name>.cu``, keyed by
    normalised demangled name."""
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
    code = sass(so)
    names = demangle(sorted(set(stats) | set(code)))
    return ({names[k]: v for k, v in stats.items()},
            {names[k]: v for k, v in code.items()})


def main(argv):
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    ops = "--ops" in argv
    args, allow, same_as = [], [], []
    it = iter(a for a in argv if a != "--ops")
    for a in it:
        if a == "--allow":
            allow.append(re.compile(next(it)))
        elif a == "--same":
            same_as.append((re.compile(next(it)), re.compile(next(it))))
        else:
            args.append(a)
    old_dir, new_dir, *libs = args
    ok = True
    found = set()
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
        for k, (old_pat, new_pat) in enumerate(same_as):
            olds = [n for n in old_sass if old_pat.search(n)]
            news = [n for n in new_sass if new_pat.search(n)]
            if not olds and not news:
                continue
            found.add(k)
            hit = (len(olds) == 1 and len(news) == 1
                   and old_sass[olds[0]] == new_sass[news[0]])
            ok &= hit
            print(f"  same: {olds} (old) as {news} (new): SASS "
                  f"{'identical' if hit else 'DIFFERS or not one each'}")
        if ops:
            print(f"== {lib}.cu (new): SASS instructions by opcode")
            for k in sorted(new_sass):
                print(f"  {k}: {op_counts(new_sass[k])}")
            for k in sorted(k for k in old_sass
                            if old_sass[k] != new_sass.get(k)):
                print(f"  old: {k}: {op_counts(old_sass[k])}")
    for k, (old_pat, new_pat) in enumerate(same_as):
        if k not in found:
            print(f"  same: no kernel matches {old_pat.pattern} / "
                  f"{new_pat.pattern}")
            ok = False
    print("ptxas_compare: every old kernel's SASS is unchanged"
          + (" but the allowed ones" if allow else "") if ok else
          "ptxas_compare: FAILED: a kernel is missing or its SASS changed")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
