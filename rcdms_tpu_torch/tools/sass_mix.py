"""Static instruction mix of the port's kernels: builds the kernel library
(as the wrappers do at first use) and counts chosen SASS opcodes in each
kernel with the CUDA toolkit's `cuobjdump`:

    python -m rcdms_tpu_torch.tools.sass_mix [--loops] [substring ...]

One line per kernel whose mangled name holds one of the substrings
(every kernel when none is given); with `--loops`, one more line per
innermost loop of the kernel (a backward branch and the instructions from
its target to it, holding no other backward branch), which is what an
element of a row kernel costs in its steady state: MUFU.EX2 (the special-function unit's
exponential), FMUL, FFMA, FADD, HMUL2 and HFMA2 (bf16x2 / fp16x2
products), HMNMX2 and VHMNMX (bf16x2 / fp16x2 max and min; `__hmax2`
on bf16 pairs is VHMNMX on sm_90a), HMMA (warp-level tensor-core products: mma.sync and WMMA),
HGMMA (warpgroup products: wgmma), UTMALDG (TMA tile loads), UBLKCP (1-D
TMA bulk copies), LDGSTS (cp.async), LDSM (ldmatrix), STS and LDS (plain
shared-memory stores and loads, e.g. a WMMA accumulator staged through
shared memory), SHFL (warp shuffles) and all instructions. The counts
are of the compiled code, not of executed instructions: they show which
instructions a source line became, e.g. that `__expf(x)` and `exp2f(x *
log2 e)` both become one FMUL and one MUFU.EX2.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

from rcdms_tpu_torch.ops import _build

OPCODES = ("MUFU.EX2", "FMUL", "FFMA", "FADD", "HMUL2", "HFMA2", "HMNMX2",
           "VHMNMX", "HMMA", "HGMMA", "UTMALDG", "UBLKCP", "LDGSTS", "LDSM",
           "STS", "LDS", "SHFL")
_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA(?:\.\w+)*\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def _count(counts: collections.Counter, op: str) -> None:
    counts["total"] += 1
    for key in OPCODES:
        if op == key or op.startswith(key + "."):
            counts[key] += 1


def _opcodes(code, lo: int, hi: int) -> collections.Counter:
    """Every opcode (its name before the first dot) from address lo to
    hi."""
    return collections.Counter(op.split(".")[0] for addr, op, _ in code
                               if lo <= addr <= hi)


def _functions(sass: str):
    """(name, [(address, opcode, line)], {label: address}) of each
    function in cuobjdump -sass output."""
    out = []
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            out.append((m.group(1), [], {}, []))
            continue
        if not out:
            continue
        labels, pending = out[-1][2], out[-1][3]
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTRUCTION.search(line)
        if m:
            addr = int(m.group(1), 16)
            out[-1][1].append((addr, m.group(2), line))
            for label in pending:
                labels[label] = addr
            pending.clear()
    return [(name, code, labels) for name, code, labels, _ in out]


def instruction_mix(sass: str) -> dict[str, collections.Counter]:
    """Opcode counts of each function in cuobjdump -sass output."""
    mix = {}
    for name, code, _ in _functions(sass):
        mix[name] = collections.Counter()
        for _, op, _ in code:
            _count(mix[name], op)
    return mix


def inner_loops(sass: str) -> dict[str, list]:
    """Each function's innermost loops: (first address, last address,
    opcode counts, counts of every opcode) of every backward branch's span
    that holds no other backward branch."""
    loops = {}
    for name, code, labels in _functions(sass):
        spans = []
        for addr, op, line in code:
            m = _TARGET.search(line) if op.startswith("BRA") else None
            if m is None:
                continue
            target = labels.get(m.group(1)) if m.group(1) else int(
                m.group(2), 16)
            if target is not None and target < addr:  # not the trap
                spans.append((target, addr))
        inner = [s for s in spans if not any(
            o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]
        loops[name] = []
        for lo, hi in sorted(set(inner)):
            counts = collections.Counter()
            for addr, op, _ in code:
                if lo <= addr <= hi:
                    _count(counts, op)
            loops[name].append((lo, hi, counts, _opcodes(code, lo, hi)))
    return loops


def _demangle(names: list[str]) -> list[str]:
    cxxfilt = shutil.which("c++filt")
    if cxxfilt is None:
        return names
    out = subprocess.run([cxxfilt], input="\n".join(names),
                         capture_output=True, text=True, check=True)
    return out.stdout.splitlines()


def main(args: list[str]) -> None:
    loops = "--loops" in args
    keys = [a for a in args if a != "--loops"]
    library = _build.library().path
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    mix = {name: counts for name, counts in instruction_mix(sass).items()
           if not keys or any(k in name for k in keys)}
    spans = inner_loops(sass) if loops else {}
    for mangled, name, counts in zip(mix, _demangle(list(mix)),
                                     mix.values()):
        name = re.sub(r"\(.*", "",
                      name.replace("(anonymous namespace)::", ""))
        print(f"{name}: " + ", ".join(f"{k} {counts[k]}"
                                      for k in OPCODES + ("total",)))
        for lo, hi, c, every in spans.get(mangled, []):
            print(f"  inner loop {lo:#06x}-{hi:#06x}: " + ", ".join(
                f"{k} {c[k]}" for k in OPCODES + ("total",) if c[k])
                + "; by opcode: " + ", ".join(
                    f"{k} {n}" for k, n in every.most_common()))


if __name__ == "__main__":
    main(sys.argv[1:])
