"""Static instruction mix of the port's kernels: builds the kernel library
(as the wrappers do at first use) and counts chosen SASS opcodes in each
kernel with the CUDA toolkit's `cuobjdump`:

    python -m rcdms_tpu_torch.tools.sass_mix [substring ...]

One line per kernel whose mangled name holds one of the substrings
(every kernel when none is given): MUFU.EX2 (the special-function unit's
exponential), FMUL, FFMA, FADD, HMUL2 and HFMA2 (bf16x2 / fp16x2
products), HMMA (warp-level tensor-core products: mma.sync and WMMA),
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

OPCODES = ("MUFU.EX2", "FMUL", "FFMA", "FADD", "HMUL2", "HFMA2", "HMMA",
           "HGMMA", "UTMALDG", "UBLKCP", "LDGSTS", "LDSM", "STS", "LDS",
           "SHFL")
_FUNCTION = re.compile(r"Function : (\S+)")
_INSTRUCTION = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)")


def instruction_mix(sass: str) -> dict[str, collections.Counter]:
    """Opcode counts of each function in cuobjdump -sass output."""
    mix, name = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            name = m.group(1)
            mix[name] = collections.Counter()
            continue
        m = _INSTRUCTION.search(line)
        if name is not None and m:
            op = m.group(1)
            mix[name]["total"] += 1
            for key in OPCODES:
                if op == key or op.startswith(key + "."):
                    mix[name][key] += 1
    return mix


def _demangle(names: list[str]) -> list[str]:
    cxxfilt = shutil.which("c++filt")
    if cxxfilt is None:
        return names
    out = subprocess.run([cxxfilt], input="\n".join(names),
                         capture_output=True, text=True, check=True)
    return out.stdout.splitlines()


def main(keys: list[str]) -> None:
    library = _build.library().path
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    mix = {name: counts for name, counts in instruction_mix(sass).items()
           if not keys or any(k in name for k in keys)}
    for name, counts in zip(_demangle(list(mix)), mix.values()):
        name = re.sub(r"\(.*", "",
                      name.replace("(anonymous namespace)::", ""))
        print(f"{name}: " + ", ".join(f"{k} {counts[k]}"
                                      for k in OPCODES + ("total",)))


if __name__ == "__main__":
    main(sys.argv[1:])
