"""Kernel A at the UNet's level 0 with the row sum l taken from the fp32 P
(the kernel as `csrc/attention.cu` has it) against a variant that sums the
bf16-rounded P, as the TPU's `_nt_kernel` does: device time a call from
`torch.profiler` and each one's error against the plain version of the
UNet's family (`row_sum="rounded"`).

The variant is built here from the kernel's own source, with the two
lines that add p to l replaced, into `build/row_sum_study/` (nvcc with the
library's flags, loaded with ctypes), so the kernel that ships stays as it
is. The two alternate: kernel, variant, variant, kernel.

    python -m rcdms_tpu_torch.tools.attention_row_sum_study
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess

import torch

from rcdms_tpu_torch.ops import _build
from rcdms_tpu_torch.ops.flash import _plan, attention_plain
from rcdms_tpu_torch.tools import card_line, rel_err
from rcdms_tpu_torch.tools.conv_device_times import device_us

FP32_SUM = """      l[mt][0] += p0 + p1;  // l from the unrounded p
      l[mt][1] += p2 + p3;
"""
ROUNDED_SUM = "".join(
    f"      l[mt][{i}] += bf16_lo(pack_bf16({a}, {b})) + "
    f"bf16_hi(pack_bf16({a}, {b}));\n"
    for i, a, b in ((0, "p0", "p1"), (1, "p2", "p3")))
STUDY_DIR = _build.BUILD_DIR.parent / "row_sum_study"
SHAPE, HEADS = (1, 5, 4096, 320), 8  # UNet level 0 self-attention


def build_variant() -> ctypes.CDLL:
    """The kernel library's attention source with l summed from the
    rounded P, built alone; its entry point has the library's signature."""
    source = (_build.CSRC / "attention.cu").read_text()
    if source.count(FP32_SUM) != 1:
        raise RuntimeError("attention.cu no longer sums l as this study "
                           "expects")
    STUDY_DIR.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, STUDY_DIR / header.name)
    (STUDY_DIR / "attention.cu").write_text(
        source.replace(FP32_SUM, ROUNDED_SUM))
    target = STUDY_DIR / "libattention_rounded_sum.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(target), str(STUDY_DIR / "attention.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(target))
    lib.rcdms_attention_fwd.argtypes = _build.SIGNATURES["rcdms_attention_fwd"]
    lib.rcdms_attention_fwd.restype = ctypes.c_int
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attention_row_sum_study: needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=g, device=dev).bfloat16()
               for _ in range(3))
    dh = SHAPE[-1] // HEADS
    plan = _plan(dh)
    libs = {"kernel (l from fp32 P)": _build.library().lib,
            "variant (l from rounded P)": build_variant()}

    def call(lib):
        out = torch.empty_like(q)
        _build.check(lib.rcdms_attention_fwd(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            SHAPE[0] * SHAPE[1], HEADS, SHAPE[2], SHAPE[2], dh, dh ** -0.5,
            plan["dp"], plan["n_tiles"], plan["bq"], plan["smem"],
            _build.stream(q)), "rcdms_attention_fwd")
        return out

    ref = attention_plain(q, k, v, HEADS, dh ** -0.5, row_sum="rounded")
    print(f"{card_line()}  kernel A, bf16, {SHAPE} {HEADS} heads: device "
          f"us a call; error against the plain version, row_sum='rounded'")
    for name, lib in libs.items():
        out = call(lib)
        print(f"  {name:28s} rel_err {rel_err(out, ref):.3e}, outputs off "
              f"the plain version {(out != ref).float().mean().item():.4f}")
    names = list(libs)
    for name in names + names[::-1]:
        us = sum(device_us(lambda: call(libs[name])).values())
        print(f"  {name:28s} {us:9.2f} us", flush=True)


if __name__ == "__main__":
    main()
