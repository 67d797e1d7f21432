"""Kernel A's two overlaps at the UNet's level 0 (bf16, (1, 5, 4096, 320),
8 heads, l from the rounded P), and the cost of its parts: builds of
`csrc/attention.cu` with one part changed, into
`build/attention_overlap_study/` (nvcc with the library's flags, loaded
with ctypes), beside the library's own build and SDPA on the same q, k, v.

Overlaps (each build still computes A):
- ping-pong: the two consumer warpgroups take turns issuing their
  products (two named barriers), so one's exponentials run while the
  other's products run; off, each issues as soon as its operands are in;
- intra-warpgroup: a warpgroup takes the next tile's exponentials while
  its own P V runs; off, it waits for both its products first.
Parts (timed, not checked: their outputs are wrong where they skip a
part): no exponentials (the FFMA argument stands for P), no P V (P is
still packed), no K/V loads (the producer completes each ring stage with
no TMA load, so the consumers read stale tiles).

Each build's device time a call (`torch.profiler`), in turns (each build
in order, then in reverse), its share of the bound (the exponentials on
MUFU.EX2) and its event time (the wrapper's host time included for the
library's build only); for the overlap builds also the error against
the plain version and the share of bf16 outputs off its bits.

    python -m rcdms_tpu_torch.tools.attention_overlap_study
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.ops import _build
from rcdms_tpu_torch.ops.flash import _plan, attention_plain, flash_attention
from rcdms_tpu_torch.tools import (
    bound_ms,
    card_line,
    device_us,
    median_ms,
    rel_err,
)

SHAPE, HEADS, ROW_SUM = (1, 5, 4096, 320), 8, "rounded"
STUDY_DIR = _build.BUILD_DIR.parent / "attention_overlap_study"
PING_PONG = "constexpr bool kPingPong = true;"
OVERLAP = "constexpr bool kOverlap = true;"
# the parts: (text of attention.cu, its stand-in)
EXP = ("s[i] = fast_exp2(fmaf(s[i], scale_log2, -ms[(i / 2) % 2]));",
       "s[i] = fmaf(s[i], scale_log2, -ms[(i / 2) % 2]);")
PV = ("      wgmma_rs<NV, 1>(oacc, pf[kk],",
      "      if (0) wgmma_rs<NV, 1>(oacc, pf[kk],")
LOADS = [("(with_v ? 2 : 1) * T::NB * T::BOX);", "0);"),
         ("          tma_load_4d_multicast(st + c * T::BOX + half, &kmap",
          "          if (0) tma_load_4d_multicast(st + c * T::BOX + half, "
          "&kmap"),
         ("          if (with_v)\n", "          if (0)\n")]
PARTS = ("no exponentials", "no P V", "no K/V loads")


def variants() -> dict:
    """Source of each build with an overlap turned off or a part left
    out."""
    src = (_build.CSRC / "attention.cu").read_text()

    def sub(*pairs) -> str:
        s = src
        for old, new in pairs:
            if s.count(old) != 1:
                raise RuntimeError(f"attention.cu no longer holds {old!r} "
                                   f"once")
            s = s.replace(old, new)
        return s

    def off(flag: str) -> tuple:
        return flag, flag.replace("true", "false")

    return {"no ping-pong": sub(off(PING_PONG)),
            "no intra-warpgroup overlap": sub(off(OVERLAP)),
            "neither": sub(off(PING_PONG), off(OVERLAP)),
            "no exponentials": sub(EXP),
            "no P V": sub(PV),
            "no K/V loads": sub(*LOADS)}


def _build_variant(item) -> str:
    name, src = item
    d = STUDY_DIR / name.replace(" ", "_").replace("/", "")
    d.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    (d / "attention.cu").write_text(src)
    so = d / "libattention.so"
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(so), str(d / "attention.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{out.stdout}"
                           f"{out.stderr}")
    return str(so)


def _launcher(lib, q, k, v, out):
    """The build's launch on the library's plan, as `_attention` makes
    it."""
    b, f, s, c = q.shape
    dh = c // HEADS
    p = _plan(dh, ROW_SUM)
    return lambda: _build.check(lib.rcdms_attention_fwd(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * f,
        HEADS, s, s, dh, dh ** -0.5, p["dp"], p["nv"], p["bn"], p["bq"],
        p["stages"], p["cluster"], p["row_sum"], p["smem"],
        _build.stream(q)), "rcdms_attention_fwd")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attention_overlap_study: needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn(SHAPE, generator=g, device=dev).bfloat16()
               for _ in range(3))
    b, f, s, c = SHAPE
    dh = c // HEADS
    _build.library()
    with ThreadPoolExecutor() as ex:
        built = dict(zip(variants(), ex.map(_build_variant,
                                            variants().items())))
    calls = {"shipped": lambda: flash_attention(q, k, v, HEADS,
                                                row_sum=ROW_SUM)}
    outs = {"shipped": None}
    for name, so in built.items():
        lib = ctypes.CDLL(so)
        lib.rcdms_attention_fwd.argtypes = _build.SIGNATURES[
            "rcdms_attention_fwd"]
        outs[name] = torch.empty_like(q)
        calls[name] = _launcher(lib, q, k, v, outs[name])
    ref = attention_plain(q, k, v, HEADS, dh ** -0.5, row_sum=ROW_SUM)
    bh = b * f * HEADS
    bound, bound_by = bound_ms(4 * bh * s * s * dh, bh * s * s)
    print(f"{card_line()}  kernel A, bf16, {SHAPE} {HEADS} heads, "
          f"row_sum={ROW_SUM}: bound {bound:.4f} ms ({bound_by})",
          flush=True)
    for name, fn in calls.items():
        out = fn()
        torch.cuda.synchronize()
        if name in PARTS:
            print(f"  {name:28s} event {median_ms(fn):.4f} ms", flush=True)
            continue
        out = outs[name] if out is None else out
        print(f"  {name:28s} rel_err {rel_err(out, ref):.3e}, outputs off "
              f"the plain version {(out != ref).float().mean().item():.4f}"
              f", event {median_ms(fn):.4f} ms", flush=True)
    heads = [t.reshape(b * f, s, HEADS, dh).transpose(1, 2)
             for t in (q, k, v)]

    def sdpa():
        return F.scaled_dot_product_attention(*heads, scale=dh ** -0.5)

    for name in list(calls) + list(calls)[::-1]:
        us = sum(device_us(calls[name]).values())
        print(f"  device {name:28s} {us:9.2f} us "
              f"({bound * 1e3 / us:.1%} of bound)", flush=True)
    for _ in range(2):
        us = sum(device_us(sdpa).values())
        print(f"  device {'SDPA':28s} {us:9.2f} us, event "
              f"{median_ms(sdpa):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
