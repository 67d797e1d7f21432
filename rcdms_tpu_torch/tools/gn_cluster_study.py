"""The fused GroupNorm's cluster kernel (`csrc/group_norm.cu`,
`ops.group_norm_act`) on the card, bf16, 32 groups, SiLU: device time
from `torch.profiler`.

1. Plans: at the study's shapes and a few story shapes, every (slab of
   groups, cluster size) that fits, beside the plan `ops/group_norm.py::
   _plan` takes and a `copy_` of the same x (one read and one write, the
   least a kernel can move): how near the plan's rule comes to the best.
2. Parts: at (5, 4096, 320) and (5, 4096, 960), with the plan's (slab,
   cluster), builds of the kernel's own source with one part changed,
   into `build/gn_cluster_study/` (nvcc with the library's flags, loaded
   with ctypes): the launch alone, the loads alone, loads and stores with
   no statistics, SiLU by a correctly rounded division, and the loads as
   1-D bulk copies of one token row each (`cp.async.bulk` on one
   mbarrier) issued by one warp or by every warp in place of each
   thread's `cp.async` of its own vectors. The variants compute wrong
   results where they skip a part: they are timed, not checked.

    python -m rcdms_tpu_torch.tools.gn_cluster_study
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch
from torch.profiler import ProfilerActivity, profile

from rcdms_tpu_torch.ops import _build
from rcdms_tpu_torch.ops import group_norm as gn
from rcdms_tpu_torch.tools import card_line, rel_err
from rcdms_tpu_torch.tools import gn_fused_study as gs

SHAPES = gs.SHAPES + [(5, 4096, 960), (10, 64, 2560), (5, 1024, 1920)]
PART_SHAPES = [(5, 4096, 320), (5, 4096, 960)]
STUDY_DIR = _build.BUILD_DIR.parent / "gn_cluster_study"

LOADS = """  for (int r = rl; r < rows; r += L.rl)
    cp_async16(tile + r * L.row_bytes + vl * 16, x + first + (long)r * c +
                                                     ch0, true);
  cp_async_commit();
"""
WAIT = "  cp_async_wait<0>();  // this thread's copies landed\n"
SUMS = "  // ---- per-channel sums of this thread's vectors"
STORES = "  T* out = y + first + ch0;\n"
NORMALISE = "  // ---- normalise, activate and store this thread's rows"
END = ("  cluster_wait();  // no CTA leaves while another may read its "
       "partials\n")
SILU = "      if (SILU) v[e] = __fdividef(v[e], 1.f + __expf(-v[e]));\n"
SMEM_MAX = "kGnSmemMax = 232448;"
# one 1-D bulk copy a token row, all on one mbarrier (static shared
# memory, so the dynamic limit leaves it room), issued by the first
# `COPIERS` threads
BULK = """  __shared__ __align__(8) unsigned long long gn_bar;
  const uint32_t bar = smem_addr(&gn_bar);
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
    mbar_expect_tx(bar, rows * L.row_bytes);
  }
  __syncthreads();
  for (int r = tid; tid < COPIERS && r < rows; r += COPIERS)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\\n" ::"r"(smem_addr(tile + r * L.row_bytes)),
        "l"(x + first + (long)r * c), "r"(L.row_bytes), "r"(bar)
        : "memory");
"""


def variants() -> dict:
    """Name -> the kernel source with one part changed."""
    src = (_build.CSRC / "group_norm.cu").read_text()
    for part in (LOADS, WAIT, SUMS, STORES, NORMALISE, END, SILU, SMEM_MAX):
        if src.count(part) != 1:
            raise RuntimeError("group_norm.cu no longer has the parts this "
                               "study changes")
    head = src[:src.index(SUMS)]
    normalise = src[src.index(NORMALISE):]
    stores = normalise[normalise.index(STORES):]
    no_stats = (head + "  cp_async_wait<0>();\n  float mul[VEC], add[VEC];\n"
                "#pragma unroll\n  for (int e = 0; e < VEC; ++e) mul[e] = "
                "scl[e], add[e] = bia[e];\n" + stores.replace(END, ""))
    bulk = src.replace('#include "common.cuh"\n',
                       '#include "common.cuh"\n#include "wgmma.cuh"\n')
    bulk = bulk.replace(SMEM_MAX, "kGnSmemMax = 232448 - 16;")
    bulk = bulk.replace(LOADS, BULK).replace(WAIT, "  mbar_wait(bar, 0);\n")
    return {
        "launch alone": head.replace(LOADS, "  if (ch0 < 0) y[0] = x[0];\n"
                                     "  return;\n") + normalise,
        "loads alone": head + "  cp_async_wait<0>();\n  return;\n"
                       + normalise,
        "loads and stores, no statistics": no_stats,
        "SiLU by a correct division": src.replace(
            SILU, "      if (SILU) v[e] = v[e] / (1.f + __expf(-v[e]));\n"),
        "bulk copies, one warp": bulk.replace("COPIERS", "32"),
        "bulk copies, every warp": bulk.replace("COPIERS", "L.threads"),
    }


def _build_variant(item) -> str:
    name, src = item
    d = STUDY_DIR / name.replace(" ", "_").replace(",", "")
    d.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, d / header.name)
    (d / "group_norm.cu").write_text(src)
    so = d / "libgroup_norm.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(d / "group_norm.cu")], check=True,
                   capture_output=True, text=True)
    return str(so)


def device_us(fn, reps: int = 20, tries: int = 6) -> float:
    """Microseconds of device time a launch of fn's kernel, over `reps`
    profiled calls after three warm-up calls: each kernel's device time
    over the launches the profiler saw of it (a profile now and then
    misses some), summed over fn's kernels. Raises if `tries` profiles
    see none."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_time_total > 0]
        if events:
            return sum(e.device_time_total / e.count for e in events)
    raise RuntimeError(f"the profiler saw no device time in {tries} tries")


def _call(lib, x, scale, bias, out, plan):
    b, n, c = x.shape
    return lambda: _build.check(lib.rcdms_group_norm_act(
        1, 1, x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, n, c, gs.GROUPS, gs.EPS, plan["slab_groups"],
        plan["cluster"], plan["rows"], plan["threads"], plan["smem"],
        _build.stream(x)), "rcdms_group_norm_act")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gn_cluster_study: needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    lib = _build.library().lib
    with ThreadPoolExecutor() as ex:
        built = dict(zip(variants(), ex.map(_build_variant,
                                            variants().items())))
    libs = {}
    for name, so in built.items():
        libs[name] = ctypes.CDLL(so)
        libs[name].rcdms_group_norm_act.argtypes = _build.SIGNATURES[
            "rcdms_group_norm_act"]
    print(f"{card_line()}  bf16, groups={gs.GROUPS}, SiLU: device us a call")
    for b, n, c in SHAPES:
        x = torch.randn(b, n, c, generator=g, device=dev).bfloat16()
        scale = torch.rand(c, generator=g, device=dev) + 0.5
        bias = torch.randn(c, generator=g, device=dev) * 0.2
        ref = gn.group_norm_act_plain(x, scale, bias, gs.GROUPS, gs.EPS,
                                      "silu")
        y = torch.empty_like(x)
        plan = gn._plan(b, n, c, gs.GROUPS, 2)
        copy_us = device_us(lambda: y.copy_(x))
        print(f"  {b}x{n}x{c}: copy_ {copy_us:.2f} us; "
              f"plan slab {plan['slab_groups']} cluster {plan['cluster']}",
              flush=True)
        times = {}
        for sg in range(1, gs.GROUPS + 1):
            for k in gn.CLUSTERS:
                p = gn._layout(n, c, gs.GROUPS, sg, k, 2)
                if gs.GROUPS % sg or p["row_bytes"] % 16 or not p["threads"] \
                        or p["smem"] > gn.SMEM_MAX:
                    continue
                fn = _call(lib, x, scale, bias, y, p)
                fn()
                err = rel_err(y, ref)
                times[sg, k] = device_us(fn)
                print(f"    slab {sg:2d} cluster {k:2d} rows {p['rows']:5d} "
                      f"{times[sg, k]:8.2f} us  rel_err {err:.1e}",
                      flush=True)
        best = min(times, key=times.get)
        mine = (plan["slab_groups"], plan["cluster"])
        print(f"    plan {times[mine]:.2f} us, best {times[best]:.2f} us at "
              f"slab {best[0]} cluster {best[1]}: "
              f"{times[mine] / times[best]:.2f}x", flush=True)
        if (b, n, c) in PART_SHAPES:
            for name, vlib in libs.items():
                us = device_us(_call(vlib, x, scale, bias, y, plan))
                print(f"    part: {name:32s} {us:8.2f} us", flush=True)


if __name__ == "__main__":
    main()
