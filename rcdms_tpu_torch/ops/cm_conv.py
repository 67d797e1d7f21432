"""The channel-major 3x3 SAME conv of the level-0 conv study: the port's
counterpart of `tools/cm_conv_study.py::cm_conv_pallas`.

The study embeds each (h, w) frame in a zero ring, (h + 2) x (w + 2), and
lays it out channel-major as one row of T >= (h + 2)(w + 2) tokens, so the
conv's tap (dy, dx) is the plain token offset dy * wp + dx (wp = w + 2):

    out[b, d, t] = mask[t] * round(bias[d] + sum_s sum_c w9[s, c, d]
                                              * x[b, c, t + TAPS[s]])

x (B, C, T), w9 (9, C, Cout) with taps s = 3 (dy + 1) + (dx + 1), bias
(Cout,), mask (T,), all one dtype; out (B, Cout, T). Sums in fp32, the bias
added, rounded to x.dtype, then multiplied by the mask (1 on the frame's
interior, 0 on the ring and the tail, which become the next conv's zero
padding). Taps reading outside [0, T) read zero. `shifts=False` drops the
tap offsets: every tap reads x[b, c, t], the study's pure-product row.

`cm_conv3x3` dispatches on where x lies: on the CPU it runs
`cm_conv3x3_plain`; on a CUDA device it launches `csrc/cm_conv.cu` or
raises. bf16 with T and Cout multiples of 8 and 16-byte aligned x and w9
(what TMA needs; any C and any wp) takes the tensor-core kernels with the
launch plan of `_plan`: one lays x out token-major into a scratch the
wrapper allocates, (B, wp + 1 + T, C rounded up to 8), then an implicit
GEMM on TMA + `wgmma` reads each tap's x tile from it at a row offset.
Every other shape, and fp32, takes the CUDA-core kernel. The GEMM is bound
by its products and by the L2 traffic of its repeated tile reads (each tap
reloads its x and weight tiles), not by device memory.
`cm_conv3x3.launches` counts launches, `cm_conv3x3.tensor_launches` those
that took the tensor-core kernel.
"""

from __future__ import annotations

import torch

from rcdms_tpu_torch.ops import _build

BN, KC, STAGES = 96, 64, 4   # tokens a block, channels a stage, ring depth
MAX_MT = 5                   # m64 tiles of output channels a block
THREADS = 384                # a producer and two consumer warpgroups
W_TILE = 64 * KC * 2         # bytes of a w9 TMA box, [64 channels][64 Cout]
X_TILE = BN // 2 * KC * 2    # bytes of an xt TMA box, [48 tokens][64]
REGISTERS = 65536            # 32-bit registers of one H100 SM
# registers a thread of the producer / a consumer warpgroup keeps after
# setmaxnreg (csrc/cm_conv.cu)
PRODUCER_REGS, CONSUMER_REGS = 40, 232


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tap_offsets(wp: int, shifts: bool = True) -> list[int]:
    """Token offset of each of the nine taps, s = 3 (dy + 1) + (dx + 1)."""
    return [dy * wp + dx if shifts else 0
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _plan(b: int, c: int, cout: int, t: int, wp: int) -> dict:
    """Launch plan of the bf16 tensor-core kernels for x (b, c, t), w9
    (9, c, cout) and frame rows of wp tokens: `scratch` is the shape of the
    token-major copy of x (wp + 1 zero rows ahead of each frame, channels
    padded to a multiple of 8); a GEMM block owns `mt` m64 tiles of output
    channels (the fewest blocks along Cout, then the fewest tiles a block)
    x 96 tokens; the K loop takes `k_stages` stages of one tap x 64
    channels through a ring of `stages`; `smem` is the ring (mt w9 boxes
    and two xt boxes a stage), the stages' two mbarriers and 1024 bytes to
    align the ring.
    Each consumer thread holds `acc_regs` fp32 accumulators of its budget
    of `reg_budget` registers: setmaxnreg gives the two consumer
    warpgroups 232 a thread and the producer warpgroup 40, which together
    fit the SM's 65,536. Raises ValueError for a shape the kernel does not
    take."""
    if min(b, c, cout, t, wp) <= 0 or t % 8 or cout % 8:
        raise ValueError(f"the tensor-core conv takes T and Cout multiples "
                         f"of 8, got B {b}, C {c}, Cout {cout}, T {t}, "
                         f"wp {wp}")
    tiles = _cdiv(cout, 64)
    m_blocks = _cdiv(tiles, MAX_MT)
    mt = _cdiv(tiles, m_blocks)
    smem = STAGES * (mt * W_TILE + 2 * X_TILE) + 2 * STAGES * 8 + 1024
    return dict(mt=mt, bm=64 * mt, bn=BN, kc=KC, stages=STAGES,
                k_stages=9 * _cdiv(c, KC), threads=THREADS, smem=smem,
                grid=(_cdiv(t, BN), m_blocks, b), acc_regs=BN // 4 * mt,
                reg_budget=CONSUMER_REGS,
                scratch=(b, wp + 1 + t, _cdiv(c, 8) * 8))


def cm_conv3x3_plain(x: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
                     mask: torch.Tensor, wp: int,
                     shifts: bool = True) -> torch.Tensor:
    """Plain PyTorch version: the study's nine shifted einsums (`cm_conv`),
    in fp32, then rounded to x.dtype and masked."""
    b, c, t = x.shape
    guard = wp + 1
    xbuf = torch.nn.functional.pad(x.float(), (guard, guard))
    acc = None
    for s, off in enumerate(tap_offsets(wp, shifts)):
        xs = xbuf[:, :, guard + off:guard + off + t]
        u = torch.einsum("cd,bct->bdt", w9[s].float(), xs)
        acc = u if acc is None else acc + u
    out = (acc + bias.float()[:, None]).to(x.dtype)
    return out * mask.to(x.dtype)


def cm_conv3x3(x: torch.Tensor, w9: torch.Tensor, bias: torch.Tensor,
               mask: torch.Tensor, wp: int,
               shifts: bool = True) -> torch.Tensor:
    """The 3x3 conv in the padded channel-major layout (module docstring)."""
    b, c, t = x.shape
    cout = w9.shape[-1]
    if w9.shape != (9, c, cout) or bias.shape != (cout,) \
            or mask.shape != (t,) or wp <= 0:
        raise ValueError(f"cm_conv3x3: x {tuple(x.shape)}, w9 "
                         f"{tuple(w9.shape)}, bias {tuple(bias.shape)}, mask "
                         f"{tuple(mask.shape)}, wp {wp}")
    if x.device.type == "cpu":
        return cm_conv3x3_plain(x, w9, bias, mask, wp, shifts)
    dtype = _build.cuda_operands("cm_conv3x3", x, w9, bias, mask)
    tensor = (x.dtype == torch.bfloat16 and t % 8 == 0 and cout % 8 == 0
              and all(a.data_ptr() % 16 == 0 for a in (x, w9)))
    plan = _plan(b, c, cout, t, wp) if tensor else dict(mt=0, smem=0)
    out = torch.empty(b, cout, t, device=x.device, dtype=x.dtype)
    xt = (torch.empty(plan["scratch"], device=x.device, dtype=x.dtype)
          if tensor else None)
    code = _build.library().lib.rcdms_cm_conv_fwd(
        dtype, plan["mt"], plan["smem"], int(shifts), x.data_ptr(),
        w9.data_ptr(), bias.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if xt is None else xt.data_ptr(), b, c, cout, t, wp,
        _build.stream(x))
    _build.check(code, "rcdms_cm_conv_fwd")
    cm_conv3x3.launches += 1
    cm_conv3x3.tensor_launches += int(tensor)
    return out


cm_conv3x3.launches = 0
cm_conv3x3.tensor_launches = 0
