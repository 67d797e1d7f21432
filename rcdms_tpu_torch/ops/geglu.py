"""Kernels C and D: the fused transformer feed-forward — the port's
counterparts of `rcdms_tpu/ops/geglu.py::geglu_ff` and `::gelu_ff`.

    geglu_ff: y = (x W1h^T + b1h) * gelu(x W1g^T + b1g) W2^T + b2
    gelu_ff:  y = gelu(x W1^T + b1) W2^T + b2

Weights keep torch's Linear layout: w1 (up, c), b1 (up,), w2 (c, inner),
b2 (c,), with up = 2*inner for geglu (hidden half first, gate half second,
as diffusers' GEGLU splits it). The FF is pointwise over tokens, so all
leading dims of x flatten into one row axis (a view); the kernel masks the
ragged row tail, so the JAX package's `ff_flat` pad to 128 rows is gone.

Each wrapper dispatches on where x lies: on the CPU it runs its plain
version; on a CUDA device it launches `csrc/ff.cu` or raises: the
tensor-core kernel for bf16 with c and inner multiples of 8 and 16-byte
aligned x, w1, w2 (every FF of the main path), the CUDA-core one
otherwise. `.launches` counts launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from rcdms_tpu_torch.ops import _build


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu in fp32, back in x.dtype."""
    return F.gelu(x.float()).to(x.dtype)


def geglu_ff_plain(x, w1, b1, w2, b2):
    """Plain PyTorch version of kernel C."""
    h, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
    return F.linear(h * _gelu(gate), w2, b2)


def gelu_ff_plain(x, w1, b1, w2, b2):
    """Plain PyTorch version of kernel D."""
    return F.linear(_gelu(F.linear(x, w1, b1)), w2, b2)


def _ff(name: str, geglu: bool, x, w1, b1, w2, b2):
    c = x.shape[-1]
    inner = w2.shape[-1]
    up = 2 * inner if geglu else inner
    if w1.shape != (up, c) or b1.shape != (up,) or w2.shape != (c, inner) \
            or b2.shape != (c,):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
                         f"b2 {tuple(b2.shape)}")
    dtype = _build.cuda_operands(name, x, w1, b1, w2, b2)
    tensor = (x.dtype == torch.bfloat16 and c % 8 == 0 and inner % 8 == 0
              and all(t.data_ptr() % 16 == 0 for t in (x, w1, w2)))
    rows = x.numel() // c
    out = torch.empty_like(x)
    code = _build.library().lib.rcdms_ff_fwd(
        dtype, int(geglu), int(tensor), x.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), rows, c,
        inner, _build.stream(x))
    _build.check(code, "rcdms_ff_fwd")
    return out


def geglu_ff(x, w1, b1, w2, b2) -> torch.Tensor:
    """Fused GEGLU feed-forward over x (..., c)."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, w1, b1, w2, b2)
    out = _ff("geglu_ff", True, x, w1, b1, w2, b2)
    geglu_ff.launches += 1
    return out


def gelu_ff(x, w1, b1, w2, b2) -> torch.Tensor:
    """Fused GELU feed-forward over x (..., c)."""
    if x.device.type == "cpu":
        return gelu_ff_plain(x, w1, b1, w2, b2)
    out = _ff("gelu_ff", False, x, w1, b1, w2, b2)
    gelu_ff.launches += 1
    return out


geglu_ff.launches = 0
gelu_ff.launches = 0
