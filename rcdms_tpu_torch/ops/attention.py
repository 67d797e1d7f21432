"""Plain dot-product attention for the sites that stay off the kernel, as
they stay XLA in `rcdms_tpu/ops/attention.py`: masked attention (the prior,
the CLIP text towers), short queries (the fusion stacks, the UNet's 8x8
mid block) and head dims above 256 (the VAE's mid-block attention).

`multihead_attention` is the one routing rule for every attention site in
the port, the counterpart of the JAX package's `_use_pallas` /
`_use_nt_flash` gates: unmasked attention with at least 256 queries and a
head dim of at most 256 goes to kernel A (`ops/flash.py`), in bf16 only
where the head dim is also a multiple of 8 (the `wgmma` kernel's
tiles; fp32 runs the CUDA-core kernel, which takes any head dim up to
256); everything else goes to `dot_product_attention` (`uses_kernel`).
A site whose rows are split over ranks (`core.spatial.spatial`) routes
by its whole query count, so that it takes the path it takes alone (A
takes any local count). The attention impl (`ops/impl.py`, the bench's
`--attn`) can send every site to the plain path or every unmasked site A
can take to A (`uses_kernel`).
"""

from __future__ import annotations

from typing import Optional

import torch

from rcdms_tpu_torch.ops import impl
from rcdms_tpu_torch.ops.flash import MAX_HEAD_DIM, _split_heads, \
    flash_attention

MIN_KERNEL_QUERIES = 256


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (..., heads, Sq, dh); k, v: (..., heads, Skv, dh); mask additive,
    broadcastable to (..., heads, Sq, Skv). Scale dh ** -0.5, softmax in
    fp32; returns q.dtype."""
    logits = torch.matmul(q, k.transpose(-1, -2)).float() * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def uses_kernel(dtype: torch.dtype, dh: int, queries: int,
                masked: bool) -> bool:
    """The routing rule: True where kernel A takes the site. Under the
    attention impl of `ops/impl.py`, "auto" is the rule of the module
    docstring, "plain" sends no site to A, and "kernel" every unmasked
    site A can take, whatever its query count."""
    mode = impl.attention_impl()
    takes = (not masked and dh <= MAX_HEAD_DIM
             and (dtype != torch.bfloat16 or dh % 8 == 0))
    if mode == "auto":
        return takes and queries >= MIN_KERNEL_QUERIES
    return takes and mode == "kernel"


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int, mask: Optional[torch.Tensor] = None, *,
                        row_sum: str,
                        queries: Optional[int] = None) -> torch.Tensor:
    """Attention over token-major projections (..., S, heads*dh) ->
    (..., Sq, heads*dh), routed as the module docstring says. `row_sum`
    names the TPU kernel family whose bf16 rounding a kernel site follows
    (`ops.flash.attention_plain`): "rounded" where the JAX package's layer
    calls `flash_attention_nt` (`core/attention.py`), "fp32" where it calls
    `ops.attention.dot_product_attention` (CLIP, the VAE). `queries`: the
    site's whole query count where q holds a block of it (default q's)."""
    dh = q.shape[-1] // heads
    if uses_kernel(q.dtype, dh, queries or q.shape[-2], mask is not None) \
            and impl.routes_to_wrapper("flash_attention", q.device):
        return flash_attention(q, k, v, heads, row_sum=row_sum)
    o = dot_product_attention(_split_heads(q, heads), _split_heads(k, heads),
                              _split_heads(v, heads), mask)
    return o.transpose(-3, -2).reshape(q.shape[:-1] + (heads * dh,))
