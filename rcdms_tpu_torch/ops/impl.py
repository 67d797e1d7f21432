"""Which route the story ops' sites take: one process-wide setting, the
counterpart of the JAX package's `set_default_attention_impl`
(`rcdms_tpu/ops/attention.py`), whose "auto" / "xla" / "pallas" are here
"auto" / "plain" / "kernel". The bench's `--attn` sets it.

As in the JAX package, the choice lives in the routing layer, never in a
kernel wrapper: A's router (`ops/attention.py::uses_kernel` and
`multihead_attention`), B's caller (`core/attention.py::Attention`) and
C/D's (`core/layers.py::FeedForward`) read it. A wrapper keeps its own
dispatch whatever the setting: its plain version on CPU operands, its
kernel (or an error) on a card's.

  * "auto" (the default): A's router rule, and B, C and D at every site,
    through their wrappers;
  * "plain": every site calls the plain functions itself (the router's
    `dot_product_attention`, `frame_attention_plain`, `geglu_ff_plain`,
    `gelu_ff_plain`), so no kernel launches (the JAX package's "xla");
  * "kernel": every unmasked attention site A can take goes to A, with no
    floor on the query count (the JAX package's "pallas", which ignores
    `_use_pallas`); a site routed to a kernel with CPU operands raises,
    since the kernels run only on a card.

Nothing but the caller chooses "plain": it is an A/B route asked for by
name, never a fallback.
"""

from __future__ import annotations

import torch

IMPLS = ("auto", "plain", "kernel")
_IMPL = "auto"


def set_attention_impl(impl: str) -> None:
    global _IMPL
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r}, not one of {IMPLS}")
    _IMPL = impl


def attention_impl() -> str:
    return _IMPL


def routes_to_wrapper(name: str, device: torch.device) -> bool:
    """The routing layer's gate of a site of op `name` with operands on
    `device`: True where it calls the op's kernel wrapper, False under
    "plain", where it calls the plain function itself. Under "kernel",
    CPU operands raise."""
    if _IMPL == "plain":
        return False
    if _IMPL == "kernel" and device.type == "cpu":
        raise RuntimeError(f"{name}: attention impl 'kernel' on CPU "
                           f"tensors; the kernels run on a CUDA card")
    return True
