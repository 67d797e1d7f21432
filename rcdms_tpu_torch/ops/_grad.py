"""The story kernels under autograd.

A kernel's output carries no autograd graph: it is written through a
ctypes pointer into a fresh tensor. So each story op (A-D) goes through
`differentiable` whenever grad mode is on and an operand requires grad
(`traced`): one `torch.autograd.Function` whose forward is the op as
before (the kernel on a card, the plain version on the CPU) and saves only
the operands, and whose backward recomputes a reference function and
differentiates it, as the JAX package's `custom_vjp`s recompute their XLA
references. The reference is the function the JAX backward
differentiates, not the port's plain version: in bf16 it takes softmax ->
cast -> product, and the FF rounds h after the first product, where the
kernels round elsewhere.
"""

from __future__ import annotations

from typing import Callable

import torch


def traced(*tensors: torch.Tensor) -> bool:
    """True where autograd would record an op on `tensors`."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _Recompute(torch.autograd.Function):
    """forward(*operands) with the vector-Jacobian product of
    reference(*operands)."""

    @staticmethod
    def forward(ctx, forward, reference, *operands):
        ctx.save_for_backward(*operands)
        ctx.reference = reference
        return forward(*operands)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            grads = iter(torch.autograd.grad(
                ctx.reference(*leaves),
                [t for t in leaves if t.requires_grad], grad))
        return (None, None) + tuple(next(grads) if need else None
                                    for need in needs)


def differentiable(forward: Callable, reference: Callable,
                   *operands: torch.Tensor) -> torch.Tensor:
    """forward(*operands); where autograd records it, inside `_Recompute`,
    so that its gradients are those of reference(*operands)."""
    if traced(*operands):
        return _Recompute.apply(forward, reference, *operands)
    return forward(*operands)
