"""Seeded weights of the story model, made by the benchmark itself.

The parameter list (names and shapes) is the plain reference's
(`reference/model.py`), whose names are the port's. Every value is drawn
from one generator on the device, in one call, in the dtype the model is
served in, and each parameter is a view of that one buffer, scaled by a
rule of its module's kind:

  * Linear and Conv weights: normal, std 1 / sqrt(fan_in);
  * embedding tables: normal, std 1 / sqrt(width);
  * LayerNorm and GroupNorm scales: 1 + normal * 0.02;
  * everything else (biases, learned tokens and positions): normal * 0.02.

Random biases, norm parameters and temporal output projections reach every
term of the equations: nothing starts at zero or one, as it would before
training.
"""

from __future__ import annotations

import torch
import torch.nn as nn

SMALL = 0.02


def spec(model: nn.Module) -> list:
    """[(name, shape, (scale, shift))] of every parameter, in the model's
    order."""
    out = []
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            if isinstance(module, (nn.Linear, nn.Conv2d)) and \
                    pname == "weight":
                rule = (p[0].numel() ** -0.5, 0.0)
            elif isinstance(module, nn.Embedding):
                rule = (shape[1] ** -0.5, 0.0)
            elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)) and \
                    pname == "weight":
                rule = (SMALL, 1.0)
            else:
                rule = (SMALL, 0.0)
            out.append((name, shape, rule))
    return out


def count(params: list) -> int:
    return sum(torch.Size(shape).numel() for _, shape, _ in params)


def make(params: list, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{name: tensor} of the parameters of `spec`, drawn from `seed`: one
    randn over all of them, then each view scaled and shifted in place."""
    g = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(count(params), generator=g, dtype=dtype,
                       device=device)
    out, at = {}, 0
    for name, shape, (scale, shift) in params:
        n = torch.Size(shape).numel()
        view = flat[at:at + n].view(shape)
        view.mul_(scale)
        if shift:
            view.add_(shift)
        out[name] = view
        at += n
    return out
