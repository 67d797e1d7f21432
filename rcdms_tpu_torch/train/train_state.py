"""The training state of one stage: the port's counterpart of
`rcdms_tpu/train/train_state.py`.

It holds the step (one a micro-step, as `TrainState.step`), the fp32
master parameters, the optimizer state and the compute module, in which
the loss runs. Mixed precision is flax's `dtype=bf16` over fp32
parameters: the compute module holds bf16 copies of the parameters (the
norms and the time MLP stay fp32, `core/layers.py::_Fp32Params`), the
gradients of the copies are widened to fp32 and applied to the masters,
and after each update the copies are rounded again from the masters. Flax
computes the same: its Dense casts the fp32 parameter to bf16, and the
transpose of that cast widens the bf16 cotangent. (`torch.autocast` would
round at the places of its op lists instead.) In fp32 the masters are the
module's own parameters.

With `params_dtype` bf16 (the JAX bench's `--params-dtype bfloat16`,
whose parameters, and so optax's moments, are bf16) the masters are the
bf16 module's own parameters too: the gradients stay bf16, and the
optimizer's moments (`train/optim.py`, zeros like the masters) are bf16.
The norms and the time MLP keep fp32 parameters there, and so fp32
moments; the JAX bench casts those to bf16 as well (under 0.1% of the
bytes).

Under a process group the masters are whole on every rank and the
optimizer state is this rank's ZeRO-2 cut (`train/optim.py::AdamW`);
`host_state_dicts` gathers the cuts for a checkpoint, and
`load_state_dicts` keeps this rank's cut of a whole tree, so a
checkpoint does not depend on the number of ranks that wrote it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from rcdms_tpu_torch.train.optim import AdamW, OptState


class TrainState:
    """step, fp32 masters `params` (name -> tensor), `opt_state` and the
    compute `module`, whose parameters are the trainable set."""

    def __init__(self, module: nn.Module, optimizer: AdamW,
                 params: Dict[str, torch.Tensor], opt_state: OptState,
                 step: int = 0):
        self.module = module
        self.optimizer = optimizer
        self.params = params
        self.opt_state = opt_state
        self.step = step

    @classmethod
    def create(cls, module: nn.Module, optimizer: AdamW,
               dtype=torch.float32,
               params_dtype=torch.float32) -> "TrainState":
        """`module` with fp32 parameters, all of them trained, becomes the
        compute module in `dtype` (channels-last on a card, as the
        inference towers); the masters keep its fp32 values, or, with
        `params_dtype` equal to `dtype`, are its own parameters."""
        if params_dtype not in (torch.float32, dtype):
            raise ValueError(f"params_dtype {params_dtype} with compute "
                             f"dtype {dtype}")
        fp32 = {n: p.detach() for n, p in module.named_parameters()}
        module.to(dtype)
        if next(module.parameters()).device.type == "cuda":
            module.to(memory_format=torch.channels_last)
        params = {}
        for n, p in module.named_parameters():
            if p.dtype == torch.float32 or params_dtype == dtype:
                params[n] = p
            else:
                params[n] = torch.empty_like(p, dtype=torch.float32)
                params[n].copy_(fp32[n])
            del fp32[n]
        return cls(module, optimizer, params, optimizer.init(params))

    def gradients(self) -> Dict[str, torch.Tensor]:
        """The compute module's gradients in the masters' dtype (fp32
        unless the masters are bf16), by name (zero where a parameter got
        none); the module's own are released."""
        grads = {}
        for n, p in self.module.named_parameters():
            g = p.grad
            grads[n] = (torch.zeros_like(self.params[n]) if g is None
                        else g.to(self.params[n].dtype))
            p.grad = None
        return grads

    @torch.no_grad()
    def apply_gradients(self, grads: Dict[str, torch.Tensor]
                        ) -> Optional[torch.Tensor]:
        """The optimizer's micro-step on the masters, then the copies
        rounded from them where it updated; the step advances. Returns
        what `AdamW.update` returns (the global gradient norm, or None)."""
        norm = self.optimizer.update(self.params, grads, self.opt_state)
        if norm is not None:
            self._round_copies()
        self.step += 1
        return norm

    @torch.no_grad()
    def _round_copies(self) -> None:
        pairs = [(p, self.params[n]) for n, p in self.module.named_parameters()
                 if p is not self.params[n]]
        if pairs:
            torch._foreach_copy_(*map(list, zip(*pairs)))

    def state_dicts(self) -> dict:
        """The inverse of `load_state_dicts`, with the keys of
        `io/bridge.py::train_state_dicts`: "params", "mu", "nu" and "acc"
        (None without accumulation) by parameter name, the state's own
        tensors (not copies; the moments are this rank's cuts under a
        process group), and the ints "count", "mini_step",
        "gradient_step" and "step"."""
        st = self.opt_state

        def own(tensors):
            return None if tensors is None else {
                n: t.detach() for n, t in tensors.items()}

        return dict(params=own(self.params), mu=own(st.mu), nu=own(st.nu),
                    acc=own(st.acc), count=st.count,
                    mini_step=st.mini_step,
                    gradient_step=st.gradient_step, step=self.step)

    @torch.no_grad()
    def host_state_dicts(self) -> Optional[dict]:
        """`state_dicts` with whole tensors, for a checkpoint: with no
        process group, `state_dicts` itself; under one, a collective that
        gathers each cut of the optimizer state to rank 0's host memory
        one tensor at a time (so the device never holds a second whole
        copy of the moments) and returns the tree there, None on the
        other ranks."""
        dicts = self.state_dicts()
        shards = self.optimizer.shards
        if shards is None:
            return dicts
        for key in ("mu", "nu", "acc"):
            if dicts[key] is not None:
                dicts[key] = {n: shards.gather_to_host(n, t)
                              for n, t in dicts[key].items()}
        return dicts if shards.rank == 0 else None

    def load_state_dicts(self, dicts: dict) -> None:
        """The masters, moments, counts and step from `dicts`
        (`host_state_dicts`, or `io/bridge.py::train_state_dicts`: whole
        tensors or numpy arrays by parameter name; a rank keeps its cut of
        the moments), then the copies rounded from the masters."""
        st = self.opt_state
        with torch.no_grad():
            for key, target in (("params", self.params), ("mu", st.mu),
                                ("nu", st.nu), ("acc", st.acc)):
                if target is None:
                    continue
                src = dicts[key]
                if set(src) != set(target):
                    raise KeyError(f"{key}: names differ: "
                                   f"{sorted(set(src) ^ set(target))[:5]}")
                for n, t in target.items():
                    v = src[n]
                    v = v if isinstance(v, torch.Tensor) else torch.tensor(v)
                    t.copy_(v if key == "params"
                            else self.optimizer.cut(n, v))
        self._round_copies()
        st.count, st.mini_step, st.gradient_step = (
            int(dicts["count"]), int(dicts["mini_step"]),
            int(dicts["gradient_step"]))
        self.step = int(dicts["step"])
