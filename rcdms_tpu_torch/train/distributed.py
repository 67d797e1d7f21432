"""The process group of data-parallel training, the port's counterpart of
`rcdms_tpu/train/distributed.py` (`jax.distributed.initialize` from flags
or the environment).

`torchrun --nproc-per-node N` starts N processes and gives each its
coordinates in the environment: `RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR` and `MASTER_PORT`. `maybe_initialize` reads them (arguments
take precedence, as the JAX module's flags do), joins the group and pins
the process to `cuda:{LOCAL_RANK}`. Without such coordinates it does
nothing: one process trains alone, with no group.

Two groups: the default one, `nccl` for a CUDA device and `gloo` for the
CPU, carries the gradients, the masters and the moments; a second, `gloo`
on the CPU, carries host-side flags (the preemption stop flag), so that
reading them never waits for the card.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger("rcdms_tpu_torch.distributed")

# the gloo group of host-side flags; it lives and dies with the default
# group, which torch.distributed itself keeps for the process
_host_group = None


def _env_int(name: str, given: Optional[int]) -> Optional[int]:
    if given is not None:
        return given
    value = os.environ.get(name)
    return int(value) if value else None


def maybe_initialize(device="cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join the process group of the arguments, else of torchrun's
    environment; returns whether there is a group. Without a world size
    in either it does nothing. The backend is `nccl` for a CUDA `device`
    and `gloo` otherwise, unless `backend` names one (two ranks on one
    card need gloo: NCCL refuses them). On a CUDA device the process takes
    `cuda:{local_rank}`. A group that exists already is kept; any other
    failure to join raises, since N processes that each train alone are
    not one training."""
    global _host_group
    world_size = _env_int("WORLD_SIZE", world_size)
    if world_size is None:
        return False
    rank = _env_int("RANK", rank)
    local_rank = _env_int("LOCAL_RANK", local_rank)
    if rank is None:
        raise ValueError(f"a world of {world_size} processes needs this "
                         f"process's rank (RANK)")
    if init_method is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
                   if not os.environ.get(k)]
        if missing:
            raise ValueError(f"a world of {world_size} processes needs "
                             f"{' and '.join(missing)} or an init_method")
        init_method = "env://"
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if dist.is_initialized():
        logger.info("process group already initialised: rank %d of %d",
                    dist.get_rank(), dist.get_world_size())
    else:
        if device.type == "cuda":
            torch.cuda.set_device(local_rank or 0)
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
        logger.info("process group initialised: rank %d of %d (%s)",
                    dist.get_rank(), dist.get_world_size(), backend)
    if _host_group is None and dist.get_backend() != "gloo":
        _host_group = dist.new_group(backend="gloo")
    return True


def shutdown() -> None:
    """Leave the process group, if there is one."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None


def rank_and_size() -> Tuple[int, int]:
    """(this process's rank, the world size): (0, 1) with no group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def active() -> bool:
    """Whether a process group exists (of any size, one rank included)."""
    return dist.is_available() and dist.is_initialized()


def host_group():
    """The gloo group on the CPU for host-side flags (the default group
    when its backend is gloo)."""
    return _host_group


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the ranks (`x` itself with no group). With
    equal local batches, the mean of the ranks' local means is the mean
    over the global batch."""
    if not active():
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x / dist.get_world_size()


def keep_rows(draw, local_shape: tuple) -> torch.Tensor:
    """`draw(shape)` called on the global batch's shape (the local batch's
    rows times the world size), and this rank's rows of it: rows
    [r b, (r + 1) b) of a local batch of b. A rank's draw so depends on the
    global batch alone, as the JAX CLIs' draw on the global array."""
    r, n = rank_and_size()
    b = local_shape[0]
    return draw((b * n,) + tuple(local_shape[1:])).narrow(0, r * b, b)
