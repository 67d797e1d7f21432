"""Feature maps split by rows over the ranks of a group: the row helpers and
the `spatial` context of sharded single-story inference (`--shard-story`,
`train/sharding.py::inference_mesh`).

The JAX package lets GSPMD insert these collectives; here they are
explicit. Within `spatial(group)` the UNet's and the VAE's layers hold only
this rank's block of rows of each feature map: a conv takes its
neighbours' edge rows (`halo`), a GroupNorm sums its moments over the group
(`all_reduce_sum`), a spatial self-attention gathers K and V
(`gather_rows`), the int8 activation scale is a maximum over the group
(`all_reduce_max`). Outside the context every layer runs as it does alone.
The context is a module global, as the JAX package's `_SPMD_MESH`
(`rcdms_tpu/ops/attention.py`).
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist


class RowGroup(NamedTuple):
    """Ranks that split rows among themselves, in row order: `handle` the
    process group (None: the default group), `size` its ranks, `index`
    this rank's place (its rank in the group: a group's ranks are in
    global order, and so are the rows they hold)."""

    handle: object
    size: int
    index: int


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _active(group: Optional[RowGroup]) -> bool:
    return group is not None and group.size > 1


def check_rows(rows: int, levels: int, group: Optional[RowGroup],
               what: str) -> None:
    """Raises ValueError unless `rows` split evenly over `group` at each
    of `levels` resolutions (rows halved from one to the next, each level
    but the last halved by a stride-2 conv, so its local rows must be
    even). The JAX package pads such splits (GSPMD); the port does not
    (ROADMAP.md Queue 1 item 17b)."""
    if not _active(group):
        return
    for level in range(levels):
        local, rest = divmod(rows >> level, group.size)
        last = level == levels - 1
        if rest or (rows >> level) << level != rows or (
                not last and local % 2):
            raise ValueError(
                f"--shard-story: {what}: {rows >> level} rows at level "
                f"{level} do not split into even row blocks over "
                f"{group.size} ranks (world size {_world_size()})")


def local_rows(x: torch.Tensor, axis: int,
               group: Optional[RowGroup]) -> torch.Tensor:
    """This rank's block of rows of the whole tensor `x` along `axis` (a
    view; `x` itself with no group or one rank)."""
    if not _active(group):
        return x
    n = x.shape[axis]
    if n % group.size:
        raise ValueError(f"{n} rows do not split over {group.size} ranks "
                         f"(world size {_world_size()})")
    size = n // group.size
    return x.narrow(axis, group.index * size, size)


def gather_list(x: torch.Tensor,
                group: Optional[RowGroup]) -> List[torch.Tensor]:
    """Every rank's `x` (of one shape on every rank), in row order."""
    if not _active(group):
        return [x]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.handle)
    return parts


def gather_rows(x: torch.Tensor, axis: int,
                group: Optional[RowGroup]) -> torch.Tensor:
    """The whole tensor of each rank's block of rows `x` along `axis`."""
    if not _active(group):
        return x
    return torch.cat(gather_list(x, group), dim=axis)


def halo(x: torch.Tensor, axis: int, above: int, below: int,
         group: Optional[RowGroup]) -> torch.Tensor:
    """`x` with `above` rows of the rank above and `below` rows of the
    rank below attached along `axis`, zeros at the global top and bottom.
    One all_gather of every rank's edge rows (no send/recv: gloo sends no
    CUDA tensors, and one path serves NCCL and gloo)."""
    n = x.shape[axis]
    if above > n or below > n:
        raise ValueError(f"a halo of {above} + {below} rows around {n} "
                         f"local rows")
    if above == below == 0:
        return x
    # each rank's first `below` rows (the halo of the rank above) and last
    # `above` rows (that of the rank below)
    parts = gather_list(torch.cat([x.narrow(axis, 0, below),
                                   x.narrow(axis, n - above, above)],
                                  dim=axis), group)
    index = group.index if _active(group) else 0

    def zeros(rows):
        shape = list(x.shape)
        shape[axis] = rows
        return x.new_zeros(shape)

    top = (parts[index - 1].narrow(axis, below, above) if index > 0
           else zeros(above))
    bottom = (parts[index + 1].narrow(axis, 0, below)
              if index < len(parts) - 1 else zeros(below))
    return torch.cat([top, x, bottom], dim=axis)


def all_reduce_sum(x: torch.Tensor,
                   group: Optional[RowGroup]) -> torch.Tensor:
    """The sum of `x` over the group's ranks, a new tensor (`x` itself
    with no group or one rank)."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor,
                   group: Optional[RowGroup]) -> torch.Tensor:
    """The elementwise maximum of `x` over the group's ranks."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def _all_reduce(x, group, op) -> torch.Tensor:
    if not _active(group):
        return x
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=group.handle)
    return x


# the row group the UNet's and the VAE's layers split their rows over,
# set by `spatial`
_SPATIAL: Optional[RowGroup] = None


@contextlib.contextmanager
def spatial(group: Optional[RowGroup]):
    """Within the block, the layers that read `spatial_group` (convs,
    GroupNorm, spatial self-attention, the int8 activation scale) hold
    only this rank's block of rows of each feature map, split over
    `group`. No group, or one rank, leaves every layer as it runs alone."""
    global _SPATIAL
    before = _SPATIAL
    _SPATIAL = group if _active(group) else None
    try:
        yield
    finally:
        _SPATIAL = before


def spatial_group() -> Optional[RowGroup]:
    """The row group of the enclosing `spatial` block (None outside)."""
    return _SPATIAL
