"""Feature maps, frames and batches split over the ranks of a group: the
block helpers and the `spatial` context of sharded single-story inference
(`--shard-story`, `train/sharding.py::inference_mesh`).

The JAX package lets GSPMD insert these collectives; here they are
explicit. A split cuts n rows into blocks in rank order, as GSPMD pads
them: ceil(n / ranks) a rank, so the last ranks may hold fewer rows or
none (`blocks`). Every rank derives every rank's (offset, size) from the
whole count, so no sizes are exchanged: `narrow` takes this rank's block,
and `gather` pads each block to the largest, makes one `all_gather` and
narrows (NCCL and gloo take equal sizes). A rank that holds nothing
still joins every collective.

Within `spatial(rows=plan)` the UNet's and the VAE's layers hold only this
rank's block of rows of each feature map (`RowPlan`: the blocks at every
resolution, found by the map's columns, which are never split): a conv
takes its neighbours' edge rows (`halo`), a GroupNorm sums its moments
over the group (`all_reduce_sum`), a spatial self-attention gathers K and
V. Within `spatial(frames=split)` each rank holds a block of the story's
frames, and a temporal module trades frames for tokens with the other
ranks of its frame group (`frames_to_tokens`, `tokens_to_frames`: one
`all_to_all` each way). The int8 activation scale is a maximum over the
ranks that hold the layer's whole input (`spatial(whole=group)`, by
default the row plan's). Outside the context every layer runs as it does
alone. The context is a module global, as the JAX package's `_SPMD_MESH`
(`rcdms_tpu/ops/attention.py`).
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional, Tuple

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


# the group of a process that runs alone (no mesh): every helper here
# leaves its tensors as they are
ONE_RANK = RowGroup(None, 1, 0)


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _active(group: Optional[RowGroup]) -> bool:
    return group is not None and group.size > 1


def blocks(n: int, ranks: int, granule: int = 1) -> List[Tuple[int, int]]:
    """(offset, size) of each of `ranks` ranks' blocks of `n` rows, in rank
    order: whole granules of `granule` rows (the last may be partial),
    ceil(granules / ranks) a rank, so the last ranks may hold fewer rows
    or none. A granule of 2^k keeps every block's start even at each of k
    halvings (a stride-2 conv reads from an even row)."""
    granules = -(-n // granule)
    per = -(-granules // ranks) * granule
    return [(min(i * per, n), min((i + 1) * per, n) - min(i * per, n))
            for i in range(ranks)]


def _scaled(v: int, level: int) -> int:
    return v >> level if level >= 0 else v << -level


class RowPlan(NamedTuple):
    """The row blocks of a family of feature maps split over `group`:
    `rows` x `cols` at the top resolution, `levels` resolutions from it
    down (each halving rows and columns, with a floor: a stride-2 conv
    between them; the UNet and the VAE encoder) and `up` resolutions above
    it (each doubling them; the VAE decoder). The top level is cut into
    granules of 2^(levels - 1) rows, so each block starts on an even row
    at every level it is halved from."""

    group: RowGroup
    rows: int
    cols: int
    levels: int = 1
    up: int = 0

    def level(self, cols: int) -> int:
        """The resolution of a feature map of `cols` columns."""
        for level in range(-self.up, self.levels):
            if _scaled(self.cols, level) == cols:
                return level
        raise ValueError(f"a feature map of {cols} columns is at no level "
                         f"of {self}")

    def blocks(self, cols: int) -> List[Tuple[int, int]]:
        """Every rank's (offset, size) of the rows of a `cols`-column map."""
        level = self.level(cols)
        top = blocks(self.rows, self.group.size, 1 << (self.levels - 1))
        return [(_scaled(o, level), _scaled(o + n, level) - _scaled(o, level))
                for o, n in top]

    def total(self, cols: int) -> int:
        """The whole row count of a `cols`-column map."""
        o, n = self.blocks(cols)[-1]
        return o + n


def check_rows(rows: int, levels: int, group: Optional[RowGroup],
               what: str) -> None:
    """Raises ValueError where `rows` do not halve exactly at each of the
    `levels` - 1 stride-2 convs of a UNet split over `group`: there its up
    path's skips do not match, whole or split (the JAX package fails
    alike). Any other count splits (`RowPlan`)."""
    if not _active(group):
        return
    if rows % (1 << (levels - 1)):
        raise ValueError(
            f"--shard-story: {what}: {rows} rows do not halve "
            f"{levels - 1} times (world size {_world_size()})")


def narrow(x: torch.Tensor, axis: int, group: RowGroup,
           table: List[Tuple[int, int]]) -> torch.Tensor:
    """This rank's block of the whole tensor `x` along `axis`, `table`
    holding every rank's (offset, size) in rank order (`blocks`,
    `RowPlan.blocks`): a view, `x` itself on one rank."""
    if not _active(group):
        return x
    return x.narrow(axis, *table[group.index])


def gather_list(x: torch.Tensor, group: RowGroup) -> List[torch.Tensor]:
    """Every rank's `x` (of one shape on every rank), in rank order."""
    if not _active(group):
        return [x]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.handle)
    return parts


def gather(x: torch.Tensor, axis: int, group: RowGroup,
           table: List[Tuple[int, int]]) -> torch.Tensor:
    """The whole tensor of each rank's block `x` along `axis` (`table` as
    `narrow`'s): each padded to the largest, one all_gather, each
    narrowed back, joined in rank order."""
    if not _active(group):
        return x
    axis %= x.dim()
    sizes = [n for _, n in table]
    most = max(sizes)
    if x.shape[axis] < most:
        shape = list(x.shape)
        shape[axis] = most - x.shape[axis]
        x = torch.cat([x, x.new_zeros(shape)], dim=axis)
    parts = gather_list(x, group)
    return torch.cat([p.narrow(axis, 0, n) for p, n in zip(parts, sizes)],
                     dim=axis)


def halo(x: torch.Tensor, axis: int, above: int, below: int,
         plan: RowPlan) -> torch.Tensor:
    """`x`, this rank's block of rows (rows at `axis`, columns at `axis` +
    1), with the `above` rows before it and the `below` rows after it
    attached, each taken from the rank that holds it, zeros outside the
    map. One all_gather of every rank's first `below` and last `above`
    rows (no send/recv: gloo sends no CUDA tensors, and one path serves
    NCCL and gloo)."""
    if above == below == 0:
        return x
    axis %= x.dim()
    table = plan.blocks(x.shape[axis + 1])
    n = x.shape[axis]

    def zeros(rows):
        shape = list(x.shape)
        shape[axis] = rows
        return x.new_zeros(shape)

    # each rank's first `below` rows and last `above` rows, zero-padded
    # where it holds fewer
    first = x.narrow(axis, 0, min(below, n))
    last = x.narrow(axis, n - min(above, n), min(above, n))
    edges = torch.cat([first, zeros(below - first.shape[axis]),
                       zeros(above - last.shape[axis]), last], dim=axis)
    parts = gather_list(edges, plan.group)
    total = table[-1][0] + table[-1][1]

    def row(j):
        if j < 0 or j >= total:
            return zeros(1)
        r = next(r for r, (o, m) in enumerate(table) if o <= j < o + m)
        o, m = table[r]
        at = j - o if j - o < below else below + above - (o + m - j)
        return parts[r].narrow(axis, at, 1)

    start = table[plan.group.index][0]
    return torch.cat([row(j) for j in range(start - above, start)] + [x]
                     + [row(j) for j in range(start + n, start + n + below)],
                     dim=axis)


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


class FrameSplit(NamedTuple):
    """The story's `frames` frames split over `group` (`blocks`)."""

    group: RowGroup
    frames: int


def _all_to_all(pieces: List[torch.Tensor], counts: List[int],
                group: RowGroup) -> List[torch.Tensor]:
    """pieces[r] sent to rank r; returns the flat pieces received from each
    rank, of `counts` elements (one all_to_all_single, uneven splits)."""
    send = torch.cat([p.reshape(-1) for p in pieces])
    recv = send.new_empty(sum(counts))
    dist.all_to_all_single(recv, send, counts, [p.numel() for p in pieces],
                           group=group.handle)
    return list(recv.split(counts))


def frames_to_tokens(h: torch.Tensor, split: FrameSplit) -> torch.Tensor:
    """(b, this rank's frames, n, c) -> (b, every frame, this rank's block
    of the n tokens, c): the frame group trades frames for tokens."""
    group = split.group
    b, _, n, c = h.shape
    tokens = blocks(n, group.size)
    frames = blocks(split.frames, group.size)
    mine = tokens[group.index][1]
    got = _all_to_all([h.narrow(2, *t) for t in tokens],
                      [b * f * mine * c for _, f in frames], group)
    return torch.cat([g.view(b, f, mine, c)
                      for g, (_, f) in zip(got, frames)], dim=1)


def tokens_to_frames(h: torch.Tensor, split: FrameSplit,
                     n: int) -> torch.Tensor:
    """The inverse of `frames_to_tokens` on its (b, f, token block, c)
    output: (b, this rank's frames, the n tokens, c)."""
    group = split.group
    b, _, _, c = h.shape
    tokens = blocks(n, group.size)
    frames = blocks(split.frames, group.size)
    mine = frames[group.index][1]
    got = _all_to_all([h.narrow(1, *f) for f in frames],
                      [b * mine * t * c for _, t in tokens], group)
    return torch.cat([g.view(b, mine, t, c)
                      for g, (_, t) in zip(got, tokens)], dim=2)


# the row plan the UNet's and the VAE's layers split their rows by, the
# frame split the temporal modules exchange over, and the ranks that hold
# a layer's whole input, set by `spatial`
_ROWS: Optional[RowPlan] = None
_FRAMES: Optional[FrameSplit] = None
_WHOLE: Optional[RowGroup] = None


@contextlib.contextmanager
def spatial(rows: Optional[RowPlan] = None,
            frames: Optional[FrameSplit] = None,
            whole: Optional[RowGroup] = None):
    """Within the block, the layers that read `row_plan` (convs,
    GroupNorm, spatial self-attention) hold only this rank's block of rows
    of each feature map, and those that read `frame_split` (the temporal
    modules) this rank's block of frames; the int8 activation scale takes
    its maximum over `whole_group`: `whole`, the ranks whose blocks make
    up the tensor a layer sees in one process (default the row plan's
    group). None, or a one-rank group, leaves those layers as they run
    alone."""
    global _ROWS, _FRAMES, _WHOLE
    before = _ROWS, _FRAMES, _WHOLE
    _ROWS = rows if rows is not None and _active(rows.group) else None
    _FRAMES = (frames if frames is not None and _active(frames.group)
               else None)
    if whole is None and _ROWS is not None:
        whole = _ROWS.group
    _WHOLE = whole if _active(whole) else None
    try:
        yield
    finally:
        _ROWS, _FRAMES, _WHOLE = before


def row_plan() -> Optional[RowPlan]:
    """The row plan of the enclosing `spatial` block (None outside)."""
    return _ROWS


def frame_split() -> Optional[FrameSplit]:
    """The frame split of the enclosing `spatial` block (None outside)."""
    return _FRAMES


def whole_group() -> Optional[RowGroup]:
    """The ranks that hold the whole input of a layer in the enclosing
    `spatial` block (None outside)."""
    return _WHOLE
