"""Data parallelism with ZeRO-2 optimizer state: the training half of
`rcdms_tpu/train/sharding.py`, on an explicit process group
(`train/distributed.py`) instead of a GSPMD mesh.

The JAX package shards the batch over a ('data',) mesh axis, replicates
the parameters and the gradients, and cuts every optimizer-state tensor
along its largest axis that the data axis divides (ZeRO-2; the rest stay
replicated). XLA inserts the collectives. Here they are explicit, in the
optimizer's step (`train/optim.py`): the fp32 gradients are all-reduced
in flat buckets, each rank updates its cut of the moments and the masters
(`Shards.cut`), and the masters' cuts are all-gathered
(`Shards.all_gather_`). Checkpoints gather the moments one tensor at a
time (`Shards.gather_to_host`).

The inference half (`inference_mesh`) splits one story over the ranks
of a group (`--shard-story`): the JAX package's ('cfg', 'frame', 'space')
inference mesh, with its 'frame' axis (`inference_mesh(frame)`, default
1, as the JAX CLIs take it) and its fallback to 1 where the axis does
not divide. Rank r of N is (cfg index c, frame index fr, space index s)
with r = (c * frame + fr) * space + s, the JAX mesh's device order.
The weights are whole on every rank.
The towers split their batch over every rank; the prior gives CFG branch
c to the ranks of cfg index c and splits its frames over them; the story
sampler gives branch c to them too, and splits frames over the frame
group and the UNet's latent rows over the space group; the VAE splits its
rows over every rank. The row and frame helpers and the `spatial` context
of `core/spatial.py` take the place of `constrain`.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from rcdms_tpu_torch.core.spatial import ONE_RANK, RowGroup, gather_list
from rcdms_tpu_torch.train import distributed

CHUNK = 1 << 27  # elements of a foreach list or a flat bucket (0.5 GB fp32)


def local_batch_size(global_batch_size: int) -> int:
    """Per-process rows; validates divisibility by the process count."""
    _, p = distributed.rank_and_size()
    if global_batch_size % p:
        raise ValueError(
            f"global batch size {global_batch_size} must be divisible by "
            f"the process count {p}")
    return global_batch_size // p


def zero2_axis(shape, world: int) -> Optional[int]:
    """The axis ZeRO-2 cuts a tensor of `shape` along over `world` ranks:
    the largest axis the world size divides (the first of equal ones);
    None (replicated) for a scalar or where no axis divides. The JAX
    package's `_zero2_spec_for`."""
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % world == 0 and shape[i] >= world:
            return i
    return None


def chunks(names: list, tensors: Dict[str, torch.Tensor],
           limit: int = CHUNK):
    """`names` in runs of at most `limit` elements of `tensors` (one
    tensor may exceed it): the optimizer's foreach lists and the
    collectives' flat buckets."""
    run, size = [], 0
    for n in names:
        if run and size + tensors[n].numel() > limit:
            yield run
            run, size = [], 0
        run.append(n)
        size += tensors[n].numel()
    if run:
        yield run


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflatten_into(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()


class Shards:
    """This rank's cut of each named tensor of the trained set: along
    `zero2_axis` with `zero2`, none (every tensor replicated) without.
    Made under a process group (`distributed.active()`); a one-rank group
    cuts every tensor whole."""

    def __init__(self, shapes: Dict[str, torch.Size], zero2: bool = True):
        self.rank, self.world = distributed.rank_and_size()
        self.axis = {n: zero2_axis(tuple(s), self.world) if zero2 else None
                     for n, s in shapes.items()}

    def cut(self, name: str, t: torch.Tensor,
            rank: Optional[int] = None) -> torch.Tensor:
        """The cut of the full tensor `t` that `rank` (this rank) holds, a
        view; `t` itself where the tensor is replicated."""
        axis = self.axis[name]
        if axis is None:
            return t
        size = t.shape[axis] // self.world
        return t.narrow(axis, (self.rank if rank is None else rank) * size,
                        size)

    @torch.no_grad()
    def all_reduce_mean_(self, tensors: Dict[str, torch.Tensor]) -> None:
        """Each tensor replaced, in place, by its mean over the ranks, in
        flat buckets of at most CHUNK elements."""
        for run in chunks(list(tensors), tensors):
            part = [tensors[n] for n in run]
            flat = _flat(part)
            dist.all_reduce(flat)
            flat /= self.world
            _unflatten_into(flat, part)

    @torch.no_grad()
    def all_gather_(self, full: Dict[str, torch.Tensor]) -> None:
        """Every rank's cuts of the cut tensors of `full` written into this
        rank's full tensors, in flat buckets of at most CHUNK elements of
        the ranks' cuts together."""
        mine = {n: self.cut(n, t) for n, t in full.items()
                if self.axis[n] is not None}
        for run in chunks(list(mine), mine, CHUNK // self.world):
            flat = _flat([mine[n] for n in run])
            parts = [torch.empty_like(flat) for _ in range(self.world)]
            dist.all_gather(parts, flat)
            for r, part in enumerate(parts):
                _unflatten_into(part, [self.cut(n, full[n], r) for n in run])

    @torch.no_grad()
    def gather_to_host(self, name: str, cut: torch.Tensor
                       ) -> Optional[torch.Tensor]:
        """The full tensor of this rank's `cut`, in host memory on rank 0
        (None on the others); a collective of one tensor, so the device
        holds one full tensor at a time."""
        axis = self.axis[name]
        if axis is None:
            return cut.cpu() if self.rank == 0 else None
        parts = [torch.empty_like(cut) for _ in range(self.world)]
        dist.all_gather(parts, cut.contiguous())
        if self.rank != 0:
            return None
        shape = list(cut.shape)
        shape[axis] *= self.world
        full = torch.empty(shape, dtype=cut.dtype)
        for r, part in enumerate(parts):
            self.cut(name, full, r).copy_(part)
        return full

    @torch.no_grad()
    def global_norm(self, cuts: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global 2-norm of the full tensors whose cuts `cuts` holds,
        as `vector_norm` of the per-tensor norms: a cut tensor's norm from
        its cuts' norms over the ranks, a replicated one's its own."""
        names = list(cuts)
        norms = torch.stack(torch._foreach_norm([cuts[n] for n in names]))
        table = torch.zeros((self.world, len(names)), dtype=norms.dtype,
                            device=norms.device)
        table[self.rank] = norms
        dist.all_reduce(table)
        cut = torch.tensor([self.axis[n] is not None for n in names],
                           device=norms.device)
        full = torch.where(cut, torch.linalg.vector_norm(table, dim=0),
                           norms)
        return torch.linalg.vector_norm(full)


# ---------------------------------------------------------------------------
# Inference: one story split over the ranks of a group (`--shard-story`)
# ---------------------------------------------------------------------------

def mesh_shape(world: int, frame: int = 1) -> Tuple[int, int, int]:
    """(cfg, frame, space) of `world` ranks, the JAX `inference_mesh`'s
    rule: cfg 2 when the world is even and above 1, else 1; `frame` where
    it divides world // cfg, else 1; space what remains."""
    cfg = 2 if world % 2 == 0 and world > 1 else 1
    frame = max(1, frame)
    if (world // cfg) % frame:
        frame = 1  # as the JAX mesh falls back
    return cfg, frame, world // cfg // frame


class StoryMesh(NamedTuple):
    """The sizes of the ('cfg', 'frame', 'space') mesh, this rank's
    indices in it (rank r = (c * frame + fr) * space + s, the order of
    `np.reshape(devices, (cfg, frame, space))`) and the groups:
    `cfg_group` the ranks of this rank's (fr, s) (one a CFG branch),
    `frame_group` those of its (c, s) (the frames of one block of rows),
    `space_group` those of its (c, fr) (the latent rows of one block of
    frames), `branch_group` those of its c (one CFG branch: the prior's
    frames), `all` every rank."""

    cfg: int
    frame: int
    space: int
    c: int
    fr: int
    s: int
    cfg_group: RowGroup
    frame_group: RowGroup
    space_group: RowGroup
    branch_group: RowGroup
    all: RowGroup

    def split_cfg(self, do_cfg: bool) -> bool:
        """Whether each cfg rank runs one CFG branch."""
        return do_cfg and self.cfg > 1


def inference_mesh(frame: int = 1) -> StoryMesh:
    """The mesh of sharded single-story inference over the process group
    (`distributed.maybe_initialize`), or over this process alone (a
    one-rank mesh) with no group; `frame` as `mesh_shape`'s. Every rank
    makes every group in the same order, as `dist.new_group` needs."""
    rank, world = distributed.rank_and_size()
    cfg, frame, space = mesh_shape(world, frame)
    c, rest = divmod(rank, frame * space)
    fr, s = divmod(rest, space)

    def rank_of(ci, fi, si):
        return (ci * frame + fi) * space + si

    def groups(keys, members, mine):
        """One group of `members(key)` ranks for each key, in order; this
        rank's group (its index in it) where `mine` is its key."""
        found = ONE_RANK
        for key in keys:
            ranks = members(key)
            if len(ranks) == 1:
                continue
            handle = dist.new_group(ranks)
            if key == mine:
                found = RowGroup(handle, len(ranks), ranks.index(rank))
        return found

    cells = [(i, j) for i in range(frame) for j in range(space)]
    cfg_group = groups(cells, lambda k: [rank_of(i, *k) for i in range(cfg)],
                       (fr, s))
    frame_group = groups(
        [(i, j) for i in range(cfg) for j in range(space)],
        lambda k: [rank_of(k[0], i, k[1]) for i in range(frame)], (c, s))
    space_group = groups(
        [(i, j) for i in range(cfg) for j in range(frame)],
        lambda k: [rank_of(*k, i) for i in range(space)], (c, fr))
    branch_group = groups(
        range(cfg), lambda k: [rank_of(k, *cell) for cell in cells], c)
    return StoryMesh(cfg, frame, space, c, fr, s, cfg_group, frame_group,
                     space_group, branch_group, RowGroup(None, world, rank))


@torch.no_grad()
def check_replicated(module: torch.nn.Module,
                     group: Optional[RowGroup]) -> None:
    """Raises RuntimeError unless every rank's parameters have rank 0's
    checksums: each tensor's sum and sum of squares in fp64, compared
    exactly (the weights are whole on every rank)."""
    if group is None or group.size == 1:
        return
    names, sums = [], []
    for name, p in module.named_parameters():
        x = p.detach().double()
        names.append(name)
        sums.append(torch.stack([x.sum(), (x * x).sum()]))
    parts = gather_list(torch.stack(sums), group)
    for r, part in enumerate(parts[1:], start=1):
        bad = (part != parts[0]).any(-1).nonzero().flatten().tolist()
        if bad:
            raise RuntimeError(
                f"--shard-story: rank {r}'s parameters differ from rank "
                f"0's ({len(bad)} tensors, the first {names[bad[0]]}): "
                f"every rank must load the same weights")
