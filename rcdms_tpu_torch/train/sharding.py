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
inference mesh at its default 'frame' axis of 1. Rank r of N is (cfg
index c, space index s) with r = c * space + s, the JAX mesh's device
order. The weights are whole on every rank. The samplers give CFG branch
c to the ranks of cfg index c and exchange the two predictions over the
cfg group; the UNet's and the VAE's rows split over the space group or
every rank, through the row helpers and the `spatial` context of
`core/spatial.py`, which take the place of `constrain`.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from rcdms_tpu_torch.core.spatial import RowGroup, gather_list
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

def mesh_shape(world: int) -> Tuple[int, int, int]:
    """(cfg, frame, space) of `world` ranks, the JAX `inference_mesh`'s
    rule at its default 'frame' axis of 1: cfg 2 when the world is even
    and above 1, else 1; space what remains."""
    cfg = 2 if world % 2 == 0 and world > 1 else 1
    return cfg, 1, world // cfg


class StoryMesh(NamedTuple):
    """The sizes of the ('cfg', 'space') mesh, this rank's cfg and space
    indices, and the groups: `cfg_group` the ranks of this rank's space
    index (one a CFG branch), `space_group` those of its cfg index (the
    latent rows of one branch), `all` every rank."""

    cfg: int
    space: int
    c: int
    s: int
    cfg_group: RowGroup
    space_group: RowGroup
    all: RowGroup

    def split_cfg(self, do_cfg: bool) -> bool:
        """Whether each cfg rank runs one CFG branch."""
        return do_cfg and self.cfg > 1


def inference_mesh() -> StoryMesh:
    """The mesh of sharded single-story inference over the process group
    (`distributed.maybe_initialize`), or over this process alone (a
    one-rank mesh) with no group. Every rank makes the cfg and space
    groups in the same order, as `dist.new_group` needs."""
    rank, world = distributed.rank_and_size()
    cfg, _, space = mesh_shape(world)
    c, s = divmod(rank, space)
    cfg_group = space_group = RowGroup(None, 1, 0)
    if cfg > 1:
        for j in range(space):
            ranks = [i * space + j for i in range(cfg)]
            handle = dist.new_group(ranks)
            if j == s:
                cfg_group = RowGroup(handle, cfg, c)
    if space > 1:
        for i in range(cfg):
            ranks = [i * space + j for j in range(space)]
            handle = dist.new_group(ranks)
            if i == c:
                space_group = RowGroup(handle, space, s)
    return StoryMesh(cfg, space, c, s, cfg_group, space_group,
                     RowGroup(None, world, rank))


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
