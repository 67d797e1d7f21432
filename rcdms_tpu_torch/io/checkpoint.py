"""Training checkpoints: the port's counterpart of
`rcdms_tpu/io/checkpoint.py`, on torch files instead of orbax.

Layout, as orbax's `CheckpointManager` lays out its steps:

    <directory>/<step>/state.pt        torch.save of the state tree
    <directory>/<step>/metadata.json   the metadata ({"last_global_step",
                                       "preempted", ...})

The state is a tree of dicts of tensors and plain Python values (ints,
floats, None), read back with `torch.load(weights_only=True)`, so a
checkpoint runs no pickled code. A save is written into a temporary
sibling (`.<step>.tmp-<pid>`, not a step name), then renamed: a directory
with a step's name is complete, and a save cut short leaves only the
temporary one, which no reader takes. Orbax's two rules are kept: a save
at or below the latest step on disk is skipped (the first save of a step
stays), and only the `max_to_keep` newest steps stay.

A training state saved from a process group (`save_train_state`) is
written in the same format by rank 0, from the optimizer-state cuts
gathered to its host memory, and every rank of any group size restores
its own cut of it (`TrainState.load_state_dicts`): a checkpoint does not
depend on the number of ranks that wrote or read it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

STATE_FILE = "state.pt"
METADATA_FILE = "metadata.json"


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit()
                  and os.path.isdir(os.path.join(directory, name)))


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step under `directory`, None if there is none
    (or no directory)."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_checkpoint(directory: str, step: int, state: Any,
                    metadata: Optional[Dict] = None,
                    max_to_keep: int = 3) -> bool:
    """Write `state` (a tree of dicts of tensors and plain values; tensors
    on any device are written from the host) and `metadata` as step
    `step`. Returns False, writing nothing, when a step at or above `step`
    is on disk already."""
    latest = latest_step(directory)
    if latest is not None and latest >= step:
        return False
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f".{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        torch.save(state, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, METADATA_FILE), "w") as fh:
            json.dump(metadata or {}, fh)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in _steps(directory)[:-max_to_keep] if max_to_keep else []:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)
    return True


def save_train_state(directory: str, step: int, state,
                     metadata: Optional[Dict] = None,
                     max_to_keep: int = 3) -> bool:
    """`save_checkpoint` of a `TrainState`'s whole tree
    (`TrainState.host_state_dicts`) from every rank of its process group:
    rank 0 writes (and rotates `max_to_keep`), the others wait for it at a
    barrier of the host group. Returns whether rank 0 wrote the step."""
    import torch.distributed as dist

    from rcdms_tpu_torch.train import distributed

    tree = state.host_state_dicts()
    wrote = tree is not None and save_checkpoint(
        directory, step, tree, metadata, max_to_keep=max_to_keep)
    del tree
    if distributed.active():
        dist.barrier(group=distributed.host_group())
    return wrote


def _into(target: Any, loaded: Any, where: str = "state") -> Any:
    """`loaded` copied into `target`'s tensors in place (each keeps its
    device and dtype); the tree's other values are taken from `loaded`."""
    if isinstance(target, dict):
        if not isinstance(loaded, dict) or set(target) != set(loaded):
            theirs = set(loaded) if isinstance(loaded, dict) else set()
            raise KeyError(f"{where}: keys differ: "
                           f"{sorted(map(str, set(target) ^ theirs))[:5]}")
        return {k: _into(v, loaded[k], f"{where}.{k}")
                for k, v in target.items()}
    if isinstance(target, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) \
                or loaded.shape != target.shape:
            raise ValueError(f"{where}: checkpoint holds "
                             f"{getattr(loaded, 'shape', type(loaded))}, "
                             f"target {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(loaded)
        return target
    return loaded


def restore_checkpoint(directory: str, target: Any = None,
                       step: Optional[int] = None
                       ) -> Tuple[Any, Dict, int]:
    """(state, metadata, step) of `step`, or of the latest step. With a
    `target` tree of the same keys, the tensors are copied into its
    tensors (on their devices) and the target is returned; without one,
    the tensors come back on the CPU, mapped from the file."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no checkpoint directory {directory}")
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, str(step))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no step {step} under {directory}")
    state = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                       weights_only=True, mmap=True)
    with open(os.path.join(path, METADATA_FILE)) as fh:
        metadata = json.load(fh)
    if target is not None:
        state = _into(target, state)
    return state, metadata, step


def is_checkpoint_dir(directory: str) -> bool:
    """Whether `directory` holds a step written by `save_checkpoint`."""
    step = latest_step(directory)
    return step is not None and os.path.isfile(
        os.path.join(directory, str(step), STATE_FILE))
