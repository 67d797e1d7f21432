"""Preemption-safe training, the port's counterpart of
`rcdms_tpu/utils/preemption.py`: SIGTERM (a cloud eviction's signal)
sets a flag; the training loop reads it at the step boundary, saves a
checkpoint through its normal path and exits cleanly, so no step is torn
and an eviction loses no more than the step in flight.

Under a process group `should_stop_global` is a collective, the MAX of
the ranks' flags over the host-side gloo group
(`train/distributed.py::host_group`), so it never waits for the card:
a SIGTERM to any rank stops every rank at the same step boundary, and
they enter the checkpoint's collectives together."""

from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Installs SIGTERM (and optionally other) handlers that set a flag.

        guard = PreemptionGuard.install()
        for step in ...:
            state, loss = step_fn(...)
            if guard.should_stop_global():
                save_checkpoint(...)
                break
    """

    def __init__(self):
        self._event = threading.Event()
        self._prev = {}

    @property
    def should_stop(self) -> bool:
        return self._event.is_set()

    def trigger(self, signum=None, frame=None) -> None:
        self._event.set()

    def should_stop_global(self) -> bool:
        """The stop flag every process agrees on: the local flag with no
        process group; under one, a collective that every rank calls at
        the same point of each step, true when any rank's flag is set
        (which then sets this rank's too)."""
        from rcdms_tpu_torch.train import distributed

        local = self._event.is_set()
        if not distributed.active():
            return local
        import torch
        import torch.distributed as dist

        flag = torch.tensor([int(local)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX,
                        group=distributed.host_group())
        if flag.item():
            self._event.set()
        return bool(flag.item())

    @classmethod
    def install(cls, signals=(signal.SIGTERM,)) -> "PreemptionGuard":
        guard = cls()
        for sig in signals:
            try:
                guard._prev[sig] = signal.signal(sig, guard.trigger)
            except (ValueError, OSError):
                pass  # not the main thread, or no such signal: flag only
        return guard

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
