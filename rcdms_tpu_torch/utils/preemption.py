"""Preemption-safe training, the port's counterpart of
`rcdms_tpu/utils/preemption.py`: SIGTERM (a cloud eviction's signal)
sets a flag; the training loop reads it at the step boundary, saves a
checkpoint through its normal path and exits cleanly, so no step is torn
and an eviction loses no more than the step in flight.

One process only: `should_stop_global` is the local flag. With a process
group of more than one rank it raises, because one rank's answer alone
would send the ranks into the save at different steps; the collective
version comes with data parallelism."""

from __future__ import annotations

import signal
import threading


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


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
        """The stop flag every process agrees on: on one process, the
        local flag. Raises under a process group of several ranks."""
        if _world_size() > 1:
            raise RuntimeError(
                "PreemptionGuard.should_stop_global answers for one process "
                "only; a process group of several ranks needs the "
                "collective stop flag of the data-parallel trainer")
        return self._event.is_set()

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
