"""Background batch prefetching, the port's counterpart of
`rcdms_tpu/data/prefetch.py`: one daemon thread drains the dataset's
iterator into a bounded queue while the card runs the previous step, so
host decode and packing overlap device work.

The native feeder (`data/native_feeder.py`) returns read-only views into
a ring of `feeder_buffer_depth` buffers that are reused after that many
`pack_batch` calls. With prefetching, up to `depth + 2` batches are alive
at once (one held by the consumer, `depth` queued, one being packed), so
the ring must be at least that deep: `required_feeder_depth(depth)`; the
training CLIs size it so."""

from __future__ import annotations

import queue
import threading
from typing import Iterator


def required_feeder_depth(prefetch_depth: int) -> int:
    """The least native-feeder ring depth under which no held or queued
    batch is overwritten while the producer packs ahead: the consumer's
    (1), the queued (depth) and the one in flight (1)."""
    return prefetch_depth + 2


class PrefetchIterator:
    """A batch iterator behind a depth-bounded background thread.

        batches = PrefetchIterator(dataset.batches(...), depth=1)
        for _ in range(steps):
            batch = next(batches)
        batches.close()
    """

    _SENTINEL = object()

    def __init__(self, it: Iterator, depth: int = 1):
        assert depth >= 1
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._stop = threading.Event()

        def run():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    # a bounded put that re-reads the stop flag, so close()
                    # can always unblock the producer
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # raised again by next()
                self._err = e
            finally:
                # the sentinel must reach the consumer at the end of the
                # iterator (or an error): give up only once close() stopped
                # consumption
                while not self._stop.is_set():
                    try:
                        self._q.put(self._SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="rcdms-prefetch")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            # after close() the producer may have left without a sentinel;
            # a blocking get() would never return
            raise StopIteration
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, join_timeout: float = 5.0):
        """Stop the producer thread. Safe to call more than once; the
        underlying iterator (and the h5 file or feeder it drives) is no
        longer advanced once the thread has left."""
        self._stop.set()
        # wake a consumer blocked in get()
        try:
            self._q.put_nowait(self._SENTINEL)
        except queue.Full:
            pass
        # drain, so a blocked put() sees the flag and the thread leaves
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
            if not self._thread.is_alive():
                break
            if join_timeout <= 0:
                break
            join_timeout -= 0.05
