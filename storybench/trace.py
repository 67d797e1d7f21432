"""The traced run's reading of `torch.profiler`: the window, the device's
busy time (the union of its operations' intervals), the device seconds of
the kernels launched inside each harness span, the top device operations,
the idle gaps by what the host was doing, and the check that the record
holds the kernel of every launch it records.

A kernel belongs to a span when the host call that launched it (the
profiler's correlation of the kernel to its launching CPU event) started
inside that span on the same thread. Spans are the harness's own
(`port.Spans`), so a later kernel in place of an old one, or a library
call, is read against the same span.
"""

from __future__ import annotations

import bisect
import threading
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

SPAN = "storybench."
START, STOP = SPAN + "trace_start", SPAN + "trace_stop"
# host calls of the CUDA runtime and driver that launch one kernel each
LAUNCHES = ("cudaLaunchKernel", "__cudaLaunchKernel",
            "cudaLaunchCooperativeKernel", "cuLaunchKernel",
            "cuLaunchCooperativeKernel")
# the share of a record's launches that may lack their kernel: each lost
# kernel takes its time out of the readings, and at one launch in a
# thousand that stays under the per-layer readings' own spread between
# runs (0.5%); the drops seen were 4 of 165,386 launches, or most of a
# forward
MAX_UNMATCHED = 1e-3


class Tracer:
    """Profiles the end of the window: starts the profiler before the
    first `generate` call at or after `open_at` (a monotonic time, set by
    the loop to its close less the traced length), and stops it after the
    first call that ends at or after `close_at`, on the thread that runs
    the calls, so that the record holds whole calls and the profiler's
    cost to the host stays out of the calls before it."""

    def __init__(self, enabled: bool, seconds: float, cuda: bool = True,
                 spans=None):
        """`spans`: a context (`port.Spans`) entered while the profiler
        records, so that its spans and counts cover the traced calls
        alone."""
        self.enabled = enabled
        self.spans = spans
        self.activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        self.sync = torch.cuda.synchronize if cuda else (lambda: None)
        self.seconds = seconds
        self.open_at = self.close_at = None
        self.prof = None
        self.done = threading.Event()
        self.stories = 0
        self.calls = 0
        self.t0 = self.stopped_at = None

    def window(self, t_open: float, t_close: float):
        self.open_at = max(t_open, t_close - self.seconds)
        self.close_at = t_close

    def warm(self):
        """Start and stop the profiler once in set-up, so that its first
        start's cost (CUPTI's initialisation) stays out of the window."""
        if self.enabled:
            with profile(activities=self.activities):
                torch.ones(1).add_(1)
                self.sync()

    def before_call(self):
        if (not self.enabled or self.prof is not None
                or self.open_at is None or time.monotonic() < self.open_at):
            return
        self.sync()
        self.prof = profile(activities=self.activities)
        self.prof.start()
        with record_function(START):
            pass
        if self.spans is not None:
            self.spans.__enter__()
        self.t0 = time.monotonic()

    def after_call(self, stories: int):
        if self.prof is None or self.done.is_set():
            return
        self.stories += stories
        self.calls += 1
        if time.monotonic() >= self.close_at:
            self.finish()

    def finish(self):
        """Stop the profiler after the last traced call (on the thread
        that started it)."""
        self.sync()
        if self.spans is not None:
            self.spans.__exit__(None, None, None)
        with record_function(STOP):
            pass
        self.prof.stop()
        self.stopped_at = time.monotonic()
        self.done.set()

    def pending(self) -> bool:
        """Tracing, and not done yet."""
        return self.enabled and not self.done.is_set()


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals, w0, w1):
    return [(max(s, w0), min(e, w1)) for s, e in intervals
            if min(e, w1) > max(s, w0)]


def _overlap(a, b) -> float:
    """Length of the intersection of two sorted, merged interval lists."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(prof) -> dict:
    """Everything the per-layer readers take from one traced window.

    Device time inside a span: the profiler gives each host span a device
    interval (from the first to the last kernel launched inside it); on
    the one stream the calls run on, the device's busy time inside those
    intervals is the time of the kernels the span launched.

    `launches` counts the launch calls the host made in the window,
    `unmatched` those of them with no device operation of their
    correlation id in the record, and `unmatched_under` names the host
    operation each of those was made under."""
    cpu, dev, dev_spans = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA:
            cpu.append(e)
        elif name.startswith(SPAN):
            dev_spans.setdefault(name[len(SPAN):], []).append(
                (e.start_ns(), e.end_ns()))
        elif not e.is_user_annotation():
            dev.append(e)
    marks = {e.name(): e.start_ns() for e in cpu if e.name() in (START, STOP)}
    if START not in marks or STOP not in marks:
        raise RuntimeError("traced run: the profiler's record lacks the "
                           "window's start or stop mark")
    w0, w1 = marks[START], marks[STOP]
    host = {}
    for e in cpu:
        n = e.name()
        if n.startswith(SPAN) and n not in (START, STOP):
            host.setdefault(n[len(SPAN):], []).append(
                (e.start_ns(), e.end_ns()))
    host = {n: _union(iv) for n, iv in host.items()}
    launched = {e.correlation_id(): e for e in cpu
                if e.name().startswith(LAUNCHES)
                and w0 <= e.start_ns() <= w1}
    unmatched = set(launched) - {e.correlation_id() for e in dev}
    op_names = {e.correlation_id(): e.name() for e in cpu
                if not e.name().startswith(("cu", "__cu"))}
    unmatched_under = {}
    for k in unmatched:
        n = op_names.get(launched[k].linked_correlation_id(), "?")
        unmatched_under[n] = unmatched_under.get(n, 0) + 1
    ops, intervals = {}, []
    for e in dev:
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t <= s:
            continue
        name = e.name()
        intervals.append((s, t))
        ops[name] = ops.get(name, 0.0) + (t - s) * 1e-9
    busy = _union(intervals)
    busy_s = sum(t - s for s, t in busy) * 1e-9
    span_s = {n: _overlap(busy, _union(_clip(iv, w0, w1))) * 1e-9
              for n, iv in dev_spans.items()}

    def inside(name, t):
        iv = host.get(name)
        if not iv:
            return False
        i = bisect.bisect_right(iv, [t, float("inf")]) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]

    # idle gaps inside the window, by the innermost span open on the host
    gaps, edges = {}, [w0] + [x for iv in busy for x in iv] + [w1]
    depth = ("attention", "ff", "unet", "prior", "text", "vision", "vae",
             "fusion", "call")
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        label = next((f"host in {n}" for n in depth
                      if inside(n, (a + b) // 2)), "host outside calls")
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-9
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy_s, span_s=span_s,
                ops=ops, gaps=gaps, launches=len(launched),
                unmatched=len(unmatched), unmatched_under=unmatched_under)


def check_whole(reading: dict) -> None:
    """The record must hold a kernel for every kernel launch it records,
    matched by the profiler's correlation id, whatever the kernels' names,
    but for `MAX_UNMATCHED` of them: the profiler has dropped records of
    long forwards, and a short record would read low. A record with no
    launch at all is not whole either."""
    n, lost = reading["launches"], reading["unmatched"]
    if not n or lost > MAX_UNMATCHED * n:
        raise RuntimeError(f"traced run: the profiler's record is not whole:"
                           f" {lost} of {n} kernel launches have no kernel "
                           f"in it, under {reading.get('unmatched_under')}")


def breakdown(reading: dict) -> dict:
    top = sorted(reading["ops"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(reading["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
