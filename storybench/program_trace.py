"""The traced run's reading of the program's own spans: the `rcdms.*`
ranges that `rcdms_tpu_torch` opens itself (`utils/logging.py::span`),
between `trace.py`'s window marks, on the profiler's one clock.

For each span name: its count (the ranges that start in the window), its
host seconds (the union of its ranges' host intervals in the window) and
its device seconds (the device's busy time inside the span's device
intervals). A range's device interval runs from the first to the last
device operation launched inside it: a kernel belongs to a range when the
host call that launched it (the `cuda*` or `cu*` call of the kernel's
correlation id) started inside that range on the same thread, as
`trace.py` reads its own spans. The program's ranges are not user
annotations, so the profiler gives them no device interval of its own,
and the harness's spans keep theirs.

The window's idle gaps (the window less the device's busy time, as
`trace.read` computes them) are each put down to the innermost program
span open on the host at the gap's midpoint (the latest to start), or to
"outside program spans"; a loop span's idle seconds are those of the gaps
whose midpoint falls inside it. A record without program spans (a program
that opens none) reads empty: no span, every gap outside.

`storybench.run` does not call it yet: a run of one cell that also reads
the program's spans is

    python3 -m storybench.program_trace --workload <name> --seed <n> \
        --seconds <run_seconds> --trace 1

which is `storybench.run` with `trace.read` and `trace.breakdown`
extended for the run (`recording`): the record gains
`rec["trace"]["program"]`, and the result line's `breakdown` gains the
span table (`table`) and the readings of the four readers in `READERS`
(`storybench/metrics/<name>.py`, found by name as `run.result` finds a
metric's)."""

from __future__ import annotations

import contextlib
import sys

from torch.autograd import DeviceType

from storybench import data, run, trace

PROGRAM = "rcdms."
LOOPS = ("stage1.prior_loop", "stage2.unet_loop")
OUTSIDE = "outside program spans"
READERS = ("unet_loop.idle_s_per_story", "prior_loop.idle_s_per_story",
           "launch.host_s_per_story", "norm.device_s_per_story")


def _launched_inside(ranges, calls) -> list:
    """Each range's device interval [first start, last end] of the device
    operations launched inside it (None where it launched none). `ranges`:
    (start, end, thread); `calls`: (start, thread, (dev start, dev end))."""
    out = [None] * len(ranges)
    # opens sort before launches, launches before closes at one time
    points = [(s, 0, i) for i, (s, _, _) in enumerate(ranges)]
    points += [(e, 2, i) for i, (_, e, _) in enumerate(ranges)]
    points += [(t, 1, j) for j, (t, _, _) in enumerate(calls)]
    points.sort()
    open_on = {}
    for _, kind, k in points:
        if kind == 1:
            t, thread, (d0, d1) = calls[k]
            for i in open_on.get(thread, ()):
                iv = out[i]
                out[i] = (d0, d1) if iv is None else (min(iv[0], d0),
                                                      max(iv[1], d1))
        else:
            thread = ranges[k][2]
            if kind == 0:
                open_on.setdefault(thread, set()).add(k)
            else:
                open_on[thread].discard(k)
    return out


def read(prof) -> dict:
    """{"spans": {name: {"count", "host_s", "device_s"}}, "gaps": {label:
    s}, "loop_idle_s": {loop span: s}, "window_s", "busy_s"}; names
    without the "rcdms." prefix. One pass over the record, asking each
    event as little as it can: a traced call holds about a million."""
    marks, calls, names, ranges, ops, busy = {}, [], [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                k, s, t = e.correlation_id(), e.start_ns(), e.end_ns()
                busy.append((s, t))
                s0, t0 = ops.get(k, (s, t))
                ops[k] = (min(s, s0), max(t, t0))
            continue
        n = e.name()
        if n.startswith(PROGRAM):
            names.append(n[len(PROGRAM):])
            ranges.append((e.start_ns(), e.end_ns(), e.start_thread_id()))
        elif n.startswith(("cu", "__cu")):
            calls.append((e.correlation_id(), e.start_ns(),
                          e.start_thread_id()))
        elif n in (trace.START, trace.STOP):
            marks[n] = e.start_ns()
    if trace.START not in marks or trace.STOP not in marks:
        raise RuntimeError("traced run: the profiler's record lacks the "
                           "window's start or stop mark")
    w0, w1 = marks[trace.START], marks[trace.STOP]
    busy = trace._union(trace._clip(busy, w0, w1))
    busy_s = sum(t - s for s, t in busy) * 1e-9
    # the `cuda*` and `cu*` calls that launched a device operation
    calls = [(s, thread, ops[k]) for k, s, thread in calls if k in ops]
    device = _launched_inside(ranges, calls)
    by_name = {}
    for i, n in enumerate(names):
        by_name.setdefault(n, []).append(i)
    spans = {}
    for n, idx in sorted(by_name.items()):
        host = trace._union(trace._clip([ranges[i][:2] for i in idx],
                                        w0, w1))
        dev_iv = trace._union(trace._clip([device[i] for i in idx
                                           if device[i] is not None], w0, w1))
        spans[n] = dict(count=sum(w0 <= ranges[i][0] <= w1 for i in idx),
                        host_s=sum(t - s for s, t in host) * 1e-9,
                        device_s=trace._overlap(busy, dev_iv) * 1e-9)
    gaps, loop_idle = _gaps(names, ranges, busy, w0, w1)
    return dict(spans=spans, gaps=gaps, loop_idle_s=loop_idle,
                window_s=(w1 - w0) * 1e-9, busy_s=busy_s)


def _gaps(names, ranges, busy, w0, w1) -> tuple:
    """The window's idle gaps by the innermost program span open at each
    gap's midpoint, and each loop span's idle seconds."""
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    mids = [((a + b) / 2, (b - a) * 1e-9)
            for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    points = [(s, 0, i) for i, (s, _, _) in enumerate(ranges)]
    points += [(e, 2, i) for i, (_, e, _) in enumerate(ranges)]
    points += [(m, 1, j) for j, (m, _) in enumerate(mids)]
    points.sort()
    gaps, open_now = {}, set()
    loop_idle = {n: 0.0 for n in LOOPS if n in names}
    for _, kind, k in points:
        if kind == 0:
            open_now.add(k)
        elif kind == 2:
            open_now.discard(k)
        else:
            seconds = mids[k][1]
            if open_now:
                inner = max(open_now, key=lambda i: (ranges[i][0],
                                                     -ranges[i][1]))
                label = names[inner]
                for i in open_now:
                    if names[i] in loop_idle:
                        loop_idle[names[i]] += seconds
            else:
                label = OUTSIDE
            gaps[label] = gaps.get(label, 0.0) + seconds
    return gaps, loop_idle


def table(reading: dict) -> dict:
    """The diagnostic line's part: each span's count, host and device
    seconds, the loops' idle seconds and the 10 largest gaps."""
    top = sorted(reading["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return {"spans": {n: [s["count"], s["host_s"], s["device_s"]]
                      for n, s in reading["spans"].items()},
            "loop_idle_s": reading["loop_idle_s"],
            "gaps": [[n, s] for n, s in top]}


@contextlib.contextmanager
def recording():
    """`trace.read` and `trace.breakdown` extended, while the context is
    open: the reading of a traced window gains "program" (`read`), and
    its breakdown the span table and the readers' readings."""
    real_read, real_breakdown = trace.read, trace.breakdown

    def read_both(prof):
        return dict(real_read(prof), program=read(prof))

    def breakdown(reading):
        out = real_breakdown(reading)
        out["program"] = table(reading["program"])
        out["program_metrics"] = {m: data.reader(m)({"trace": reading})
                                  for m in READERS}
        return out

    trace.read, trace.breakdown = read_both, breakdown
    try:
        yield
    finally:
        trace.read, trace.breakdown = real_read, real_breakdown


def main(argv=None) -> int:
    with recording():
        return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
