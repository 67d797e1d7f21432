"""`program_trace.read` on a synthetic record (the profiler's events faked
as in `test_storybench_mixes.py`): nesting, a kernel's range by its
launch's thread, innermost-span gap attribution, the loops' idle sums and
gaps that sum to the window less its busy time; a record without program
spans; and a tiny traced run on the CPU under `program_trace.recording`,
whose record carries the program's stage and step spans, whose breakdown
carries their table and whose four readers read numbers, while a run
outside it reads as the harness alone reads."""

import pytest

from storybench import data, program_trace, run, trace
from storybench.tests import test_storybench_mixes as mixes

NS = 1e-9
READERS = program_trace.READERS


class _Event(mixes._Event):
    def __init__(self, name, cuda, start, end, corr=0, thread=1):
        super().__init__(name, cuda, start, end, corr)
        self._t = thread

    def start_thread_id(self):
        return self._t


def _prof(events):
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda s:
                                                  events})()
    return prof


def _span(name, start, end, thread=1):
    return _Event(program_trace.PROGRAM + name, False, start, end,
                  thread=thread)


def _record(program=True):
    """A window of 1000 ns: four kernels (busy 180 ns), launched at 50
    (the prior loop), 140 (inside a norm inside the UNet), 210 (inside a
    launch span) and 600 (the UNet loop, between steps); on thread 2 a
    span open at the launch at 140, which did not launch it."""
    host = [_Event(trace.START, False, 0, 1),
            _Event("cudaLaunchKernel", False, 50, 51, 4),
            _Event("cudaLaunchKernel", False, 140, 141, 1),
            _Event("cuLaunchKernel", False, 210, 211, 2),
            _Event("cudaLaunchKernel", False, 600, 601, 3),
            _Event(trace.STOP, False, 1000, 1001)]
    spans = [_span("generate", 10, 990),
             _span("stage1.prior_loop", 20, 90),
             _span("stage2.unet_loop", 100, 900),
             _span("story.step", 110, 500),
             _span("unet", 120, 400),
             _span("norm", 130, 150),
             _span("launch.geglu_ff", 200, 230),
             _span("serve.assemble", 135, 145, thread=2)]
    dev = [_Event(f"kernel_{k}", True, s, e, k)
           for k, s, e in ((4, 60, 80), (1, 300, 350), (2, 360, 380),
                           (3, 610, 700))]
    return _prof(host + (spans if program else []) + dev)


def test_spans_nest_and_take_the_kernels_launched_inside_them():
    r = program_trace.read(_record())
    assert r["window_s"] == pytest.approx(1000 * NS)
    assert r["busy_s"] == pytest.approx(180 * NS)
    device = {n: s["device_s"] / NS for n, s in r["spans"].items()}
    assert device == pytest.approx({
        "generate": 180, "stage1.prior_loop": 20, "stage2.unet_loop": 160,
        "story.step": 70, "unet": 70, "norm": 50, "launch.geglu_ff": 20,
        "serve.assemble": 0})
    assert r["spans"]["norm"]["host_s"] == pytest.approx(20 * NS)
    assert all(s["count"] == 1 for s in r["spans"].values())


def test_each_gap_goes_to_the_innermost_span_at_its_midpoint():
    r = program_trace.read(_record())
    gaps = {n: s / NS for n, s in r["gaps"].items()}
    assert gaps == pytest.approx({"stage1.prior_loop": 60, "unet": 230,
                                  "story.step": 230,
                                  "stage2.unet_loop": 300})
    assert sum(r["gaps"].values()) == pytest.approx(r["window_s"]
                                                    - r["busy_s"])


def test_a_loop_s_idle_time_is_its_gaps():
    r = program_trace.read(_record())
    idle = {n: s / NS for n, s in r["loop_idle_s"].items()}
    assert idle == pytest.approx({"stage1.prior_loop": 60,
                                  "stage2.unet_loop": 760})
    ctx = {"trace": dict(stories=2, program=r)}
    got = {m: data.reader(m)(ctx) / NS for m in READERS}
    assert got == pytest.approx({"unet_loop.idle_s_per_story": 380,
                                 "prior_loop.idle_s_per_story": 30,
                                 "launch.host_s_per_story": 15,
                                 "norm.device_s_per_story": 25})


def test_a_record_without_program_spans_reads_empty():
    r = program_trace.read(_record(program=False))
    assert r["spans"] == {} and r["loop_idle_s"] == {}
    assert r["gaps"] == pytest.approx({program_trace.OUTSIDE: 820 * NS})
    ctx = {"trace": dict(stories=2, program=r)}
    assert all(data.reader(m)(ctx) is None for m in READERS)
    assert all(data.reader(m)({"trace": dict(stories=2)}) is None
               for m in READERS)


def _tiny_traced_run():
    old = run.TRACE_SECONDS
    run.TRACE_SECONDS = 0.5
    try:
        return mixes._run("offline-b4", seconds=1.5, trace=1)
    finally:
        run.TRACE_SECONDS = old


def test_the_tiny_traced_run_reads_the_program_spans():
    real = trace.read, trace.breakdown
    with program_trace.recording():
        cfg, mix, rec = _tiny_traced_run()
        out = trace.breakdown(rec["trace"])
    assert (trace.read, trace.breakdown) == real
    p = rec["trace"]["program"]
    calls = rec["trace"]["calls"]
    spans = p["spans"]
    assert spans["generate"]["count"] == calls
    for stage in ("stage1.encode", "stage1.prior_loop", "stage2.encode",
                  "stage2.unet_loop", "stage2.decode"):
        assert spans[stage]["count"] == calls
    assert spans["prior.step"]["count"] == calls * cfg["prior_steps"]
    assert spans["story.step"]["count"] == calls * cfg["ddim_steps"]
    assert set(p["loop_idle_s"]) == set(program_trace.LOOPS)
    ctx = dict(rec, cfg=cfg)
    values = {m: data.reader(m)(ctx) for m in READERS}
    assert all(isinstance(v, float) and v >= 0 for v in values.values())
    assert values["unet_loop.idle_s_per_story"] > 0  # no card: all idle
    assert out["program_metrics"] == values
    assert out["program"] == program_trace.table(p)
    assert out["program"]["spans"]["generate"][0] == calls
    assert len(out["program"]["gaps"]) <= 10
    assert set(out) >= {"device_ops", "idle_gaps"}


def test_a_run_outside_recording_reads_as_the_harness_alone():
    cfg, mix, rec = _tiny_traced_run()
    assert "program" not in rec["trace"]
    assert set(trace.breakdown(rec["trace"])) == {"device_ops", "idle_gaps"}
    ctx = dict(rec, cfg=cfg)
    assert all(data.reader(m)(ctx) is None for m in READERS)
