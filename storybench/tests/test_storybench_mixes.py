"""Each mix's loop at a tiny size on the CPU: the closed loop of
`generate` calls and the open loop into `StoryServer.submit`, their
records, the readers of their metrics and the check."""

import pytest
import torch
from torch.autograd import DeviceType

from storybench import data, run, trace, traffic
from storybench.tests import tiny

CPU = torch.device("cpu")


def _run(name, seconds=1.5, trace=0, **kw):
    cfg, mix = tiny.config(), tiny.mix(name, **kw)
    rec = run.measure(cfg, mix, 21, seconds, trace, CPU)
    return cfg, mix, rec


def _metrics(rec, cfg, workload, kind):
    bench = data.benchmark()
    ctx = dict(rec, cfg=cfg)
    return {m["name"]: data.reader(m["name"])(ctx)
            for m in data.metrics_of(bench, workload, kind)}


def test_closed_loop():
    cfg, mix, rec = _run("offline-b4")
    b = mix["batch"]
    assert rec["attempted"] == b * len(rec["calls"]) and rec["failed"] == 0
    assert rec["frames"] == rec["attempted"] * cfg["num_frames"]
    assert rec["t_close"] - rec["t_open"] >= 1.5
    parts = mix["check"]
    assert sorted(i % b * parts // b for i in rec["outputs"]) == \
        list(range(parts))  # one story from each part of the batch
    m = _metrics(rec, cfg, "flintstones-offline-b4", "end_to_end")
    assert m["frames_per_s"] > 0 and 0 < m["setup_s"] < rec["t_open"]
    ok, shown, _ = run.check(cfg, mix, 21, rec, CPU, "flintstones-offline-b4")
    assert ok and set(shown) == {"frames_mean_abs", "embeds_rel"}


def test_open_loop():
    cfg, mix, rec = _run("served-steady", seconds=2.0, rate_per_s=6.0,
                         lead_s=0.5)
    dues, lead = traffic.arrivals(mix, 0.5, 2.0)
    assert rec["attempted"] == len(rec["window"]) == sum(
        lead <= d < lead + 2.0 for d in dues)
    assert rec["failed"] == 0 and rec["errors"] == 0
    assert len(rec["latencies"]) == rec["attempted"]
    assert all(1 <= b <= mix["max_batch"] for b in rec["batch_sizes"])
    ctx = dict(rec, cfg=cfg)
    assert data.reader("story_latency_p50_s")(ctx) > 0
    assert 1 <= data.reader("serve.batch_mean")(ctx) <= mix["max_batch"]
    assert data.reader("setup_s")(ctx) > 0
    ok, shown, _ = run.check(cfg, mix, 21, rec, CPU, "pororosv-served-steady")
    assert ok and set(shown) == {"frames_mean_abs"}


@pytest.mark.parametrize("name", ["offline-b4", "served-steady"])
def test_traced_run_reads_its_spans(name):
    old = run.TRACE_SECONDS
    run.TRACE_SECONDS = 0.5
    try:
        kw = {} if name == "offline-b4" else dict(rate_per_s=6.0, lead_s=0.5)
        cfg, mix, rec = _run(name, seconds=1.5, trace=1, **kw)
    finally:
        run.TRACE_SECONDS = old
    t = rec["trace"]
    assert t["stories"] > 0 and t["window_s"] > 0
    assert t["work"]["attention"] and t["work"]["ff"]
    assert t["t0"] >= rec["t_open"]


def test_jittered_arrivals_are_fixed_and_keep_the_rate():
    mix = tiny.mix("served-steady", rate_per_s=0.5)
    dues, lead = traffic.arrivals(mix, 5.0, 10.0)
    assert dues == traffic.arrivals(mix, 5.0, 10.0)[0]
    assert lead == 6.0 and len(dues) == 8
    assert all(2.0 * k <= d < 2.0 * (k + 1) for k, d in enumerate(dues))
    assert len({round(d % 2.0, 6) for d in dues}) == 8


def test_a_story_is_the_same_in_any_batch():
    cfg, mix = tiny.config(), tiny.mix("served-steady")
    a, b = (traffic.story(cfg, mix, 3, 7, CPU) for _ in range(2))
    assert all(torch.equal(a["inputs"][k], b["inputs"][k])
               for k in a["inputs"])
    other = traffic.story(cfg, mix, 3, 8, CPU)
    assert not torch.equal(a["inputs"]["tokens_s1"],
                           other["inputs"]["tokens_s1"])
    n = traffic.noise(cfg, a["noise_seed"], CPU)
    assert n["prior_steps"].shape[0] == cfg["prior_steps"]


class _Event:
    def __init__(self, name, cuda, start, end, corr):
        self._n, self._c, self._s, self._e, self._k = name, cuda, start, \
            end, corr

    def name(self):
        return self._n

    def device_type(self):
        return DeviceType.CUDA if self._c else DeviceType.CPU

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._k

    def linked_correlation_id(self):
        return 0


def _record(kernels):
    """A profiler's record: the window's marks, three launches (runtime,
    extended runtime, driver) with correlation ids 1-3, one copy, and
    device operations of the given correlation ids."""
    host = [_Event(trace.START, False, 0, 1, 0),
            _Event("cudaLaunchKernel", False, 10, 11, 1),
            _Event("cudaLaunchKernelExC", False, 20, 21, 2),
            _Event("cuLaunchKernelEx", False, 30, 31, 3),
            _Event("cudaMemcpyAsync", False, 40, 41, 4),
            _Event(trace.STOP, False, 1000, 1001, 0)]
    dev = [_Event(f"any_kernel_{k}", True, 100 * k, 100 * k + 50, k)
           for k in kernels]
    events = host + dev
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda s:
                                                  events})()
    return prof


@pytest.mark.parametrize("kernels,unmatched", [([1, 2, 3, 4], 0),
                                               ([1, 3], 1), ([], 3)])
def test_a_record_is_whole_when_every_launch_has_its_kernel(kernels,
                                                             unmatched):
    reading = trace.read(_record(kernels))
    assert reading["launches"] == 3 and reading["unmatched"] == unmatched
    if unmatched:
        with pytest.raises(RuntimeError, match="not whole"):
            trace.check_whole(reading)
    else:
        trace.check_whole(reading)
        assert reading["busy_s"] == pytest.approx(200e-9)


@pytest.mark.parametrize("launches,unmatched,whole", [
    (0, 0, False), (1000, 1, True), (1000, 2, False), (165386, 4, True)])
def test_a_record_may_lack_one_kernel_in_a_thousand(launches, unmatched,
                                                    whole):
    reading = dict(launches=launches, unmatched=unmatched)
    if whole:
        trace.check_whole(reading)
    else:
        with pytest.raises(RuntimeError, match="not whole"):
            trace.check_whole(reading)
