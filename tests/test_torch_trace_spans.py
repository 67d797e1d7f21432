"""The port's own spans and counters (rcdms_tpu_torch/utils/logging.py::
span, the spans of `StoryPipeline.generate`, the samplers, the models'
layers and the server, and `StoryServer`'s counters) on the CPU: a tiny
pipeline's `generate` under `torch.profiler` records the stages inside
`rcdms.generate`, the steps inside the loops and the layers inside the
model calls, with the counts the pipeline's settings give; without a
profiler on the calling thread `span` is one shared no-op; a tiny server
counts queue waits, batch sizes and CondCache hits, misses and uncached
batches, shows them on `/healthz` beside its unchanged keys, and its
spans carry their batch's request ids."""

import json
import sys
import threading
import time
import urllib.request
from collections import Counter
from http.server import ThreadingHTTPServer

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rcdms_tpu_torch.cli import serve as pserve
from rcdms_tpu_torch.core.layers import FeedForward, GroupNorm, LayerNorm
from rcdms_tpu_torch.ops.attention import multihead_attention
from rcdms_tpu_torch.sample.pipeline import build_tiny_pipeline
from rcdms_tpu_torch.utils.logging import NO_SPAN, SPAN, span
from tests.test_torch_configs import one_torch_thread  # noqa: F401

STEPS = 3
STAGES = ["stage1.encode", "stage1.prior_loop", "stage2.encode",
          "stage2.unet_loop", "stage2.decode"]
TIMEOUT = 60  # seconds, every urlopen and join
CPU = ["--synthetic", "--device", "cpu", "--num-inference-steps", "2"]


def _ranges(prof) -> list:
    """(name without the prefix, start, end, recorded args) of every
    program span, in start order."""
    return sorted(((e.name()[len(SPAN):], e.start_ns(), e.end_ns(),
                    e.kwinputs())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(SPAN)), key=lambda r: r[1])


def _parent(ranges, i):
    """The name of the innermost span around span i, or None."""
    _, s, e, _ = ranges[i]
    around = [r for j, r in enumerate(ranges) if j != i
              and r[1] <= s and e <= r[2] and (r[1], -r[2]) < (s, -e)]
    return max(around, key=lambda r: (r[1], -r[2]))[0] if around else None


def _counting(monkeypatch, calls: Counter):
    """Count module forwards by class, and `multihead_attention` calls
    where the port's modules call it."""
    def count(mod, args):
        calls[type(mod).__name__] += 1

    def counted(*a, **kw):
        calls["attention"] += 1
        return multihead_attention(*a, **kw)

    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("rcdms_tpu_torch.") and \
                getattr(mod, "multihead_attention", None) is \
                multihead_attention:
            monkeypatch.setattr(mod, "multihead_attention", counted)
    return count


@pytest.mark.parametrize("options,unet_calls", [
    ({}, 2 * STEPS),                          # CFG one branch after the other
    ({"sequential_cfg": False}, STEPS),       # both branches in one call
    ({"encoder_propagation": 2}, 2 * STEPS),  # encode on key steps alone
])
def test_generate_records_the_stages_steps_and_layers(monkeypatch, options,
                                                      unet_calls):
    pipe, inputs = build_tiny_pipeline(num_steps=STEPS, **options)
    calls = Counter()
    count = _counting(monkeypatch, calls)
    hooks = [m.register_forward_pre_hook(count) for m in pipe.modules()
             if isinstance(m, (GroupNorm, LayerNorm, FeedForward))]
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        pipe.generate(inputs, generator=torch.Generator().manual_seed(0))
    for h in hooks:
        h.remove()
    ranges = _ranges(prof)
    names = Counter(r[0] for r in ranges)
    assert names["generate"] == 1 and all(names[s] == 1 for s in STAGES)
    assert names["prior.step"] == names["story.step"] == STEPS
    assert names["prior"] == STEPS and names["unet"] == unet_calls
    assert names["norm"] == calls["GroupNorm"] + calls["LayerNorm"] > 0
    assert names["ff"] == calls["FeedForward"] > 0
    assert names["attention"] == calls["attention"] > 0
    assert not [n for n in names if n.startswith("launch.")]  # plain path
    parents = {}
    for i, r in enumerate(ranges):
        parents.setdefault(r[0], set()).add(_parent(ranges, i))
    assert parents["generate"] == {None}
    assert all(parents[s] == {"generate"} for s in STAGES)
    assert parents["prior.step"] == {"stage1.prior_loop"}
    assert parents["story.step"] == {"stage2.unet_loop"}
    assert parents["prior"] == {"prior.step"}
    assert parents["unet"] == {"story.step"}
    inside_unet = {r[0] for i, r in enumerate(ranges)
                   if _parent(ranges, i) == "unet"}
    assert {"attention", "ff", "norm"} <= inside_unet
    (args,) = [r[3] for r in ranges if r[0] == "generate"]
    assert args["batch"] == 1 and args["call"] >= 1


def test_generate_numbers_its_calls():
    pipe, inputs = build_tiny_pipeline(num_steps=1)
    numbers = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            pipe.generate(inputs, generator=torch.Generator().manual_seed(0))
        numbers += [r[3]["call"] for r in _ranges(prof)
                    if r[0] == "generate"]
    assert numbers[1] == numbers[0] + 1


def test_without_a_profiler_a_span_is_the_shared_noop():
    assert not torch.autograd._profiler_enabled()
    assert span("x") is span("y", {"call": 1}) is NO_SPAN
    with span("x") as s:
        assert s is NO_SPAN
    pipe, inputs = build_tiny_pipeline(num_steps=1)
    pipe.generate(inputs, generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert _ranges(prof) == []  # nothing held over from the call before


def test_a_profiler_on_another_thread_leaves_this_one_off():
    started, release = threading.Event(), threading.Event()
    seen = {}

    def profiled():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("there") as s:
                seen["there"] = s
            started.set()
            release.wait(TIMEOUT)
        seen["ranges"] = _ranges(prof)

    t = threading.Thread(target=profiled)
    t.start()
    try:
        assert started.wait(TIMEOUT)
        assert span("here") is NO_SPAN
        with span("here"):
            torch.ones(2).add_(1)
    finally:
        release.set()
        t.join(TIMEOUT)
    assert seen["there"] is not NO_SPAN
    assert [r[0] for r in seen["ranges"]] == ["there"]


@pytest.fixture(scope="module")
def idle_server():
    """A StoryServer whose dispatch thread never starts: this thread takes
    its batches and runs them, as the dispatch thread would."""
    args = pserve.parse_args(["--max-batch", "2", "--max-wait-ms", "20"]
                             + CPU)
    return pserve.StoryServer(args.eval, args.max_batch, args.max_wait_ms)


def _submit(srv, negative, seed):
    f = srv.ds_cfg.num_frames
    r = srv.submit(srv.story_inputs([f"caption {i}" for i in range(f)], [],
                                    negative), seed)
    assert r is not None
    return r


def _serve_once(srv, requests, wait_s=0.0):
    time.sleep(wait_s)
    batch = srv._take_batch()
    assert batch == requests
    srv._run(batch)


def _health(srv) -> dict:
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), pserve.Handler)
    httpd.story = srv
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
            return json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(TIMEOUT)


def test_the_server_counts_waits_batches_and_cond_caches(idle_server):
    srv = idle_server
    pair = [_submit(srv, "", 1), _submit(srv, "", 2)]
    _serve_once(srv, pair, wait_s=0.1)         # a CondCache miss
    lone = [_submit(srv, "", 3)]
    _serve_once(srv, lone)                     # a hit
    mixed = [_submit(srv, "dark", 4), _submit(srv, "blurry", 5)]
    _serve_once(srv, mixed)                    # uncached
    served = pair + lone + mixed
    assert srv.served == 5
    assert srv.batches_by_size == {2: 2, 1: 1}
    assert (srv.cond_cache_hits, srv.cond_cache_misses,
            srv.uncached_batches) == (1, 1, 1)
    waits = [r.t_taken - r.t0 for r in served]
    assert min(waits[:2]) >= 0.1 and all(w >= 0 for w in waits)
    assert srv.queue_wait_s == pytest.approx(sum(waits))
    assert srv.queue_wait_max_s == max(waits)
    health = _health(srv)
    assert sorted(health) == sorted([
        "status", "num_frames", "image_size", "compiled", "served",
        "pending", "avg_latency_s", "avg_queue_wait_s", "max_queue_wait_s",
        "batches_by_size", "cond_cache"])
    assert health["status"] == "ok" and health["served"] == 5
    assert health["compiled"] == [1, 2] and health["pending"] == 0
    assert health["num_frames"] == srv.ds_cfg.num_frames
    assert health["image_size"] == srv.ds_cfg.image_size
    assert health["avg_latency_s"] == round(srv.total_latency_s / 5, 4)
    assert health["avg_queue_wait_s"] == round(sum(waits) / 5, 4)
    assert health["max_queue_wait_s"] == round(max(waits), 4)
    assert health["batches_by_size"] == {"1": 1, "2": 2}
    assert health["cond_cache"] == {"hits": 1, "misses": 1, "uncached": 1}


def test_a_request_run_without_the_queue_waited_none(idle_server):
    srv = idle_server
    before = srv.queue_wait_s
    f = srv.ds_cfg.num_frames
    r = pserve._Request(srv.story_inputs(["x"] * f, [], ""), 9)
    srv._run([r])
    assert r.t_taken == r.t0 and srv.queue_wait_s == before


def test_the_server_spans_carry_their_batch_s_request_ids(idle_server):
    srv = idle_server
    batch = [_submit(srv, "", 6), _submit(srv, "", 7)]
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        _serve_once(srv, batch)
    ranges = _ranges(prof)
    ids = ",".join(str(r.id) for r in batch)
    for name in ("serve.assemble", "serve.copy_out"):
        (args,) = [r[3] for r in ranges if r[0] == name]
        assert args == {"requests": ids}
    order = [r[0] for r in ranges if r[0] in ("serve.assemble", "generate",
                                              "serve.copy_out")]
    assert order == ["serve.assemble", "generate", "serve.copy_out"]
    assert batch[0].id + 1 == batch[1].id
