"""The port's serving CLI (rcdms_tpu_torch/cli/serve.py) on the tiny
synthetic pipeline on the CPU, behind a real HTTP server on port 0: the
JAX serve tests' cases (health and one request, a reference frame and the
400s, concurrent requests batching, backpressure, `--precompile` without a
port), then what the port adds: a request's frames do not depend on its
batch companions (1e-5 in fp32), a batch that mixes negative prompts runs
uncached and gives each request its cached result, and the per-negative-
prompt cond caches stay within their LRU bound, and a stopped server is
freed without the garbage collector."""

import base64
import gc
import json
import struct
import threading
import time
import urllib.error
import urllib.request
import weakref
import zlib

import numpy as np
import pytest
import torch

from rcdms_tpu_torch.cli import serve as pserve
from rcdms_tpu_torch.sample.eval import (PNG_SIGNATURE, _png_chunk,
                                         decode_png, encode_png)
from tests.test_torch_configs import one_torch_thread  # noqa: F401

TIMEOUT = 60  # seconds, every urlopen and join
CPU = ["--synthetic", "--device", "cpu", "--num-inference-steps", "2"]


@pytest.fixture(scope="module")
def server():
    args = pserve.parse_args(["--port", "0", "--max-batch", "2",
                              "--max-wait-ms", "120"] + CPU)
    ready = threading.Event()
    box = []
    t = threading.Thread(target=pserve.serve, args=(args,),
                         kwargs=dict(ready_event=ready, httpd_box=box),
                         daemon=True)
    t.start()
    assert ready.wait(timeout=TIMEOUT), "server failed to start"
    httpd, story_server = box[0]
    yield f"http://127.0.0.1:{httpd.server_address[1]}", story_server
    httpd.shutdown()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def idle_server():
    """A StoryServer whose dispatch thread never starts: `_run` and the
    caches are driven directly."""
    args = pserve.parse_args(["--max-batch", "3"] + CPU)
    return pserve.StoryServer(args.eval, args.max_batch, args.max_wait_ms)


def _post(url, payload, path="/generate"):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _status(url, payload, path="/generate"):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, payload, path)
    return e.value.code


def _captions(f, tag="caption"):
    return [f"{tag} {i}" for i in range(f)]


def test_healthz_and_single_request(server):
    url, srv = server
    with urllib.request.urlopen(url + "/healthz", timeout=TIMEOUT) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok"
    f, size = health["num_frames"], health["image_size"]
    assert 1 in health["compiled"]  # the warmup ran batch 1
    out = _post(url, {"captions": _captions(f), "seed": 7})
    assert len(out["frames"]) == f and out["batch_size"] >= 1
    img = decode_png(base64.b64decode(out["frames"][0]))
    assert img.shape == (size, size, 3)
    with urllib.request.urlopen(url + "/healthz", timeout=TIMEOUT) as r:
        assert json.loads(r.read())["served"] >= 1


def test_reference_frame_and_errors(server):
    url, srv = server
    f, size = srv.ds_cfg.num_frames, srv.ds_cfg.image_size
    ref = np.random.default_rng(0).integers(0, 255, (size, size, 3),
                                            dtype=np.uint8)
    out = _post(url, {"captions": _captions(f), "reference_frames":
                      [base64.b64encode(encode_png(ref)).decode()]})
    assert len(out["frames"]) == f

    assert _status(url, {"captions": ["only one"]}) == 400
    assert _status(url, {"seed": 1}) == 400  # no captions
    for seed in (-1, 2 ** 64, "x"):
        assert _status(url, {"captions": _captions(f), "seed": seed}) == 400
    for data in (b"not an image", b"\xff\xd8\xff\xe0 a jpeg header"):
        assert _status(url, {"captions": _captions(f), "reference_frames":
                             [base64.b64encode(data).decode()]}) == 400
    assert _status(url, {"captions": _captions(f),
                         "reference_frames": ["%%% not base64"]}) == 400
    # a few bytes that declare more pixels than a reference frame may have
    side = int(pserve.MAX_REFERENCE_PIXELS ** 0.5)
    for w, h in ((side + 1, side), (30000, 30000)):
        header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
        png = (PNG_SIGNATURE + _png_chunk(b"IHDR", header)
               + _png_chunk(b"IDAT", zlib.compress(b""))
               + _png_chunk(b"IEND", b""))
        assert _status(url, {"captions": _captions(f), "reference_frames":
                             [base64.b64encode(png).decode()]}) == 400
    assert _status(url, {"captions": _captions(f)}, path="/other") == 404
    with urllib.request.urlopen(url + "/healthz", timeout=TIMEOUT) as r:
        assert json.loads(r.read())["status"] == "ok"


def test_concurrent_requests_batch(server):
    url, srv = server
    f = srv.ds_cfg.num_frames
    results = [None] * 3

    def call(i):
        results[i] = _post(url, {"captions": _captions(f, f"c{i}"),
                                 "seed": i})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert all(r is not None and len(r["frames"]) == f for r in results)
    assert {r["batch_size"] for r in results} <= {1, 2}


def test_backpressure_503():
    """A saturated queue refuses (the handler's 503) instead of queueing
    without bound."""
    args = pserve.parse_args(["--max-batch", "1", "--max-queue", "1"] + CPU)
    srv = pserve.StoryServer(args.eval, args.max_batch, args.max_wait_ms,
                             max_queue=args.max_queue)
    # the dispatch thread is not started: submissions pile up
    inputs = srv.story_inputs(_captions(srv.ds_cfg.num_frames), [], "")
    assert srv.submit(inputs, 0) is not None  # fills the queue
    assert srv.submit(inputs, 1) is None      # saturated -> 503


def test_precompile_returns_without_serving(capsys):
    box = []
    pserve.serve(pserve.parse_args(["--precompile"] + CPU), httpd_box=box)
    assert box == []  # never bound a port
    out = capsys.readouterr().out
    assert "warmup" in out and "precompile done" in out


def _requests(srv, seeds, negative=""):
    f = srv.ds_cfg.num_frames
    return [pserve._Request(srv.story_inputs(_captions(f, f"s{s}"), [],
                                             negative), s) for s in seeds]


def test_batched_request_equals_its_lone_run(idle_server):
    srv = idle_server
    alone = srv._run(_requests(srv, [7]))
    batch = _requests(srv, [8, 7, 9])
    together = srv._run(batch)
    assert together.shape[0] == 3 and batch[1].batch_size == 3
    torch.testing.assert_close(together[1], alone[0], atol=1e-5, rtol=0)
    assert not torch.allclose(together[0], together[1])
    np.testing.assert_array_equal(
        batch[1].frames,
        (together[1] * 255).round().clamp(0, 255).to(torch.uint8).numpy())


def test_mixed_negative_prompts_run_uncached(idle_server, monkeypatch):
    srv = idle_server
    alone = [srv._run(_requests(srv, [s], neg))[0]
             for s, neg in ((3, "blurry"), (4, "dark"))]
    calls = []
    real = srv.pipeline.generate
    monkeypatch.setattr(srv.pipeline, "generate", lambda inputs, cache, **kw:
                        calls.append(cache) or real(inputs, cache, **kw))
    mixed = srv._run(_requests(srv, [3], "blurry")
                     + _requests(srv, [4], "dark"))
    assert calls == [None]
    for got, want in zip(mixed, alone):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_cond_cache_lru_keeps_eight_prompts(idle_server):
    srv = idle_server
    srv._cond_caches.clear()
    rows = {}
    for i in range(10):
        rows[i] = srv.story_inputs(
            _captions(srv.ds_cfg.num_frames), [], f"neg {i}"
        ).tokens_s1_u[0, 0]
        srv._cond_cache(rows[i])
        if i == 7:
            srv._cond_cache(rows[0])  # a hit keeps prompt 0 warm
    assert len(srv._cond_caches) == pserve.COND_CACHES == 8
    kept = set(srv._cond_caches)
    key = {i: r.numpy().tobytes() for i, r in rows.items()}
    assert key[0] in kept and key[9] in kept
    assert key[1] not in kept and key[2] not in kept


def test_a_stopped_server_is_freed_without_the_collector():
    """Nothing holds a served StoryServer in a reference cycle: once the
    HTTP server has stopped and its threads have ended, dropping the last
    reference frees the server and its pipeline with the garbage
    collector off (a per-server handler class closing over it kept a
    full-width pipeline's weights on the card until a collection)."""
    args = pserve.parse_args(["--port", "0"] + CPU)
    ready = threading.Event()
    box = []
    t = threading.Thread(target=pserve.serve, args=(args,),
                         kwargs=dict(ready_event=ready, httpd_box=box),
                         daemon=True)
    gc.disable()
    try:
        t.start()
        assert ready.wait(timeout=TIMEOUT), "server failed to start"
        httpd, story = box.pop()
        url = f"http://127.0.0.1:{httpd.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
            assert json.loads(r.read())["status"] == "ok"
        freed = weakref.ref(story.pipeline)
        httpd.shutdown()
        t.join(timeout=TIMEOUT)
        del httpd, story
        deadline = time.monotonic() + TIMEOUT
        while freed() is not None and time.monotonic() < deadline:
            time.sleep(0.05)  # the dispatch and handler threads ending
        assert freed() is None
    finally:
        gc.enable()


def test_default_device_is_cuda_without_fallback():
    args = pserve.parse_args(["--synthetic"])
    assert args.eval.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pserve.StoryServer(args.eval, args.max_batch, args.max_wait_ms)
