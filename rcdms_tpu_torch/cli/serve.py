"""Story-generation HTTP server — the counterpart of `rcdms_tpu/cli/serve.py`:
a persistent process holding the two-stage pipeline warm, with dynamic
request batching.

    python -m rcdms_tpu_torch.cli.serve --port 8500 \
        --sd-pretrained ... --prior-pretrained ... --vision-pretrained ... \
        [--max-batch 4] [--max-wait-ms 50]

HTTP handling is threaded (`ThreadingHTTPServer`); every model call runs
on one dispatch thread, which takes requests off a bounded queue, stacks
those that arrive within --max-wait-ms (up to --max-batch) into one
`generate` call, and answers each. Handler threads decode and encode PNGs
and build inputs on the CPU; they never touch the device.

API (the JAX server's):
  GET  /healthz   -> {"status": "ok", "num_frames": f, "image_size": px,
                      "compiled": [batch sizes run so far], "served": N,
                      "pending": N, "avg_latency_s": s}
  POST /generate  -> body {"captions": [str x f],
                           "reference_frames": [base64 image, ...],  # 0..f
                           "negative_prompt": str, "seed": int}
                  -> {"frames": [base64 PNG x f], "latency_s": float,
                      "batch_size": int}
Errors: 400 for a malformed request (wrong caption count, a seed outside
[0, 2**64), a reference frame that `sample/eval.py::decode_png` does not
read or of more than `MAX_REFERENCE_PIXELS` pixels: it reads every PNG
without Pillow, and other formats, as the JAX server does, through Pillow
where it is installed),
404 for another path, 503 when more than --max-queue requests are pending
(retry with backoff), 500 when generation fails.

Batching keeps each request's result its own: every request draws its
noise from its own `torch.Generator` seeded with its `seed`
(`StoryNoise.draw`), and a batch stacks those draws (`StoryNoise.cat`), so
a request's frames do not depend on its batch companions beyond the
rounding of a larger batch. (The JAX server folds all seeds of a batch
into one key.) Under `--quantize int8` they do: the activations' int8
scale is one per tensor, over the whole batch, as in the JAX package, so
a companion with larger activations coarsens a request's quantization.
The story-independent conditioning (`CondCache`) is kept per negative
prompt in an LRU of `COND_CACHES` entries; a batch that mixes negative
prompts runs uncached.

`--precompile` builds the kernels and runs the batch-1 warmup, prints
their seconds and returns without binding a port (the port has no compile
cache to fill). Every model flag is the evaluate CLI's (`--synthetic`,
`--dtype`, `--quantize int8`, `--encoder-propagation`, ...); `--device`
defaults to cuda and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import base64
import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from rcdms_tpu_torch.cli import common
from rcdms_tpu_torch.cli.evaluate import build_pipeline
from rcdms_tpu_torch.cli.evaluate import parse_args as eval_parse_args
from rcdms_tpu_torch.sample.eval import decode_png, encode_png
from rcdms_tpu_torch.sample.pipeline import StoryInputs, StoryNoise

COND_CACHES = 8  # negative prompts whose CondCache stays warm
# the most pixels a reference frame may have: 8x the side of the dataset's
# 512-pixel frames, so a request that declares a huge image in a small body
# is refused before the decoder allocates for it
MAX_REFERENCE_PIXELS = 4096 * 4096


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-wait-ms", type=float, default=50.0,
                   help="how long to hold a request open for batch fill")
    p.add_argument("--max-queue", type=int, default=64,
                   help="pending-request cap; beyond it /generate "
                        "returns 503 (backpressure) instead of growing "
                        "latency unboundedly")
    p.add_argument("--precompile", action="store_true",
                   help="build the kernels and run the batch-1 warmup, "
                        "print their seconds, then exit WITHOUT serving")
    args, rest = p.parse_known_args(argv)
    args.eval = eval_parse_args(rest)
    if args.eval.shard_story:
        p.error("--shard-story splits a story over the ranks of a process "
                "group; the server is one process (evaluate and generate "
                "take the flag)")
    return args


def _png_b64(frame_u8: np.ndarray) -> str:
    return base64.b64encode(encode_png(frame_u8)).decode("ascii")


def _decode_b64_image(data: str) -> np.ndarray:
    return decode_png(base64.b64decode(data, validate=True),
                      max_pixels=MAX_REFERENCE_PIXELS)


class _Request:
    __slots__ = ("inputs", "seed", "done", "frames", "error", "batch_size",
                 "t0")

    def __init__(self, inputs: StoryInputs, seed: int):
        self.inputs = inputs  # batch-1 StoryInputs on the CPU
        self.seed = seed
        self.done = threading.Event()
        self.frames = None    # uint8 (f, H, W, 3) once done
        self.error = None
        self.batch_size = 0
        self.t0 = time.monotonic()


class StoryServer:
    """Owns the pipeline, the request queue and the one dispatch thread
    that batches and runs requests."""

    def __init__(self, ev_args, max_batch: int, max_wait_ms: float,
                 max_queue: int = 64):
        self.pipeline, self.dataset, self.ds_cfg = build_pipeline(ev_args)
        self.device = self.pipeline.device
        self.max_batch = max(1, max_batch)
        self.max_wait_s = max_wait_ms / 1e3
        self._cond_caches: "collections.OrderedDict" = \
            collections.OrderedDict()
        self.compiled_batches = set()
        self.queue: "queue.Queue[_Request]" = queue.Queue(
            maxsize=max(1, max_queue))
        self.served = 0
        self.total_latency_s = 0.0
        self._stop = threading.Event()
        self.worker = threading.Thread(target=self._loop, daemon=True)

    def story_inputs(self, captions, references, negative_prompt: str
                     ) -> StoryInputs:
        """A request's batch-1 inputs, built on the CPU."""
        return common.build_story_inputs(captions, references,
                                         negative_prompt, self.dataset,
                                         self.ds_cfg, "cpu")

    def warmup(self):
        """One batch-1 request before taking traffic."""
        inputs = self.story_inputs(["warmup"] * self.ds_cfg.num_frames, [],
                                   "")
        self._generate([_Request(inputs, 0)])

    def start(self):
        self.worker.start()

    def stop(self):
        self._stop.set()

    def submit(self, inputs: StoryInputs, seed: int):
        """Enqueue, or return None when the server is saturated
        (backpressure -> 503)."""
        req = _Request(inputs, seed)
        try:
            self.queue.put_nowait(req)
        except queue.Full:
            return None
        return req

    def _take_batch(self):
        try:
            first = self.queue.get(timeout=0.2)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._take_batch()
            if not batch:
                continue
            try:
                self._run(batch)
            except Exception as e:  # surface to every waiter
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
                    r.done.set()

    def _cond_cache(self, row: torch.Tensor):
        """The CondCache of one uncond token row, from the LRU."""
        key = row.numpy().tobytes()
        if key in self._cond_caches:
            self._cond_caches.move_to_end(key)
        else:
            self._cond_caches[key] = common.cond_cache_from_row(
                self.pipeline, self.ds_cfg, row, row)
            if len(self._cond_caches) > COND_CACHES:
                self._cond_caches.popitem(last=False)
        return self._cond_caches[key]

    def _generate(self, batch) -> torch.Tensor:
        """One `generate` call over the batch's requests, each with its own
        generator; returns the (b, f, H, W, 3) fp32 frames on the CPU."""
        with torch.no_grad():
            stacked = StoryInputs(*(torch.cat(parts) for parts in
                                    zip(*(r.inputs for r in batch))))
            rows = stacked.tokens_s1_u.reshape(-1,
                                               stacked.tokens_s1_u.shape[-1])
            cache = (self._cond_cache(rows[0]) if (rows == rows[0]).all()
                     else None)
            noise = StoryNoise.cat(
                StoryNoise.draw(self.pipeline, 1, torch.Generator(
                    self.device).manual_seed(r.seed), self.ds_cfg.image_size)
                for r in batch)
            inputs = StoryInputs(*(t.to(self.device) for t in stacked))
            frames, _ = self.pipeline.generate(inputs, cache, noise=noise)
            self.compiled_batches.add(len(batch))
            return frames.float().cpu()

    def _run(self, batch) -> torch.Tensor:
        """Generate a batch, answer each request, and return the fp32
        frames (b, f, H, W, 3)."""
        frames = self._generate(batch)
        u8 = (frames * 255.0).round().clamp(0, 255).to(torch.uint8).numpy()
        # stats change only here, on the dispatch thread
        for i, r in enumerate(batch):
            r.frames = u8[i]
            r.batch_size = len(batch)
            self.total_latency_s += time.monotonic() - r.t0
            r.done.set()
        self.served += len(batch)
        return frames


class Handler(BaseHTTPRequestHandler):
    """The HTTP routes; the `StoryServer` is the HTTP server's `story`.
    A module-level class: one made per server, closing over it, would sit
    in a reference cycle (a class refers to itself) and hold the
    pipeline until the garbage collector ran."""

    def log_message(self, *a):  # quiet
        pass

    def _reply(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        server = self.server.story
        if self.path != "/healthz":
            return self._reply(404, {"error": "not found"})
        self._reply(200, {
            "status": "ok",
            "num_frames": server.ds_cfg.num_frames,
            "image_size": server.ds_cfg.image_size,
            "compiled": sorted(server.compiled_batches),
            "served": server.served,
            "pending": server.queue.qsize(),
            "avg_latency_s": round(
                server.total_latency_s / max(1, server.served), 4),
        })

    def do_POST(self):
        server = self.server.story
        if self.path != "/generate":
            return self._reply(404, {"error": "not found"})
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            refs = [_decode_b64_image(d)
                    for d in body.get("reference_frames", [])]
            inputs = server.story_inputs(
                body["captions"], refs, body.get("negative_prompt", ""))
            seed = int(body.get("seed", 0))
            if not 0 <= seed < 2 ** 64:  # a generator's seed range
                raise ValueError(f"seed {seed} is not in [0, 2**64)")
        except (KeyError, ValueError, TypeError, AttributeError) as e:
            # ValueError covers bad base64 (binascii.Error) and images
            # the PNG decoder refuses
            return self._reply(400, {"error": str(e)})
        t0 = time.monotonic()
        req = server.submit(inputs, seed)
        if req is None:
            return self._reply(503, {"error": "server saturated; "
                                     "retry later"})
        req.done.wait()
        if req.error is not None:
            return self._reply(500, {"error": req.error})
        latency = time.monotonic() - t0
        self._reply(200, {
            "frames": [_png_b64(f) for f in req.frames],
            "latency_s": round(latency, 4),
            "batch_size": req.batch_size,
        })


def serve(args, *, ready_event=None, httpd_box=None):
    server = StoryServer(args.eval, args.max_batch, args.max_wait_ms,
                         args.max_queue)
    build_s = 0.0
    if server.device.type == "cuda":
        from rcdms_tpu_torch.ops import _build

        t0 = time.monotonic()
        _build.library()
        build_s = time.monotonic() - t0
    t0 = time.monotonic()
    server.warmup()
    print(f"kernels built in {build_s:.1f} s ({server.device}); batch-1 "
          f"warmup in {time.monotonic() - t0:.1f} s", flush=True)
    if getattr(args, "precompile", False):
        print("precompile done", flush=True)
        return
    server.start()
    httpd = ThreadingHTTPServer((args.host, args.port), Handler)
    httpd.story = server
    if httpd_box is not None:
        httpd_box.append((httpd, server))
    print(f"serving on http://{args.host}:{httpd.server_address[1]}",
          flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        httpd.serve_forever()
    finally:
        server.stop()
        httpd.server_close()


def main(argv=None):
    serve(parse_args(argv))


if __name__ == "__main__":
    main()
