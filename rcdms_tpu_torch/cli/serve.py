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

`--shard-story` splits every story over the ranks of the process group
that torchrun starts (NCCL on `cuda:LOCAL_RANK`, gloo with `--device
cpu`), on the ('cfg', 'frame', 'space') mesh of
`train/sharding.py::inference_mesh`, as `evaluate --shard-story` does:

    torchrun --nproc-per-node 4 -m rcdms_tpu_torch.cli.serve \
        --shard-story --dataset flintstones --dtype bfloat16 ...

Rank 0 alone binds the port and serves HTTP: its handlers, its queue and
its dispatch thread, which sends each batch (the stacked batch-1
`StoryInputs` its handlers built, and each request's seed) to every rank
over the gloo group of host-side messages (`distributed.host_group`) as
one object broadcast, then runs it. The other ranks follow (`follow`):
they run every batch rank 0 sends until its stop message, and never bind
a port. Every rank draws each request's noise from its own seeded
generator, and keeps the `CondCache` LRU for itself: the same inputs give
the same hits, misses and evictions on every rank, and every rank enters
the towers' split collectives together. After each batch the ranks
compare digests of their noise; a rank whose draw differs from rank 0's
fails the batch. 400, 404 and 503 are answered on rank 0 and never reach
the other ranks; frames become PNGs on rank 0 alone. An idle rank 0 sends
a heartbeat every `HEARTBEAT_S` seconds, so that no follower waits out
the groups' timeout. SIGINT to rank 0 (`kill -INT`) stops the server:
rank 0 sends the stop message and every rank leaves the group and exits
0. A batch that raises on any rank ends the server: rank 0 answers that
batch's requests, and every request still queued, with 500, and every
rank exits non-zero; nothing carries on over a broken group, and nothing
falls back to one process. Without torchrun's variables `--shard-story`
makes a one-rank mesh, which serves exactly as without the flag.
"""

from __future__ import annotations

import argparse
import base64
import collections
import hashlib
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch
import torch.distributed as dist

from rcdms_tpu_torch.cli import common
from rcdms_tpu_torch.cli.evaluate import build_pipeline
from rcdms_tpu_torch.cli.evaluate import parse_args as eval_parse_args
from rcdms_tpu_torch.sample.eval import decode_png, encode_png
from rcdms_tpu_torch.sample.pipeline import StoryInputs, StoryNoise
from rcdms_tpu_torch.train import distributed

COND_CACHES = 8  # negative prompts whose CondCache stays warm
# the most pixels a reference frame may have: 8x the side of the dataset's
# 512-pixel frames, so a request that declares a huge image in a small body
# is refused before the decoder allocates for it
MAX_REFERENCE_PIXELS = 4096 * 4096
# seconds an idle leader of a sharded server waits before it tells its
# followers it is alive: far inside the groups' timeout (30 minutes by
# default), which a follower waiting for its next batch would otherwise
# run out
HEARTBEAT_S = 60.0


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


def _digest(noise: StoryNoise) -> str:
    """A digest of every draw's bytes: equal on two ranks only if their
    draws are."""
    h = hashlib.sha256()
    for t in noise:
        if t is not None:
            h.update(t.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
    return h.hexdigest()


class StoryServer:
    """Owns the pipeline, the request queue and the one dispatch thread
    that batches and runs requests. Under `--shard-story` on more than one
    rank, rank 0's dispatch thread leads: it sends each batch to the other
    ranks, which `follow`."""

    def __init__(self, ev_args, max_batch: int, max_wait_ms: float,
                 max_queue: int = 64):
        self.pipeline, self.dataset, self.ds_cfg = build_pipeline(ev_args)
        self.device = self.pipeline.device
        # this process's place among the ranks that split every story
        everyone = self.pipeline._everyone()
        self.rank, self.world = everyone.index, everyone.size
        # a sharded leader's failure (what raised) and what it calls then
        # (the HTTP server's shutdown); once it has stopped or failed, the
        # error that answers every request
        self.failure = None
        self.on_failure = None
        self._refusal = None
        self._lock = threading.Lock()  # submissions against the drain
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
        (backpressure -> 503). A sharded server that has failed or stopped
        answers at once with its error."""
        req = _Request(inputs, seed)
        with self._lock:
            if self._refusal is not None:
                req.error = self._refusal
                req.done.set()
                return req
            try:
                self.queue.put_nowait(req)
            except queue.Full:
                return None
        return req

    def _close(self, error: str) -> None:
        """A sharded leader's last act: refuse new requests and answer
        every queued one with `error`, so that no handler waits on a
        dispatch thread that has ended."""
        with self._lock:
            self._refusal = error
            while True:
                try:
                    r = self.queue.get_nowait()
                except queue.Empty:
                    break
                r.error = error
                r.done.set()

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
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)  # each thread has its own
        beat = time.monotonic()
        try:
            while not self._stop.is_set():
                batch = self._take_batch()
                if not batch:
                    if self.world > 1 and \
                            time.monotonic() - beat > HEARTBEAT_S:
                        self._tell(("idle",))
                        beat = time.monotonic()
                    continue
                try:
                    self._run(batch)
                except Exception as e:  # surface to every waiter
                    for r in batch:
                        r.error = f"{type(e).__name__}: {e}"
                        r.done.set()
                    if self.world > 1:
                        raise
                beat = time.monotonic()
            if self.world > 1:
                self._close("the server stopped")
                self._tell(("stop",))
        except Exception as e:  # a sharded leader's: the group may be broken
            self.failure = e
            self._close(f"{type(e).__name__}: {e}")
            if self.on_failure is not None:
                self.on_failure()

    def _tell(self, message=None):
        """Rank 0's `message` on every rank (a follower passes None and
        gets it), broadcast over the gloo group of host-side messages."""
        box = [message]
        dist.broadcast_object_list(box, src=0,
                                   group=distributed.host_group())
        return box[0]

    def follow(self):
        """A follower's loop (a rank other than 0): every batch rank 0
        sends, run as rank 0 runs it, until its stop message. Whatever
        raises ends the loop, and the process."""
        while True:
            kind, *rest = self._tell()
            if kind == "stop":
                return
            if kind == "batch":
                self._generate([_Request(inputs, seed)
                                for inputs, seed in rest[0]])

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
            if self.world > 1:
                self._agree(_digest(noise))
            self.compiled_batches.add(len(batch))
            return frames.float().cpu()

    def _agree(self, digest: str) -> None:
        """Every rank's noise digest against rank 0's, after a batch: a
        rank that drew other noise, or that failed and left the group,
        fails the batch on every rank."""
        digests = [None] * self.world
        dist.all_gather_object(digests, digest,
                               group=distributed.host_group())
        off = [r for r, d in enumerate(digests) if d != digests[0]]
        if off:
            raise RuntimeError(f"--shard-story: ranks {off} drew other "
                               f"noise than rank 0")

    def _run(self, batch) -> torch.Tensor:
        """Generate a batch, answer each request, and return the fp32
        frames (b, f, H, W, 3). A sharded leader first sends the batch to
        its followers."""
        if self.world > 1:
            self._tell(("batch", [(r.inputs, r.seed) for r in batch]))
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


class _JoiningHTTPServer(ThreadingHTTPServer):
    """A sharded leader's HTTP server: `server_close` waits for its
    handler threads, so that every answer, the 500s of a failure too, is
    written before the process ends."""
    daemon_threads = False


def serve(args, *, ready_event=None, httpd_box=None):
    """Builds the server, warms it and serves until stopped; returns the
    `StoryServer`. Under `--shard-story` on more than one rank, rank 0
    serves HTTP and the others `follow`; a failed batch raises on rank 0
    once its requests are answered."""
    server = StoryServer(args.eval, args.max_batch, args.max_wait_ms,
                         args.max_queue)
    where = (f"rank {server.rank} of {server.world}, " if server.world > 1
             else "")
    build_s = 0.0
    if server.device.type == "cuda":
        from rcdms_tpu_torch.ops import _build

        t0 = time.monotonic()
        _build.library()
        build_s = time.monotonic() - t0
    t0 = time.monotonic()
    server.warmup()
    print(f"kernels built in {build_s:.1f} s ({where}{server.device}); "
          f"batch-1 warmup in {time.monotonic() - t0:.1f} s", flush=True)
    if getattr(args, "precompile", False):
        print("precompile done", flush=True)
        return server
    if server.rank != 0:
        server.follow()
        return server
    sharded = server.world > 1
    httpd = (_JoiningHTTPServer if sharded else ThreadingHTTPServer)(
        (args.host, args.port), Handler)
    httpd.story = server
    if sharded:
        server.on_failure = httpd.shutdown
    server.start()
    if httpd_box is not None:
        httpd_box.append((httpd, server))
    print(f"serving on http://{args.host}:{httpd.server_address[1]}"
          + (f" for {server.world} ranks" if sharded else ""), flush=True)
    if ready_event is not None:
        ready_event.set()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:  # a sharded server's stop
        if not sharded:
            raise
    finally:
        server.stop()
        if sharded:  # the stop message is sent before the group is left
            server.worker.join()
            server.on_failure = None
        httpd.server_close()
    if server.failure is not None:
        raise RuntimeError("--shard-story: a batch failed, and the server "
                           "stopped") from server.failure
    return server


def main(argv=None):
    args = parse_args(argv)
    joined = not distributed.active()
    serve(args)
    # a group this call joined (`--shard-story`) is left once every rank
    # has stopped; a failure leaves it as it is: the process ends, and a
    # broken group cannot be torn down in step
    if joined:
        distributed.shutdown()


if __name__ == "__main__":
    main()
