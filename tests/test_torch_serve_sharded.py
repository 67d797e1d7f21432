"""`rcdms_tpu_torch.cli.serve --shard-story` on the CPU: one story server
over the gloo ranks of a process group (`torch.multiprocessing`, spawned,
one torch thread each), rank 0 behind a real HTTP server on port 0 and
this process its client.

One pool of processes runs the module's jobs, each process its jobs in
turn (`JOBS`):

* "w4" (cfg 2 x space 2) and "w2" (cfg 2), each a group joined through a
  `FileStore` and served through `serve`: two requests at once (a batch
  of 2; the first with seed 2**64 - 1) and one with a reference frame and
  another negative prompt. "w2" goes on: a batch that mixes negative
  prompts, held on rank 0 while two more requests fill the queue, a
  third gets 503 and a malformed one 400, then the two queued ones as a
  batch under a new negative prompt, which evicts the LRU's oldest entry
  (`COND_CACHES` is `LRU` in the pool). SIGINT to rank 0 stops the
  server. Then every rank runs the batches of the first three requests
  again through the sharded `StoryPipeline.generate`, on the same ranks
  with the same inputs and noise. "w2" is the last job of its processes,
  so their exit codes are the stop's;
* "precompile": `main` with `--precompile` on 2 ranks joined from
  torchrun's variables;
* "raise" and "noise": `main` on 2 ranks with a fault planted on rank 1
  after the warmup (its `generate` raises; its noise differs from rank
  0's), the last job of their processes.

The cases: without torchrun `--shard-story` serves exactly as without the
flag; at worlds 2 and 4 the served frames equal the sharded `generate`
on the same ranks bit for bit, their PNGs are those frames, and they lie
within `tests/test_torch_sharded_inference.py`'s TOL (atol 5e-5, rtol
1e-5) of one process; seed 2**64 - 1 reaches every rank whole; every
rank's LRU keys and count of `generate` calls are rank 0's; every rank
sees each of rank 0's batches, idle heartbeats (`HEARTBEAT_S` is
HEARTBEAT_S in the pool) and its stop; the 400 and the 503 reach no
follower; a stop ends every rank with rc 0; a fault on
rank 1 gets 500 from rank 0 and ends every rank non-zero within TIMEOUT;
`--precompile` exits 0 on 2 ranks and binds no port; `/healthz` has the
JAX server's keys and the port's counters.
"""

import ast
import base64
import collections
import json
import os
import re
import signal
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from rcdms_tpu_torch.cli import common
from rcdms_tpu_torch.cli import serve as pserve
from rcdms_tpu_torch.sample.eval import decode_png, encode_png
from rcdms_tpu_torch.sample.pipeline import StoryInputs, StoryNoise
from rcdms_tpu_torch.train import distributed
from tests.test_torch_configs import REPO, one_torch_thread  # noqa: F401
from tests.test_torch_sharded_inference import TOL

TIMEOUT = 120  # seconds: every urlopen, wait and join
CPU = ["--synthetic", "--device", "cpu", "--num-inference-steps", "2"]
SERVE = ["--port", "0", "--max-batch", "2", "--max-wait-ms", "300",
         "--max-queue", "2"] + CPU
BIG_SEED = 2 ** 64 - 1
HOLD_SEED = 4  # rank 0 holds the batch of this seed until released
LRU = 2  # COND_CACHES in the pool: the "w2" run evicts
HEARTBEAT_S = 0.2  # HEARTBEAT_S in the pool: an idle leader's messages
SERVED = {"w4": 4, "w2": 2}
FAULTS = ("raise", "noise")
# the jobs of each pool process, in turn; its rank in a job is its index
# less the job's first process (FIRST)
JOBS = {0: ("w4", "noise"), 1: ("w4", "noise"), 2: ("w4", "raise"),
        3: ("w4", "raise"), 4: ("precompile", "w2"), 5: ("precompile", "w2")}
FIRST = {"w4": 0, "noise": 0, "raise": 2, "precompile": 4, "w2": 4}
# the JAX server's /healthz keys, read from its source
with open(os.path.join(REPO, "rcdms_tpu", "cli", "serve.py")) as _fh:
    HEALTHZ_KEYS = next(
        sorted(k.value for k in node.args[1].keys)
        for node in ast.walk(ast.parse(_fh.read()))
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "")
        == "_reply" and isinstance(node.args[1], ast.Dict)
        and any(getattr(k, "value", "") == "status"
                for k in node.args[1].keys))
# the counters the port's /healthz adds to the JAX server's keys
PORT_HEALTHZ_KEYS = ["avg_queue_wait_s", "batches_by_size", "cond_cache",
                     "max_queue_wait_s"]
GENERATE_KEYS = ["batch_size", "frames", "latency_s"]


def _captions(tag: str) -> list:
    return [f"{tag} {i}" for i in range(5)]


def _reference_png() -> str:
    px = np.random.default_rng(0).integers(0, 255, (64, 64, 3),
                                           dtype=np.uint8)
    return base64.b64encode(encode_png(px)).decode()


# the requests of a served run: name -> (seed, negative prompt, reference?)
REQUESTS = {"r1": (BIG_SEED, "", False), "r2": (2, "", False),
            "r3": (3, "blurry", True), "r4": (HOLD_SEED, "dark", False),
            "r5": (5, "", False), "r6": (6, "dark", False),
            "r7": (7, "dark", False)}


def _body(name: str) -> dict:
    seed, negative, ref = REQUESTS[name]
    body = {"captions": _captions(name), "seed": seed,
            "negative_prompt": negative}
    if ref:
        body["reference_frames"] = [_reference_png()]
    return body


# ---- the pool ----------------------------------------------------------------

_calls = []  # this process's `_generate` calls in its running job
_told = collections.Counter()  # the kinds of rank 0's messages it saw


def _instrument(root: str) -> None:
    """Records every `_generate` call (its requests' inputs and seeds, the
    frames) and every message's kind; a leader holds the batch of
    HOLD_SEED until released."""
    real_generate = pserve.StoryServer._generate
    real_run = pserve.StoryServer._run
    real_tell = pserve.StoryServer._tell

    def tell(self, message=None):
        message = real_tell(self, message)
        _told[message[0]] += 1
        return message

    def generate(self, batch):
        frames = real_generate(self, batch)
        _calls.append(dict(seeds=[r.seed for r in batch],
                           inputs=[r.inputs for r in batch], frames=frames))
        return frames

    def run(self, batch):
        if HOLD_SEED in [r.seed for r in batch]:
            open(os.path.join(root, "held"), "w").close()
            _wait_for(os.path.join(root, "release"))
        return real_run(self, batch)

    pserve.StoryServer._generate = generate
    pserve.StoryServer._run = run
    pserve.StoryServer._tell = tell
    pserve.COND_CACHES = LRU
    pserve.HEARTBEAT_S = HEARTBEAT_S


def _wait_for(path: str) -> None:
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.02)


def _again(srv, call) -> torch.Tensor:
    """A served batch through the sharded `generate` on the same ranks,
    with the same inputs and noise."""
    stacked = StoryInputs(*(torch.cat(parts)
                            for parts in zip(*call["inputs"])))
    rows = stacked.tokens_s1_u.reshape(-1, stacked.tokens_s1_u.shape[-1])
    cache = (common.cond_cache_from_row(srv.pipeline, srv.ds_cfg, rows[0],
                                        rows[0])
             if (rows == rows[0]).all() else None)
    noise = StoryNoise.cat(StoryNoise.draw(
        srv.pipeline, 1, torch.Generator().manual_seed(s),
        srv.ds_cfg.image_size) for s in call["seeds"])
    with torch.no_grad():
        return srv.pipeline.generate(stacked, cache, noise=noise)[0].float()


def _serve_job(tag: str, rank: int, root: str) -> None:
    world = SERVED[tag]
    distributed.maybe_initialize(
        "cpu", init_method=f"file://{os.path.join(root, f'store_{tag}')}",
        world_size=world, rank=rank)
    try:
        _calls.clear()
        _told.clear()
        ready, box = threading.Event(), []

        def report():
            if ready.wait(TIMEOUT):
                port = box[0][0].server_address[1]
                with open(os.path.join(root, f"{tag}.port.tmp"), "w") as fh:
                    fh.write(str(port))
                os.replace(os.path.join(root, f"{tag}.port.tmp"),
                           os.path.join(root, f"{tag}.port"))

        if rank == 0:
            threading.Thread(target=report, daemon=True).start()
        args = pserve.parse_args(SERVE + ["--shard-story"])
        srv = pserve.serve(args, ready_event=ready, httpd_box=box)
        out = dict(rc=0, world=srv.world, rank=srv.rank,
                   mesh=tuple(srv.pipeline.mesh[:3]),
                   calls=[dict(c) for c in _calls], told=dict(_told),
                   lru=list(srv._cond_caches))
        out["again"] = [_again(srv, c) for c in _calls[1:3]]
        torch.save(out, os.path.join(root, f"{tag}_r{rank}.pt"))
    finally:
        distributed.shutdown()


def _torchrun_env(rank: int, port: int) -> dict:
    return dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))


class _NoBind:
    binds = 0

    def __init__(self, *a, **kw):
        _NoBind.binds += 1
        raise AssertionError("bound a port")


def _precompile(rank: int, port: int, root: str) -> None:
    """`main --precompile` on 2 ranks: its rc, its output and the ports it
    tried to bind."""
    os.environ.update(_torchrun_env(rank, port))
    real = pserve.ThreadingHTTPServer, pserve._JoiningHTTPServer
    pserve.ThreadingHTTPServer = pserve._JoiningHTTPServer = _NoBind
    log = os.path.join(root, f"precompile_r{rank}.log")
    stdout = sys.stdout
    try:
        with open(log, "w", buffering=1) as sys.stdout:
            try:
                pserve.main(SERVE + ["--shard-story", "--precompile"])
                rc = 0
            except Exception as e:  # noqa: BLE001 - the rc is the check
                print(f"{type(e).__name__}: {e}")
                rc = 1
    finally:
        sys.stdout = stdout
        pserve.ThreadingHTTPServer, pserve._JoiningHTTPServer = real
        for k in _torchrun_env(rank, port):
            os.environ.pop(k)
    with open(log) as fh:
        text = fh.read()
    with open(os.path.join(root, f"precompile_r{rank}.json"), "w") as fh:
        json.dump(dict(rc=rc, binds=_NoBind.binds, out=text,
                       active=distributed.active()), fh)


def _plant(fault: str) -> None:
    """On rank 1, after the warmup: `generate` raises, or every draw is
    off rank 0's."""
    from rcdms_tpu_torch.sample.pipeline import StoryPipeline

    if fault == "raise":
        real = StoryPipeline.generate
        calls = []

        def generate(self, *a, **kw):
            calls.append(1)
            if len(calls) > 1:
                raise RuntimeError("a fault planted on rank 1")
            return real(self, *a, **kw)

        StoryPipeline.generate = generate
    else:
        real = StoryNoise.draw.__func__
        draws = []

        def draw(cls, *a, **kw):
            noise = real(cls, *a, **kw)
            draws.append(1)
            if len(draws) > 1:
                noise = noise._replace(prior_init=noise.prior_init + 1e-3)
            return noise

        StoryNoise.draw = classmethod(draw)


def _faulted(fault: str, rank: int, port: int, root: str) -> None:
    """`main` on 2 ranks with `fault` planted on rank 1; whatever it
    raises ends the process."""
    os.environ.update(_torchrun_env(rank, port))
    if rank == 1:
        _plant(fault)
    sys.stdout = open(os.path.join(root, f"{fault}_r{rank}.log"), "w",
                      buffering=1)
    pserve.main(SERVE + ["--shard-story"])


def _pool_main(index: int, root: str, ports: dict) -> None:
    torch.set_num_threads(1)
    _instrument(root)
    for job in JOBS[index]:
        rank = index - FIRST[job]
        if job in SERVED:
            _serve_job(job, rank, root)
        elif job == "precompile":
            _precompile(rank, ports[job], root)
        else:
            _faulted(job, rank, ports[job], root)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- the client ----------------------------------------------------------------

def _post(url: str, body: dict) -> tuple:
    """(status, reply) of a POST /generate."""
    req = urllib.request.Request(url + "/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _health(url: str) -> dict:
    with urllib.request.urlopen(url + "/healthz", timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _posting(url: str, names, replies: dict) -> list:
    """Threads that POST each named request, started in order."""
    threads = []
    for name in names:
        t = threading.Thread(target=lambda n=name: replies.__setitem__(
            n, _post(url, _body(n))))
        t.start()
        threads.append(t)
    return threads


def _until(check, what: str) -> None:
    deadline = time.monotonic() + TIMEOUT
    while not check():
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(0.02)


def _drive(root: str, tag: str, leader) -> dict:
    """The client's side of a served run: every reply and status, then
    SIGINT to the leader."""
    _wait_for(os.path.join(root, f"{tag}.port"))
    with open(os.path.join(root, f"{tag}.port")) as fh:
        url = f"http://127.0.0.1:{fh.read()}"
    replies = {}
    for t in _posting(url, ["r1", "r2"], replies):
        t.join(TIMEOUT)
    replies["r3"] = _post(url, _body("r3"))
    if tag == "w2":
        held = _posting(url, ["r4", "r5"], replies)
        _wait_for(os.path.join(root, "held"))
        for n, name in enumerate(("r6", "r7"), start=1):
            held += _posting(url, [name], replies)
            _until(lambda n=n: _health(url)["pending"] == n,
                   f"{name} queued")
        replies["refused"] = _post(url, _body("r1"))
        replies["malformed"] = _post(url, {"captions": ["one"]})
        replies["pending"] = _health(url)["pending"]
        open(os.path.join(root, "release"), "w").close()
        for t in held:
            t.join(TIMEOUT)
    replies["healthz"] = _health(url)
    os.kill(leader.pid, signal.SIGINT)
    return replies


def _fault_port(root: str, fault: str) -> str:
    log = os.path.join(root, f"{fault}_r0.log")
    found = []

    def serving():
        if os.path.exists(log):
            with open(log) as fh:
                found[:] = re.findall(r"serving on (http://\S+)", fh.read())
        return bool(found)

    _until(serving, f"{fault}: rank 0 serving")
    return found[0]


class Pool:
    """The pool's processes, started at once, and this process's client,
    which drives them on a thread of its own; `done` waits for both."""

    def __init__(self, root):
        self.root = str(root)
        ports = {job: _free_port() for job in ("precompile",) + FAULTS}
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_pool_main,
                                  args=(i, self.root, ports))
                      for i in range(len(JOBS))]
        for p in self.procs:
            p.start()
        self.client, self.ranks, self.exit = {}, {}, {}
        self._error = []
        self._thread = threading.Thread(target=self._drive, daemon=True)
        self._thread.start()

    def _drive(self):
        try:
            for tag in SERVED:
                self.client[tag] = _drive(self.root, tag,
                                          self.procs[FIRST[tag]])
            for fault in FAULTS:
                url = _fault_port(self.root, fault)
                self.client[fault] = _post(url, _body("r2"))
                t0 = time.monotonic()
                procs = [self.procs[FIRST[fault] + r] for r in range(2)]
                for p in procs:
                    p.join(TIMEOUT)
                self.exit[fault] = dict(codes=[p.exitcode for p in procs],
                                        seconds=time.monotonic() - t0)
            for p in self.procs:
                p.join(TIMEOUT)
            self.exit["pool"] = [p.exitcode for p in self.procs]
            for tag, world in SERVED.items():
                self.ranks[tag] = [torch.load(
                    os.path.join(self.root, f"{tag}_r{r}.pt"),
                    weights_only=False) for r in range(world)]
            self.ranks["precompile"] = []
            for r in range(2):
                with open(os.path.join(self.root,
                                       f"precompile_r{r}.json")) as fh:
                    self.ranks["precompile"].append(json.load(fh))
        except BaseException as e:  # noqa: BLE001 - raised by `done`
            self._error.append(e)
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()

    def done(self) -> "Pool":
        self._thread.join(4 * TIMEOUT)
        assert not self._thread.is_alive(), "the pool's client hangs"
        if self._error:
            raise self._error[0]
        return self


@pytest.fixture(scope="module")
def pool_started(tmp_path_factory):
    return Pool(tmp_path_factory.mktemp("serve_pool"))


@pytest.fixture
def pool(pool_started):
    return pool_started.done()


@pytest.fixture(scope="module")
def one_process():
    """The one-process server (no flag), its dispatch thread not started:
    `_generate` is driven directly."""
    args = pserve.parse_args(["--max-batch", "2"] + CPU)
    return pserve.StoryServer(args.eval, args.max_batch, args.max_wait_ms)


_one_frames = {}


def _one(server, names) -> torch.Tensor:
    """The one-process server's frames of the named requests as a batch,
    in order (kept: the cases share them)."""
    key = tuple(names)
    if key not in _one_frames:
        _one_frames[key] = server._generate(_requests(server, names))
    return _one_frames[key]


def _requests(server, names) -> list:
    return [pserve._Request(server.story_inputs(
        _captions(n), [decode_png(base64.b64decode(_reference_png()))]
        if REQUESTS[n][2] else [], REQUESTS[n][1]), REQUESTS[n][0])
        for n in names]


def _names(call) -> list:
    by_seed = {seed: n for n, (seed, _, _) in REQUESTS.items()}
    return [by_seed[s] for s in call["seeds"]]


def _u8(frames: torch.Tensor) -> np.ndarray:
    return (frames * 255.0).round().clamp(0, 255).to(torch.uint8).numpy()


def _served(call, name: str) -> torch.Tensor:
    return call["frames"][call["seeds"].index(REQUESTS[name][0])]


# ---- the cases -------------------------------------------------------------------

def test_without_torchrun_shard_story_serves_as_without_it(pool_started,
                                                          one_process):
    assert not distributed.active()
    args = pserve.parse_args(["--max-batch", "2"] + CPU + ["--shard-story"])
    assert args.eval.shard_story
    flagged = pserve.StoryServer(args.eval, args.max_batch,
                                 args.max_wait_ms)
    assert (flagged.rank, flagged.world) == (0, 1)
    assert tuple(flagged.pipeline.mesh[:3]) == (1, 1, 1)
    assert not distributed.active()
    for names in (["r1", "r2"], ["r3"]):
        got = flagged._run(_requests(flagged, names))
        assert torch.equal(got, _one(one_process, names)), names


@pytest.mark.parametrize("tag", SERVED)
def test_served_frames_equal_the_sharded_generate(pool, tag):
    ranks = pool.ranks[tag]
    assert [(x["rank"], x["world"]) for x in ranks] == [
        (r, SERVED[tag]) for r in range(SERVED[tag])]
    assert ranks[0]["mesh"] == ((2, 1, 1) if tag == "w2" else (2, 1, 2))
    for x in ranks:
        assert len(x["again"]) == 2
        for i, again in enumerate(x["again"], start=1):
            assert torch.equal(x["calls"][i]["frames"], again)
            assert torch.equal(again, ranks[0]["calls"][i]["frames"])
    client = pool.client[tag]
    for name in ("r1", "r2", "r3"):
        status, reply = client[name]
        assert status == 200 and sorted(reply) == GENERATE_KEYS, reply
        call = ranks[0]["calls"][1 if name != "r3" else 2]
        assert reply["batch_size"] == len(call["seeds"])
        want = _u8(_served(call, name))
        for png, frame in zip(reply["frames"], want):
            np.testing.assert_array_equal(decode_png(base64.b64decode(png)),
                                          frame)
    assert [len(c["seeds"]) for c in ranks[0]["calls"][1:3]] == [2, 1]


@pytest.mark.parametrize("tag", SERVED)
def test_served_frames_within_tol_of_one_process(pool, one_process, tag):
    for call in pool.ranks[tag][0]["calls"][1:3]:
        names = sorted(_names(call))  # the batch in the order (a) ran it
        want = _one(one_process, names)
        for name in names:
            torch.testing.assert_close(_served(call, name),
                                       want[names.index(name)], **TOL)


@pytest.mark.parametrize("tag", SERVED)
def test_the_largest_seed_reaches_every_rank_whole(pool, tag):
    for x in pool.ranks[tag]:
        assert sorted(x["calls"][1]["seeds"]) == [2, BIG_SEED]


def test_every_rank_keeps_rank_0s_lru_and_calls(pool, one_process):
    ranks = pool.ranks["w2"]
    lead = ranks[0]
    # warmup, r1 + r2, r3, r4 + r5 (mixed: uncached), r6 + r7
    assert [sorted(c["seeds"]) for c in lead["calls"]] == [
        [0], [2, BIG_SEED], [3], [HOLD_SEED, 5], [6, 7]]
    key = {neg: one_process.story_inputs(_captions("x"), [], neg)
           .tokens_s1_u[0, 0].numpy().tobytes()
           for neg in ("blurry", "dark")}
    assert lead["lru"] == [key["blurry"], key["dark"]]
    for x in ranks[1:]:
        assert x["lru"] == lead["lru"]
        assert [c["seeds"] for c in x["calls"]] == [
            c["seeds"] for c in lead["calls"]]
    assert pool.client["w2"]["r4"][1]["batch_size"] == 2
    assert pool.client["w2"]["r6"][1]["batch_size"] == 2


def test_refused_requests_never_reach_a_follower(pool):
    client = pool.client["w2"]
    assert client["refused"][0] == 503
    assert client["malformed"][0] == 400
    assert client["pending"] == 2
    served = [n for n in REQUESTS if client[n][0] == 200]
    assert served == list(REQUESTS)
    calls = [len(x["calls"]) for x in pool.ranks["w2"]]
    assert calls == [5, 5]  # the warmup and four batches on every rank


def test_a_stop_ends_every_rank_with_rc_0(pool):
    for tag in SERVED:
        assert [x["rc"] for x in pool.ranks[tag]] == [0] * SERVED[tag]
    assert pool.exit["pool"][4:] == [0, 0]  # w2's, its last job


@pytest.mark.parametrize("tag", SERVED)
def test_every_rank_sees_every_message_of_rank_0(pool, tag):
    """Every rank sees each batch, the idle leader's heartbeats and the
    stop, in the same numbers."""
    told = [x["told"] for x in pool.ranks[tag]]
    assert told[0]["batch"] == len(pool.ranks[tag][0]["calls"]) - 1
    assert told[0]["stop"] == 1 and told[0]["idle"] > 0
    assert all(t == told[0] for t in told[1:]), told


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_on_rank_1_ends_every_rank(pool, fault):
    status, reply = pool.client[fault]
    assert status == 500, reply
    assert "error" in reply
    codes = pool.exit[fault]["codes"]
    assert None not in codes and 0 not in codes, codes
    assert pool.exit[fault]["seconds"] < TIMEOUT


def test_precompile_on_two_ranks_binds_no_port(pool):
    for r, x in enumerate(pool.ranks["precompile"]):
        assert x["rc"] == 0, x["out"]
        assert x["binds"] == 0
        assert "precompile done" in x["out"]
        assert f"rank {r} of 2" in x["out"]
        assert not x["active"]  # main left the group it joined


@pytest.mark.parametrize("tag", SERVED)
def test_healthz_has_the_one_process_keys(pool, tag):
    health = pool.client[tag]["healthz"]
    assert sorted(health) == sorted(HEALTHZ_KEYS + PORT_HEALTHZ_KEYS)
    assert health["status"] == "ok" and health["num_frames"] == 5
    assert health["served"] == (7 if tag == "w2" else 3)
    assert sum(int(k) * n for k, n in health["batches_by_size"].items()) \
        == health["served"]
