"""The benchmark of `rcdms_tpu_torch` on one H100: one cell, one run.

    python3 -m storybench.run --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

Loads the cell's configuration and traffic mix by name (`data.py`), makes
the weights and inputs from the seed on the card, builds the port's
pipeline (and server), warms up every shape the traffic uses, then
measures for `--seconds`: a closed loop of back-to-back `generate` calls
("closed" mixes), or an open loop of arrivals at a fixed rate into
`StoryServer.submit` ("open" mixes). After the window it frees the
program and checks sampled stories against the plain float32 reference
(`check.py`). The last line of standard output is the result: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics from a profiled part of the window),
`device`, `breakdown` (traced runs) and `checks`, each compared number
beside its limit. The same numbers end standard error.

It exits non-zero, with no result, without a CUDA card (or fewer than the
cell asks for), without the port's package beside it, or when a module of
JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "rcdms_tpu"}
TRACE_SECONDS = 10.0  # the profiled end of a traced run's window
DRAIN_S = 60.0  # how long past the close (or the profiler's stop) an
# answer may come


def forbidden_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, compared whole (`rcdms_tpu_torch` is not `rcdms_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Clock:
    """Device synchronisation and memory readings, or none on the CPU."""

    def __init__(self, torch, device):
        self.torch, self.cuda = torch, device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0


def build_program(torch, cfg: dict, seed: int, device, quantize=None):
    """The port's pipeline holding the seed's weights."""
    from storybench import port, traffic, weights
    from storybench.reference import model as ref_model

    with torch.device("meta"):
        params = weights.spec(ref_model.Story(cfg))
    made = weights.make(params, traffic.subseed(seed, "weights"), device,
                        dtype=port.DTYPES[cfg["dtype"]])
    pipe = port.build(cfg, made, device, quantize)
    del made
    return pipe


def _call(pipe, cache, cfg, mix, seed, indices, device):
    from storybench import port, traffic

    stories = [traffic.story(cfg, mix, seed, j, device) for j in indices]
    noises = [traffic.noise(cfg, s["noise_seed"], device) for s in stories]
    return pipe.generate(port.inputs(traffic.cat_inputs(stories), device),
                         cache,
                         noise=port.noise(traffic.cat_noise(noises)))


def closed_loop(pipe, cfg, mix, seed, seconds, clock, tracer, device):
    """Back-to-back `generate` calls of `batch` stories each, from the
    window's open until a call ends at or after its close. Keeps one call's
    outputs, drawn uniformly (reservoir), for the check: one story from
    each of the mix's `check` equal parts of that call's batch, so that a
    fault in any part of the batch shows."""
    from storybench import port

    b = mix["batch"]
    cache = port.cond_cache(pipe, cfg)
    _call(pipe, cache, cfg, mix, seed, [("warm", j) for j in range(b)],
          device)
    clock.sync()
    rng = random.Random(seed)
    calls, keep = [], None
    clock.reset_peak()
    t_open = time.monotonic()
    tracer.window(t_open, t_open + seconds)
    while True:
        first = len(calls) * b
        t0 = time.monotonic()
        frames, embeds = _call(pipe, cache, cfg, mix, seed,
                               range(first, first + b), device)
        clock.sync()
        t1 = time.monotonic()
        calls.append((t0, t1, b))
        if rng.random() < 1.0 / len(calls):
            keep = (first, frames, embeds)
        if t1 - t_open >= seconds and not tracer.pending():
            break
    first, frames, embeds = keep
    parts = mix["check"]
    picked = [rng.randrange(b * i // parts, b * (i + 1) // parts)
              for i in range(parts)]
    outputs = {first + i: (frames[i].cpu(), embeds[i].cpu()) for i in picked}
    window = [c for c in calls if c[0] - t_open < seconds]
    stories = len(window) * b
    return dict(t_open=t_open, t_close=window[-1][1], calls=calls,
                attempted=stories, failed=0, frames=stories * cfg[
                    "num_frames"], outputs=outputs)


def open_loop(pipe, cfg, mix, seed, seconds, clock, tracer, device):
    """Arrivals on the mix's schedule into `StoryServer.submit`, from a
    lead-in before the window to its close; every request due in the
    window is waited for (up to `DRAIN_S` past the close) and timed from
    its due time."""
    from storybench import port, traffic

    server = port.story_server(pipe, cfg, mix)
    server.start()
    try:
        return _serve(server, cfg, mix, seed, seconds, clock, tracer, device,
                      port, traffic)
    finally:
        server.stop()
        server.worker.join(timeout=DRAIN_S)


def _serve(server, cfg, mix, seed, seconds, clock, tracer, device, port,
           traffic, warm=True):
    # warm-in: every batch size the dispatcher can form
    for k in range(1, mix["max_batch"] + 1 if warm else 1):
        reqs = [server.submit(port.request_inputs(traffic.story(
            cfg, mix, seed, ("warm", k, j), device)["inputs"]), j)
            for j in range(k)]
        for r in reqs:
            r.done.wait()
            if r.error is not None:
                raise RuntimeError(f"warm-in request failed: {r.error}")
    dues, lead = traffic.arrivals(mix, mix["lead_s"], seconds)
    stories = [traffic.story(cfg, mix, seed, j, device)
               for j in range(len(dues))]
    work = [(port.request_inputs(s["inputs"]), s["noise_seed"])
            for s in stories]
    del stories
    clock.sync()
    slots = [None] * len(dues)
    sent = [threading.Event() for _ in dues]
    t_first = time.monotonic() + 0.05
    t_open, t_close = t_first + lead, t_first + lead + seconds
    tracer.window(t_open, t_close)

    def client():
        for j, due in enumerate(dues):
            delay = t_first + due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            slots[j] = (time.monotonic(), server.submit(*work[j]))
            sent[j].set()

    sender = threading.Thread(target=client, daemon=True)
    sender.start()
    done_at = [None] * len(dues)
    peak_reset = False
    for j in range(len(dues)):
        if not peak_reset and t_first + dues[j] >= t_open:
            clock.reset_peak()
            peak_reset = True
        sent[j].wait()
        r = slots[j][1]
        # a traced run's dispatch thread stops the profiler after the
        # close, which holds the queue: the wait runs from then
        while r is not None and not r.done.wait(timeout=1.0):
            if time.monotonic() > max(t_close, tracer.stopped_at or 0.0) \
                    + DRAIN_S:
                break
        if r is not None and r.done.is_set():
            done_at[j] = time.monotonic()
    sender.join()
    if tracer.pending() and tracer.prof is not None:
        server.stop()  # the dispatch thread started the profiler
        server.worker.join(timeout=DRAIN_S)
        tracer.finish()
    window = [j for j, d in enumerate(dues) if t_open <= t_first + d < t_close]
    lat, sizes, late, failed, errors = [], [], [], 0, 0
    for j in window:
        t_sent, r = slots[j]
        late.append(t_sent - (t_first + dues[j]))
        if r is None or r.error is not None or done_at[j] is None:
            failed += 1
            errors += r is not None
            continue
        lat.append(done_at[j] - (t_first + dues[j]))
        sizes.append(r.batch_size)
    answered = [j for j in window if slots[j][1] is not None
                and slots[j][1].error is None and done_at[j] is not None]
    rng = random.Random(seed)
    picked = rng.sample(answered, min(mix["check"], len(answered)))
    outputs = {j: (torch_from_u8(slots[j][1].frames), None) for j in picked}
    return dict(t_open=t_open, t_close=t_close, latencies=lat,
                batch_sizes=sizes, late_s=late, attempted=len(window),
                failed=failed, errors=errors, outputs=outputs,
                answered=len(answered), window=window,
                due_at=[t_first + d for d in dues], done_at=done_at)


def torch_from_u8(frames):
    import torch

    return torch.from_numpy(frames).float() / 255.0


def measure(cfg, mix, seed, seconds, trace, device):
    """Set-up, the window and the traced reading of one run; the program
    is freed before it returns. Returns the run's record."""
    import torch

    from storybench import port, trace as tr

    clock = Clock(torch, device)
    t_entry = t_lib = time.monotonic()
    if device.type == "cuda":
        port.build_library()
        t_lib = time.monotonic()
    pipe = build_program(torch, cfg, seed, device)
    t_program = time.monotonic()
    tracer = tr.Tracer(bool(trace), TRACE_SECONDS, device.type == "cuda",
                       port.Spans(pipe) if trace else None)
    tracer.warm()
    if trace:
        real = type(pipe).generate

        def generate(*a, **kw):
            tracer.before_call()
            with port.call_span():
                out = real(pipe, *a, **kw)
            tracer.after_call(out[0].shape[0])
            return out

        pipe.generate = generate
    loop = closed_loop if mix["kind"] == "closed" else open_loop
    rec = loop(pipe, cfg, mix, seed, seconds, clock, tracer, device)
    clock.sync()
    rec["memory_peak_bytes"] = clock.peak()
    rec["setup_s"] = rec["t_open"] - T_START
    # set-up by part: imports and data, the kernel library (its nvcc build
    # on a checkout's first run), weights and program, then the warm-up
    # (CondCache, warm calls, the profiler's)
    rec["setup_parts"] = dict(imports=t_entry - T_START,
                              library=t_lib - t_entry,
                              program=t_program - t_lib,
                              warm=rec["t_open"] - t_program)
    if trace:
        if not tracer.done.is_set():
            raise RuntimeError("traced run: the window closed before the "
                               "traced part ended")
        reading = tr.read(tracer.prof)
        if device.type == "cuda":
            tr.check_whole(reading)
        rec["trace"] = dict(reading, stories=tracer.stories,
                            calls=tracer.calls, work=tracer.spans.work,
                            t0=tracer.t0)
        tracer.prof = None
    del pipe, tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def check(cfg, mix, seed, rec, device, workload):
    """(correct, shown numbers, readings) of the run's sampled stories. A
    request that was accepted and never answered, or answered with an
    error, makes the run not correct too."""
    from storybench import check as ck

    ck.precise()
    model = ck.reference_model(cfg, seed, device)
    readings = []
    for index, (frames, embeds) in sorted(rec["outputs"].items()):
        ref_frames, ref_embeds = ck.reference_story(model, cfg, mix, seed,
                                                    index, device)
        readings.append(ck.numbers(frames, ref_frames[0], embeds,
                                   None if embeds is None
                                   else ref_embeds[0]))
    del model
    ok, shown = ck.verdict(ck.worst(readings), ck.limits(workload))
    return ok and not rec.get("errors"), shown, readings


def result(bench, cell, cfg, rec, trace, device, torch) -> dict:
    from storybench import data

    kind = "per_layer" if trace else "end_to_end"
    ctx = dict(rec, cfg=cfg, cell=cell)
    metrics = {}
    for m in data.metrics_of(bench, cell["name"], kind):
        value = data.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell["chips"],
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    if trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
    return {"correct": False, "attempted": rec["attempted"],
            "failed": rec["failed"], "metrics": metrics, "device": dev}


def main(argv=None) -> int:
    args = parse_args(argv)
    from storybench import data

    bench = data.benchmark()
    cell, cfg, mix = data.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"storybench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    if importlib.util.find_spec("rcdms_tpu_torch") is None:
        print("storybench: the port's package rcdms_tpu_torch is not beside "
              "the benchmark", file=sys.stderr)
        return 4
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rec = measure(cfg, mix, args.seed, args.seconds, args.trace, device)
    out = result(bench, cell, cfg, rec, args.trace, device, torch)
    if args.trace:
        from storybench import trace as tr

        out["breakdown"] = tr.breakdown(rec["trace"])
    t = time.monotonic()
    ok, shown, readings = check(cfg, mix, args.seed, rec, device,
                                cell["name"])
    out["correct"] = ok
    out["checks"] = shown
    diag = dict(setup_parts=rec["setup_parts"], check_s=time.monotonic() - t,
                readings=readings, window_s=rec["t_close"] - rec["t_open"])
    for key in ("latencies", "batch_sizes", "late_s", "calls"):
        if key in rec:
            diag[key] = rec[key]
    if rec.get("latencies"):
        lat = sorted(rec["latencies"])
        diag["latency_p90_s"] = statistics.quantiles(lat, n=10)[-1] \
            if len(lat) > 1 else lat[0]
    if args.trace:
        diag["trace"] = {k: rec["trace"][k] for k in (
            "span_s", "launches", "unmatched", "unmatched_under", "stories",
            "calls", "window_s", "busy_s")}
    bad = forbidden_modules()
    if bad:
        print(f"storybench: modules of JAX or of the JAX package are loaded:"
              f" {bad}", file=sys.stderr)
        return 5
    print("storybench: " + json.dumps(diag), flush=True)
    print(json.dumps(out), flush=True)
    for name, c in shown.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
