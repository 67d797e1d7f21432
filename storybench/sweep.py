"""The knee of an open-loop cell: the highest arrival rate at which the
server's backlog does not grow over a window. One process, one server,
one rate after another:

    python3 -m storybench.sweep --config rcdms-pororosv \
        --traffic served-steady --seed 1 --rates 0.45,0.55,0.65 \
        --seconds 80

For each rate, one JSON line: the requests due in the window, the median
and 90th percentile latency from the due time, the mean batch, and the
slope of latency against due time over the window (s per s: about 0
below the knee, growing with the rate above it). The cell's mix then
states its rate as a fixed number; nothing computes it at run time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from storybench import data, port, run, trace, traffic


def slope(xs, ys) -> float:
    mx, my = statistics.mean(xs), statistics.mean(ys)
    den = sum((x - mx) ** 2 for x in xs)
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=80.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cfg, mix = data.files(args.config, args.traffic)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    port.build_library()
    pipe = run.build_program(torch, cfg, args.seed, device)
    clock = run.Clock(torch, device)
    tracer = trace.Tracer(False, 0.0, cuda=False)
    server = port.story_server(pipe, cfg, mix)
    server.start()
    rows = []
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            m = dict(mix, rate_per_s=rate, lead_s=10.0)
            rec = run._serve(server, cfg, m, args.seed, args.seconds, clock,
                             tracer, device, port, traffic, warm=i == 0)
            w = [j for j in rec["window"] if rec["done_at"][j] is not None]
            lat = [rec["done_at"][j] - rec["due_at"][j] for j in w]
            row = dict(rate=rate, due=len(rec["window"]), answered=len(w),
                       p50=statistics.median(lat),
                       p90=statistics.quantiles(lat, n=10)[-1],
                       batch_mean=statistics.mean(rec["batch_sizes"]),
                       slope=slope([rec["due_at"][j] for j in w], lat),
                       card=torch.cuda.get_device_name(device))
            rows.append(row)
            print(json.dumps(row), flush=True)
            time.sleep(1.0)
    finally:
        server.stop()
        server.worker.join(timeout=run.DRAIN_S)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
