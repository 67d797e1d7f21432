"""Readings that the check's limits are set from, many seeds in one
process: for each seed, the port's timed entry at the cell's own sizes
(one `generate` call of the mix's batch, or a full batch of requests into
`StoryServer.submit`), then the plain reference over the checked stories;
and the same with the port's int8 route (`--quantize int8`, the control)
on the control seeds.

    python3 -m storybench.calibrate --config rcdms-flintstones \
        --traffic offline-b4 --seeds 1,2,3 --fp8-seeds 4,5,6 \
        --control-seeds 7 --check 2 --out calibrate.jsonl

The control is the reference itself computed in the precision
below bf16 (`check.Fp8Products`, fp8 e4m3 operands), put in the
program's place on the `--fp8-seeds`; the port's own int8 route runs on
the `--control-seeds`.

One JSON line a (seed, story): the compared numbers, which control it is
(null for the program), and the seconds of the program's call and of the
reference.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from storybench import check as ck
from storybench import data, port, run, traffic


def program_outputs(cfg, mix, seed, device, quantize, n) -> dict:
    """{story index: (frames, embeds or None)} of the first `n` stories of
    one timed-path call at the cell's sizes."""
    pipe = run.build_program(torch, cfg, seed, device, quantize)
    t = time.monotonic()
    if mix["kind"] == "closed":
        cache = port.cond_cache(pipe, cfg)
        frames, embeds = run._call(pipe, cache, cfg, mix, seed,
                                   range(mix["batch"]), device)
        out = {i: (frames[i].cpu(), embeds[i].cpu()) for i in range(n)}
    else:
        server = port.story_server(pipe, cfg, mix)
        server.start()
        try:
            stories = [traffic.story(cfg, mix, seed, j, device)
                       for j in range(mix["max_batch"])]
            reqs = [server.submit(port.request_inputs(s["inputs"]),
                                  s["noise_seed"]) for s in stories]
            for r in reqs:
                r.done.wait()
                if r.error is not None:
                    raise RuntimeError(r.error)
        finally:
            server.stop()
            server.worker.join(timeout=60)
        out = {i: (run.torch_from_u8(reqs[i].frames), None)
               for i in range(n)}
        del server
    run.Clock(torch, device).sync()
    call_s = time.monotonic() - t
    del pipe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out, call_s


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fp8-seeds", default="")
    p.add_argument("--check", type=int, default=2)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="cpu: a rehearsal of the tool at a tiny size")
    args = p.parse_args(argv)
    cfg, mix = data.files(args.config, args.traffic)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("calibrate: needs a CUDA card", file=sys.stderr)
            return 3
        port.build_library()
    runs = [(int(s), None) for s in args.seeds.split(",") if s] + \
        [(int(s), "int8") for s in args.control_seeds.split(",") if s] + \
        [(int(s), "fp8") for s in args.fp8_seeds.split(",") if s]
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    for seed, quantize in runs:
        if quantize == "fp8":
            outputs, call_s = None, 0.0
        else:
            outputs, call_s = program_outputs(cfg, mix, seed, device,
                                              quantize, args.check)
            port.quant.set_quant_mode(None)
        t = time.monotonic()
        ck.precise()
        model = ck.reference_model(cfg, seed, device)
        if outputs is None:
            outputs = {}
            for index in range(args.check):
                with ck.Fp8Products():
                    frames, embeds = ck.reference_story(model, cfg, mix,
                                                        seed, index, device)
                if mix["kind"] != "closed":  # the server's 8-bit frames
                    frames, embeds = ck.as_served(frames), None
                outputs[index] = (frames[0], None if embeds is None
                                  else embeds[0])
        for index, (frames, embeds) in outputs.items():
            rf, re = ck.reference_story(model, cfg, mix, seed, index, device)
            known = traffic.story(cfg, mix, seed, index, device)[
                "inputs"]["frame_known"][0]
            row = dict(config=args.config, traffic=args.traffic, seed=seed, story=index,
                       control=quantize, call_s=call_s, card=card,
                       **ck.numbers(frames, rf[0], embeds,
                                    None if embeds is None else re[0]),
                       diag=ck.diagnostics(frames, rf[0], known))
            row["reference_s"] = time.monotonic() - t
            print(json.dumps(row), flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del model
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
