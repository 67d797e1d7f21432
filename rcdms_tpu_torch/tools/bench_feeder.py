"""The host's input pipeline in stories/s: the numpy protocol
(`data/protocol.py::build_story_example`) against the native C++ feeder
(`data/native_feeder.py`, built with g++ at first use), on synthetic
128 px 5-frame stories packed to 512 px batches (the FlintstonesSV
configuration). The port's counterpart of `tools/bench_feeder.py`, with
its flags.

    python -m rcdms_tpu_torch.tools.bench_feeder [--batches 8]
        [--batch-size 8] [--threads 4] [--size 512] [--csize 224]

Prints one line for each path, as the JAX tool does; `run(argv)` returns
the seconds and stories/s of both (the native path's None where the
feeder does not build here).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from rcdms_tpu_torch.configs import DatasetConfig
from rcdms_tpu_torch.data import native_feeder
from rcdms_tpu_torch.data.protocol import StoryTokenizer, build_story_example


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--csize", type=int, default=224)
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    args = parse_args(argv)
    cfg = DatasetConfig(image_size=args.size, clip_size=args.csize)
    tok = StoryTokenizer(cfg)
    rng = np.random.RandomState(0)
    stories = [rng.randint(0, 256, (5, 128, 128, 3), np.uint8)
               for _ in range(args.batch_size)]
    kls = [int(rng.randint(0, 5)) for _ in range(args.batch_size)]
    n_stories = args.batches * args.batch_size

    t0 = time.perf_counter()
    for _ in range(args.batches):
        for s, kl in zip(stories, kls):
            build_story_example(list(s), ["c"] * 5, kl, tok, cfg=cfg)
    t_py = time.perf_counter() - t0
    print(f"python protocol: {t_py:.2f}s  {n_stories / t_py:.2f} stories/s",
          flush=True)
    result = dict(stories=n_stories, python_s=t_py,
                  python_stories_per_s=n_stories / t_py, native_s=None,
                  native_stories_per_s=None, threads=args.threads)

    if not native_feeder.available():
        print("native feeder: the library does not build here (g++ "
              "and native/story_feeder.cpp)")
        return result
    feeder = native_feeder.NativeFeeder(num_threads=args.threads)
    try:
        # warm at full batch size: allocates and faults in the output ring
        feeder.pack_batch(stories, kls, args.size, args.csize)
        t0 = time.perf_counter()
        for _ in range(args.batches):
            feeder.pack_batch(stories, kls, args.size, args.csize)
            for _ in range(args.batch_size):
                tok(["c"] * 5)
        t_nat = time.perf_counter() - t0
    finally:
        feeder.close()
    print(f"native feeder ({args.threads} threads): {t_nat:.2f}s  "
          f"{n_stories / t_nat:.2f} stories/s  ({t_py / t_nat:.2f}x)",
          flush=True)
    result.update(native_s=t_nat, native_stories_per_s=n_stories / t_nat)
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
