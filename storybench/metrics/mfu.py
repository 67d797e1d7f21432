"""mfu: a story's model FLOPs (`work.story_flops`, from the configuration's
shapes, with a warm CondCache) times the stories of the window's calls
that ran before the profiler started, over their wall time (host clock,
from the window's open to the last of them ending), over the card's 989
TFLOP/s bf16 peak, in %. The traced calls at the window's end are left
out: the profiler slows the host."""

from storybench import work


def read(ctx):
    t, calls = ctx.get("trace"), ctx.get("calls")
    if not t or not calls:
        return None
    before = [c for c in calls if c[1] <= t["t0"]]
    if not before:
        return None
    stories = sum(c[2] for c in before)
    wall = before[-1][1] - ctx["t_open"]
    flops = sum(work.story_flops(ctx["cfg"], 1).values()) * stories
    return 100.0 * flops / (wall * work.PEAK_FLOPS[2])
