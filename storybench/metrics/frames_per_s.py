"""frames_per_s: every frame of the window's `generate` calls over the time
from the window's open to the end of its last call (host clock, each call
ending in a device synchronisation)."""


def read(ctx):
    if "calls" not in ctx:
        return None
    return ctx["frames"] / (ctx["t_close"] - ctx["t_open"])
