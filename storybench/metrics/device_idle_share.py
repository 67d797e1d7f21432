"""device_idle_share: 1 - the device's busy time a story (the union of its
operations' intervals in the traced calls, over their stories) times the
stories of the window's calls before the profiler started, over those
calls' wall time, in %. The busy time a story comes from the trace; the
wall time from calls the profiler did not slow."""


def read(ctx):
    t, calls = ctx.get("trace"), ctx.get("calls")
    if not t or not calls or not t["stories"]:
        return None
    before = [c for c in calls if c[1] <= t["t0"]]
    if not before:
        return None
    busy = t["busy_s"] / t["stories"] * sum(c[2] for c in before)
    return 100.0 * (1.0 - busy / (before[-1][1] - ctx["t_open"]))
