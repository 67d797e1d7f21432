"""device_idle_share.served: 1 - the device's busy time a story (the union
of its operations' intervals in the traced batches at the window's end,
over their stories) times the stories answered of those due in the
window, over the window's length, in %."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["stories"] or "latencies" not in ctx:
        return None
    busy = t["busy_s"] / t["stories"] * len(ctx["latencies"])
    return 100.0 * (1.0 - busy / (ctx["t_close"] - ctx["t_open"]))
