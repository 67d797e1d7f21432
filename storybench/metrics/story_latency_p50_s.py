"""story_latency_p50_s: the median, over every request due in the window,
of the seconds from its due time to its answer (host clock)."""

import statistics


def read(ctx):
    lat = ctx.get("latencies")
    return statistics.median(lat) if lat else None
