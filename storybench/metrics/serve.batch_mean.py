"""serve.batch_mean: stories a `generate` call, the mean of each answered
request's `batch_size` over the requests due in the window (the server's
own count)."""

import statistics


def read(ctx):
    sizes = ctx.get("batch_sizes")
    return statistics.mean(sizes) if sizes else None
