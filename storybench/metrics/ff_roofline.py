"""ff_roofline: the least time the card could take for the work of each
`FeedForward` call (`work.ff`: both products, each input byte read once),
summed, over the device seconds of the kernels launched inside the
harness's spans around those calls, in %."""

from storybench import work


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    return work.share(t["work"]["ff"], t["span_s"].get("ff", 0))
