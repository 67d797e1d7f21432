"""attention_roofline: the least time the card could take for the work the
inputs of each `multihead_attention` call need (`work.attention`: two
products, one exponential a score, each input byte read once), summed,
over the device seconds of the kernels launched inside the harness's spans
around those calls, in %."""

from storybench import work


def read(ctx):
    t = ctx.get("trace")
    if not t:
        return None
    return work.share(t["work"]["attention"], t["span_s"].get("attention", 0))
