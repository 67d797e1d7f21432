"""norm.device_s_per_story: device seconds of the kernels launched inside
the program's `rcdms.norm` spans (`GroupNorm` and `LayerNorm`, fp32
widening and cast back included), per story, in the traced part of the
window."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["stories"]:
        return None
    norm = t.get("program", {}).get("spans", {}).get("norm")
    if norm is None:
        return None
    return norm["device_s"] / t["stories"]
