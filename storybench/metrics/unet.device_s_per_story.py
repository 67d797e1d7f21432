"""unet.device_s_per_story: device seconds of the kernels launched inside
the harness's spans around `StoryUNet.forward`, per story, in the traced
part of the window."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["stories"] or "unet" not in t["span_s"]:
        return None
    return t["span_s"]["unet"] / t["stories"]
