"""unet_loop.idle_s_per_story: the device's idle seconds inside the
program's `rcdms.stage2.unet_loop` span (the story sampler's call: its 20
steps of two UNet calls, the CFG mix and the DDIM step), per story, in the
traced part of the window: the idle gaps whose midpoint falls inside the
span, the time the host keeps the card waiting there."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["stories"]:
        return None
    idle = t.get("program", {}).get("loop_idle_s", {})
    if "stage2.unet_loop" not in idle:
        return None
    return idle["stage2.unet_loop"] / t["stories"]
