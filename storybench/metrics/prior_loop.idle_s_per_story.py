"""prior_loop.idle_s_per_story: the device's idle seconds inside the
program's `rcdms.stage1.prior_loop` span (the prior sampler's call: its 20
steps), per story, in the traced part of the window: the idle gaps whose
midpoint falls inside the span."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["stories"]:
        return None
    idle = t.get("program", {}).get("loop_idle_s", {})
    if "stage1.prior_loop" not in idle:
        return None
    return idle["stage1.prior_loop"] / t["stories"]
