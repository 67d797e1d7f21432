"""launch.host_s_per_story: the host seconds inside the program's
`rcdms.launch.*` spans (each A-D wrapper's CUDA branch, from its operand
checks to the return of its last ctypes call), per story, in the traced
part of the window; 0 where the program's spans hold none (no wrapper
launched: the plain route, the CPU)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["stories"]:
        return None
    spans = t.get("program", {}).get("spans")
    if not spans:
        return None
    return sum(s["host_s"] for n, s in spans.items()
               if n.startswith("launch.")) / t["stories"]
