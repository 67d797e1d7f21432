"""setup_s: from the process's start to the window's open: the kernel
library (built on a checkout's first run, reused after), the weights, the
program, the warm-up of every shape the traffic uses and, in an open loop,
the arrivals' lead-in (host clock)."""


def read(ctx):
    return ctx["setup_s"]
