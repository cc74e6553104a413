"""Seconds from process start to the first step of the window: imports,
the device's context, the kernel library (built on a checkout's first run,
loaded afterwards), the engine, the traffic's state and the warm-up."""


def read(ctx):
    return ctx.setup_s
