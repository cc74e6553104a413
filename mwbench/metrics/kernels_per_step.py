"""Device kernels per env step in the profiled segment (the fused step and
the traffic's own launches), from the trace."""


def read(ctx):
    if ctx.trace is None or not ctx.profiled_steps:
        return None
    return len(ctx.trace.kernels) / ctx.profiled_steps
