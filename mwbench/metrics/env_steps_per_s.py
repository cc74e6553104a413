"""Every env-step completed in the window over the window's wall time, from
a synchronise at its start to one after its last step (host clock)."""


def read(ctx):
    w = ctx.window
    return w["env_steps"] / w["window_s"] if w and w["window_s"] > 0 else None
