"""Mean host-clock milliseconds inside each `envs.step` call of the traced
window, with no synchronise: the host's cost of issuing one fused step."""


def read(ctx):
    v = ctx.spans.get("enqueue_ms", [])
    return sum(v) / len(v) if v else None
