"""95th percentile (nearest rank) over every step of the traced window of
the device time between the CUDA events recorded after consecutive fused
steps: the fused step as the traffic paces it."""

import math


def read(ctx):
    v = sorted(ctx.spans.get("step_ms", []))
    if not v:
        return None
    return v[math.ceil(0.95 * len(v)) - 1]
