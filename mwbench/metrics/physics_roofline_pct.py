"""The physics kernel's share of its roofline: the least time of a control
step, max(operations / peak float32 rate, bytes / peak HBM rate), over the
kernel's device time per control step in the profiled segment. Kernels are
found by the names of `yardstick/physics_kernels.json`; operations and
bytes come from the frozen counts (`roofline.physics_step`)."""

from mwbench import roofline
from mwbench.cells import yardstick


def read(ctx):
    peak = roofline.peaks(ctx.device_kind)
    if ctx.trace is None or peak is None or not ctx.profiled_steps:
        return None
    names = yardstick("physics_kernels.json")["names"]
    us = sum(d for name, _, d in ctx.trace.kernels if any(k in name for k in names))
    if us <= 0:
        return None
    ops, nbytes = roofline.physics_step(ctx.layout)
    bound_s = max(ops / peak["f32_flops"], nbytes / peak["hbm_bytes_per_s"])
    return 100.0 * bound_s / (us * 1e-6 / ctx.profiled_steps)
