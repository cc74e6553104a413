"""Mean device milliseconds per rollout step of `train_ppo.rollout` (policy
sample, fused step, trajectory) over the traced window, from CUDA events
around each rollout call divided by its steps."""


def read(ctx):
    v = ctx.spans.get("rollout_step_ms", [])
    return sum(v) / len(v) if v else None
