"""Mean device milliseconds of `train_ppo.learn` (2 epochs x 4 minibatches) per
update over the traced window, from CUDA events around them."""


def read(ctx):
    v = ctx.spans.get("learn_ms", [])
    return sum(v) / len(v) if v else None
