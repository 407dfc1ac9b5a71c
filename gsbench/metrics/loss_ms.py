"""Device milliseconds of assemble, L1 + SSIM and their backward
(train/loss.py) in one eager training iteration, from the profiled
kernels launched under the span."""


def read(ctx):
    s = ctx.get("spans", {}).get("gsbench.loss")
    return None if not s else 1e3 * s
