"""Device milliseconds of Adam (train/optim.py) in one eager training
iteration, from the profiled kernels launched under the span."""


def read(ctx):
    s = ctx.get("spans", {}).get("gsbench.adam")
    return None if not s else 1e3 * s
