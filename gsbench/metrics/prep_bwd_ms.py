"""Device milliseconds of autograd through preprocess and the activations
in one eager training iteration, from the profiled kernels launched under
the span."""


def read(ctx):
    s = ctx.get("spans", {}).get("gsbench.prep_bwd")
    return None if not s else 1e3 * s
