"""Device milliseconds of the reduction of the per-pair gradient table to
gaussians (ops/cuda_composite.py reduce_pair_grads) in one eager training
iteration, from the profiled kernels launched under the span."""


def read(ctx):
    s = ctx.get("spans", {}).get("gsbench.reduce")
    return None if not s else 1e3 * s
