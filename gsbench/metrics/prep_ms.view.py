"""Device milliseconds of preprocess and binning in one eager frame
(ops/projection.py preprocess, ops/binning.py build_tile_bins), from the
profiled kernels launched under the span."""


def read(ctx):
    s = ctx.get("spans", {}).get("gsbench.prep.view")
    return None if not s else 1e3 * s
