"""csrc/composite_fwd.cu (the training forward)'s share of its roofline, in percent: the least time the
launches of the profiled graphed window need (bytes at the memory rate,
float32 operations and exps at theirs, counted by the reference on the
same poses: gsbench/work.py) over the time they took."""


def read(ctx):
    t = ctx.get("kernel_time", {}).get("composite_fwd")
    need = ctx.get("kernel_need", {}).get("composite_fwd")
    if not t or not need or t[0] <= 0:
        return None
    return 100.0 * need / t[0]
