"""The whole training step's share of the card's float32 peak, in percent: the float32
operations the traced iterations need (gsbench/work.py, from the reference's counts
on their poses) over the profiled window's length and 67 TFLOP/s."""

from gsbench.work import PEAK_F32_PER_S


def read(ctx):
    if ctx["kind"] != "train" or not ctx.get("mfu_seconds") or not ctx.get("needed_ops"):
        return None
    return 100.0 * ctx["needed_ops"] / ctx["mfu_seconds"] / PEAK_F32_PER_S
