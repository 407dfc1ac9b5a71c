"""The share of the profiled window of graphed frames in which no operation ran on
the device, in percent (the busy time is the union of the device
operations' intervals)."""


def read(ctx):
    if ctx["kind"] != "view" or not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
