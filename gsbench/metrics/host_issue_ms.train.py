"""Host milliseconds a training iteration costs the caller: from a chained
dispatch's call to its return (the host's half: camera indices, Adam rows,
the graph's buffers and its replay), over the steps it runs, averaged
over the window's dispatches. Layer: dispatch (train/step.py _Dispatch,
utils/graphs.py)."""


def read(ctx):
    return ctx.get("host_issue_ms") if ctx["kind"] == "train" else None
