"""The share of the host's time in which the card ran none of the dispatches'
iterations, in percent, without any profiler: 1 - the device time of the
layer clock's segments (CUDA events recorded inside the replayed graph, each
iteration from its start to its end) over the host intervals from each
call's start to the next call's start (the dispatch's host half, the copies
of its outputs and the caller's read of the metrics fall outside the
segments).

Read from gsjax_torch's own registry (``utils.profiling.records``), over the
calls made without a profiler; a program without the registry reads nothing."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    try:
        from gsjax_torch.utils.profiling import records
    except ImportError:
        return None
    graph = records()["untraced"]["layers"].get("train", {}).get("graph", {})
    return graph.get("idle")
