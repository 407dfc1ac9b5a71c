"""Device milliseconds a training step spends after Adam: the densification
statistics and the step's metrics, in the replayed chained dispatch.

Read from gsjax_torch's own registry (``utils.profiling.records``): the
layer clock's ``stats`` segment, event-record nodes inside the replayed
CUDA graph, over the calls made without a profiler; a program without
the registry reads nothing."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    try:
        from gsjax_torch.utils.profiling import records
    except ImportError:
        return None
    graph = records()["untraced"]["layers"].get("train", {}).get("graph", {})
    return graph.get("ms", {}).get("stats")
