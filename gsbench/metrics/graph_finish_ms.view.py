"""Device milliseconds a frame spends after the compositing kernel: assemble,
the uint8 quantize and the drop counter, in the replayed frame graph.

Read from gsjax_torch's own registry (``utils.profiling.records``): the
layer clock's ``finish`` segment, event-record nodes inside the replayed
CUDA graph, over the calls made without a profiler; a program without
the registry reads nothing."""


def read(ctx):
    if ctx["kind"] != "view":
        return None
    try:
        from gsjax_torch.utils.profiling import records
    except ImportError:
        return None
    graph = records()["untraced"]["layers"].get("view", {}).get("graph", {})
    return graph.get("ms", {}).get("finish")
