"""Host milliseconds a training step costs its chained dispatch to launch its
graph (graph.replay: cudaGraphLaunch) and to copy its outputs
(graph.outputs).

Read from gsjax_torch's own registry (``utils.profiling.records``), over the
calls made without a profiler: the mean of each span a replayed call, over
the steps a replayed call runs. A graph's first launch (graph.first_replay,
which also uploads the graph) is set-up, and left out; a program without the
registry reads nothing."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    try:
        from gsjax_torch.utils.profiling import records
    except ImportError:
        return None
    rec = records()["untraced"]
    replay = rec["spans"].get("graph.replay")
    outputs = rec["spans"].get("graph.outputs")
    items = rec["counters"].get("train.graph", 0)
    if not replay or not outputs or not items:
        return None
    per_call = replay["seconds"] / replay["count"] + outputs["seconds"] / outputs["count"]
    return 1e3 * per_call * outputs["count"] / items
