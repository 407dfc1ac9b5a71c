"""The share of the host's time in which the card ran none of the frames'
layers, in percent, without any profiler: 1 - the device time of the layer
clock's segments (the copies into the graph's buffers between two CUDA events,
with any wait for the host between them; then the graph from its first
event-record node to its last) over the host intervals from each call's start
to the next call's start (the frame's host half before the copies, the wait
for the graph's launch after them and the caller's copy of the frame to host
memory fall outside the segments).

Read from gsjax_torch's own registry (``utils.profiling.records``), over the
calls made without a profiler; a program without the registry reads nothing."""


def read(ctx):
    if ctx["kind"] != "view":
        return None
    try:
        from gsjax_torch.utils.profiling import records
    except ImportError:
        return None
    graph = records()["untraced"]["layers"].get("view", {}).get("graph", {})
    return graph.get("idle")
