"""Milliseconds of the card's timeline a frame spends copying the model, the
camera and the background into the frame graph's buffers: two CUDA events
recorded around the copies. The card runs each copy as the host issues it, so
where the host issues them more slowly than the card copies, the card's
waits fall inside (at 1M gaussians the copies' bytes need ~0.15 ms).

Read from gsjax_torch's own registry (``utils.profiling.records``): the
layer clock's ``copy_in`` segment, over the calls on the graph path made
without a profiler; a program without the registry reads nothing."""


def read(ctx):
    if ctx["kind"] != "view":
        return None
    try:
        from gsjax_torch.utils.profiling import records
    except ImportError:
        return None
    graph = records()["untraced"]["layers"].get("view", {}).get("graph", {})
    return graph.get("ms", {}).get("copy_in")
