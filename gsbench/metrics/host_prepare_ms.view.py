"""Host milliseconds a frame costs before its graph is launched: the graph
cache's key and lookup (frame.bind) and the copies of the model, the camera
and the background into the graph's buffers (frame.copy_in).

Read from gsjax_torch's own registry (``utils.profiling.records``): the host
seconds of the spans ("frame.bind", "frame.copy_in"), over the calls made
without a profiler, per frame of every path; a program without the registry
reads nothing."""

SPANS = ("frame.bind", "frame.copy_in")
PATHS = ("graph", "capture", "eager")


def read(ctx):
    if ctx["kind"] != "view":
        return None
    try:
        from gsjax_torch.utils.profiling import records
    except ImportError:
        return None
    rec = records()["untraced"]
    items = sum(rec["counters"].get(f"view.{p}", 0) for p in PATHS)
    if not items:
        return None
    return 1e3 * sum(rec["spans"].get(n, {}).get("seconds", 0.0) for n in SPANS) / items
