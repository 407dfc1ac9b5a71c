"""Host milliseconds a training step costs its chained dispatch before the
graph is launched: bound and index checks, Adam's rows and key draws
(dispatch.prepare), the graph cache's lookup (dispatch.bind) and the copies
into the graph's buffers (dispatch.copy_in).

Read from gsjax_torch's own registry (``utils.profiling.records``): the host
seconds of the spans ("dispatch.prepare", "dispatch.bind",
"dispatch.copy_in"), over the calls made without a profiler, per step of
every path; a program without the registry reads nothing."""

SPANS = ("dispatch.prepare", "dispatch.bind", "dispatch.copy_in")
PATHS = ("graph", "capture", "eager")


def read(ctx):
    if ctx["kind"] != "train":
        return None
    try:
        from gsjax_torch.utils.profiling import records
    except ImportError:
        return None
    rec = records()["untraced"]
    items = sum(rec["counters"].get(f"train.{p}", 0) for p in PATHS)
    if not items:
        return None
    return 1e3 * sum(rec["spans"].get(n, {}).get("seconds", 0.0) for n in SPANS) / items
