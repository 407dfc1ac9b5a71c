"""Host milliseconds of the trainer's budget probe in set-up
(``train/loop.py:_probe_initial_budgets``, training): every training
camera's footprints measured and the budgets sized from them.

Read from gsjax_torch's own registry (``utils.profiling.records``): the
host seconds of the span "budgets.probe" over the calls made without a
profiler (the registry is never reset in a run, so set-up's probe is
there); a program without the span reads nothing."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    try:
        from gsjax_torch.utils.profiling import records
    except ImportError:
        return None
    span = records()["untraced"]["spans"].get("budgets.probe")
    return 1e3 * span["seconds"] if span else None
