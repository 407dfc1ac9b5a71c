"""Reading a ``torch.profiler`` trace: device time by kernel, by the
benchmark's own spans, the device's busy time over a window and the
longest idle gaps.

The trace is exported in Chrome's format to a temporary directory (under
``TMPDIR``) and read back: a device operation (``kernel``, ``gpu_memcpy``,
``gpu_memset``) carries the correlation id of the runtime call that
launched it (a CUDA graph's kernels all carry the replay's), and that
call's host time places it inside the span (``user_annotation``) that was
open on its thread.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
SPAN_PREFIX = "gsbench."


@contextlib.contextmanager
def profiled():
    """Profile CPU and CUDA activity; yields a dict that holds the parsed
    events (``events``) once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with tempfile.TemporaryDirectory(prefix="gsbench-trace-") as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield out
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = [e for e in json.load(f).get("traceEvents", [])
                             if e.get("ph") == "X"]


def _iv(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def device_ops(events):
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def spans(events, prefix=SPAN_PREFIX):
    return [e for e in events if e.get("cat") == "user_annotation"
            and str(e.get("name", "")).startswith(prefix)]


def span_device_seconds(events) -> dict:
    """Device seconds of the operations launched inside each benchmark span,
    by span name (the innermost span open at the launch). The launch's
    thread is not matched: autograd's backward launches from its own
    thread while the span's thread waits in ``backward``."""
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = float(e["ts"])
    sp = sorted(((*_iv(e), e["name"]) for e in spans(events)), key=lambda s: (s[0], -s[1]))
    out = {}
    for e in device_ops(events):
        c = (e.get("args") or {}).get("correlation")
        if c not in launch:
            continue
        t = launch[c]
        inner = None
        for s0, s1, name in sp:
            if s0 > t:
                break
            if s0 <= t <= s1:
                inner = name  # later-starting spans are nested deeper
        if inner is not None:
            out[inner] = out.get(inner, 0.0) + float(e.get("dur", 0.0)) * 1e-6
    return out


def window(events, span_name: str):
    """(start, end) in trace microseconds: from the first ``span_name``
    span's start to the later of the last one's end and the last device
    operation's end."""
    ss = [_iv(e) for e in spans(events) if e["name"] == span_name]
    if not ss:
        return None
    start = min(s for s, _ in ss)
    end = max(e for _, e in ss)
    ends = [b for a, b in map(_iv, device_ops(events)) if a >= start]
    return start, max([end] + ends)


def busy_and_gaps(events, win):
    """Seconds in which a device operation ran within ``win``, and the idle
    gaps ``[(start, seconds)]`` between them, longest first."""
    lo, hi = win
    iv = sorted((max(a, lo), min(b, hi)) for a, b in map(_iv, device_ops(events))
                if b > lo and a < hi)
    busy, gaps, cur = 0.0, [], None
    for a, b in iv:
        if cur is None:
            if a > lo:
                gaps.append((lo, a - lo))
            cur = [a, b]
        elif a > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], a - cur[1]))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
        if cur[1] < hi:
            gaps.append((cur[1], hi - cur[1]))
    gaps.sort(key=lambda g: -g[1])
    return busy * 1e-6, [(s, d * 1e-6) for s, d in gaps]


def host_activity(events, t: float) -> str:
    """The innermost host event open at trace time ``t`` (the latest to
    start), or "host idle"."""
    best = None
    for e in events:
        if e.get("cat") not in HOST_CATS:
            continue
        a, b = _iv(e)
        if a <= t <= b and (best is None or a >= best[0]):
            best = (a, e["name"])
    return best[1] if best else "host idle"


def kernel_seconds(events, win=None) -> dict:
    """``{name: [seconds, launches]}`` of the device operations (within
    ``win`` if given), names cut at their parameter list."""
    out = {}
    for e in device_ops(events):
        a, b = _iv(e)
        if win is not None and not (a >= win[0] and b <= win[1] + 1.0):
            continue
        name = short_name(str(e["name"]))
        s = out.setdefault(name, [0.0, 0])
        s[0] += (b - a) * 1e-6
        s[1] += 1
    return out


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list, anonymous
    namespaces kept (``(anonymous namespace)::f<...>(...)``)."""
    name = name.replace("(anonymous namespace)", "{anonymous}")
    return name.split("(")[0].removeprefix("void ").replace("{anonymous}",
                                                            "(anonymous namespace)")


def breakdown(events, win, gaps) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, each named by what the host was doing at its start."""
    ks = sorted(kernel_seconds(events, win).items(), key=lambda kv: -kv[1][0])
    return {"device_ops": [[k, v[0]] for k, v in ks[:10]],
            "idle_gaps": [[host_activity(events, s + 0.5), d] for s, d in gaps[:10]]}


def kernel_of(name: str):
    """The port's compositing kernel a device operation's name is, or None."""
    if "composite_blend_kernel<true" in name:
        return "composite_fwd"
    if "composite_blend_kernel<false" in name:
        return "composite_infer"
    if "composite_bwd_kernel" in name:
        return "composite_bwd"
    return None

