"""CUDA graphs of the port's training step and frame: gsjax's ``jit``.

gsjax compiles a training step, a chained dispatch of steps and a render
into one XLA program each and calls it once a dispatch. The port's
counterpart on the card is a CUDA graph (``torch.cuda.CUDAGraph``): the
step's hundreds of kernel launches are recorded once and replayed with one
call, so the host no longer launches them one by one.

:class:`Graph` holds one captured function. Its first call runs the
function eagerly on the capture stream, as PyTorch's recipe asks (the
warm-up does the call's real work, so nothing is computed twice), then
captures it; every later call replays the capture. A capture reads and
writes the tensors it found at capture time, at their addresses, so the
callers (``train/step.py``) write each call's inputs into the graph's
static buffers, keep the state's tensors in place, and key their graphs on
those tensors' addresses as well as on what gsjax's ``jit`` keys its
programs on. A capture that fails raises; nothing falls back to eager.

The registry of ``utils.profiling`` counts the kernel launches. A launch
made while a graph is captured launches nothing: the registry records it
into the capture (``Registry.capturing``), and :class:`Graph` hands those
counts back at every replay (``Registry.replayed``), so the counts stay
the number of kernels that ran.

Spans of ``utils.profiling``'s registry time a graph's host work:
``graph.warm_up`` and ``graph.capture`` (their counts are the captures),
``graph.replay`` (``cudaGraphLaunch``), ``graph.first_replay`` (a graph's
first launch, which also uploads it and can hold the host for as long as
the card runs the graph) and ``graph.outputs`` (the copy of the outputs
and the launch counts). The layer clock's marks that a capture records are
event-record nodes of the graph: :class:`Graph` keeps them and hands them
to the clock at every replay.
"""

from __future__ import annotations

import collections
import gc
import time

import torch

from gsjax_torch.utils import profiling

GRAPHS_KEPT = 2  # captured graphs a cache keeps (each holds its own memory pool)

_streams: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream every warm-up and capture on ``device`` runs on."""
    s = _streams.get(device.index)
    if s is None:
        s = _streams[device.index] = torch.cuda.Stream(device)
    return s


def clone_outputs(out):
    """A copy of a captured function's outputs (a tensor, or a tuple or
    dict of them), which the next replay would overwrite."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: clone_outputs(v) for k, v in out.items()}
    return type(out)(clone_outputs(v) for v in out)


def pin_copy_(buf: torch.Tensor, values) -> torch.Tensor:
    """Write ``values`` (numbers, an array or a tensor) into ``buf`` without
    the host waiting: a host value reaches a card through pinned memory
    (the caching host allocator keeps the block until the copy has run).
    Returns ``buf``."""
    if isinstance(values, torch.Tensor) and values.device.type != "cpu":
        return buf.copy_(values, non_blocking=True)
    t = torch.as_tensor(values, dtype=buf.dtype).reshape(buf.shape)
    if buf.device.type == "cuda":
        t = t.pin_memory()
    return buf.copy_(t, non_blocking=True)


class Graph:
    """``fn`` (no arguments, returns tensors) as a CUDA graph on
    ``device``: the first call runs ``fn`` eagerly on the capture stream
    and then captures it, later calls replay it. Each call returns a copy
    of the outputs. ``capture_s`` is the host seconds of the capture (with
    its instantiation), ``marks`` the layer clock's stamps it recorded
    (``mark_events``: their events, which the graph's nodes need alive) and
    ``kernels`` the kernel launches it recorded, ``{kernel: count}``."""

    def __init__(self, fn, device: torch.device):
        self.fn = fn
        self.device = device
        self.graph = None
        self.out = None
        self.kernels = {}
        self.capture_s = None
        self.marks, self.mark_events = [], []
        self.launched = False

    def __call__(self):
        if self.graph is None:
            return self._warm_up_and_capture()
        profiling.REGISTRY.replaying(self.marks, self.mark_events)
        with profiling.span("graph.replay" if self.launched else "graph.first_replay"):
            self.graph.replay()
        self.launched = True
        with profiling.span("graph.outputs"):
            profiling.REGISTRY.replayed(self.kernels)
            return clone_outputs(self.out)

    def _warm_up_and_capture(self):
        if torch.is_anomaly_enabled():
            raise RuntimeError("autograd anomaly detection cannot be captured in a CUDA "
                               "graph: build the step with eager=True")
        s = capture_stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        with profiling.span("graph.warm_up"):
            s.wait_stream(cur)
            with torch.cuda.stream(s):
                out = self.fn()
            cur.wait_stream(s)
        # no garbage collection inside the capture: a graph it freed there
        # (a dropped step closure's, which sits in a reference cycle) would
        # be destroyed during the capture, which CUDA refuses
        collecting = gc.isenabled()
        gc.disable()
        try:
            with profiling.span("graph.capture"), \
                    profiling.REGISTRY.capturing() as (marks, self.mark_events, launches):
                t0 = time.perf_counter()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=s):
                    self.out = self.fn()
                self.capture_s = time.perf_counter() - t0
        finally:
            if collecting:
                gc.enable()
        self.marks, self.kernels = marks, launches
        self.graph = graph
        return out


class GraphCache:
    """The graphs of one function, keyed as gsjax's ``jit`` keys its
    programs, each bound to the addresses of the tensors it reads and
    writes: a key whose tensors moved is captured anew. It keeps the
    :data:`GRAPHS_KEPT` most recently used. ``captures`` counts the
    captures."""

    def __init__(self):
        self.entries = collections.OrderedDict()
        self.captures = 0

    def get(self, key, binding, make):
        """The entry of ``key`` bound to ``binding``; ``make()`` builds a
        new one (its graph captured at its first call)."""
        hit = self.entries.get(key)
        if hit is not None and hit[0] == binding:
            self.entries.move_to_end(key)
            return hit[1]
        self.entries.pop(key, None)
        while len(self.entries) >= GRAPHS_KEPT:
            self.entries.popitem(last=False)
        entry = make()
        self.entries[key] = (binding, entry)
        self.captures += 1
        return entry


def addresses(*tensors) -> tuple:
    """The data pointers that bind a graph to its tensors."""
    return tuple(t.data_ptr() for t in tensors)
