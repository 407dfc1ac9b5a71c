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

The kernels' launch counters (``fn.launches`` of ``ops.cuda_composite``)
are Python and run while a graph is captured, when nothing is launched.
:class:`Graph` takes back what a capture added and adds it again at every
replay, so the counts stay the number of kernels that ran.
"""

from __future__ import annotations

import collections
import time

import torch

from gsjax_torch.ops import cuda_composite

# (wrapper, attribute) of every launch counter a captured function can move
_COUNTERS = (
    (cuda_composite.composite_infer, "launches"),
    (cuda_composite.composite_fwd, "launches"),
    (cuda_composite.composite_fwd_check, "launches"),
    (cuda_composite.composite_bwd, "launches"),
    (cuda_composite.composite_bwd, "launches_bf16"),
    (cuda_composite.composite_bwd_counts, "launches"),
)
GRAPHS_KEPT = 2  # captured graphs a cache keeps (each holds its own memory pool)
# captures since the counts were last set to 0, and the host seconds they
# took (the warm-ups not included; the train CLI reports both)
CAPTURES = {"count": 0, "seconds": 0.0}

_streams: dict = {}


def launch_counts() -> tuple:
    return tuple(getattr(fn, attr) for fn, attr in _COUNTERS)


def _add_launch_counts(delta):
    for (fn, attr), d in zip(_COUNTERS, delta):
        setattr(fn, attr, getattr(fn, attr) + d)


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
    of the outputs. ``replays`` counts the replays, ``capture_s`` is the
    host seconds of the capture (with its instantiation)."""

    def __init__(self, fn, device: torch.device):
        self.fn = fn
        self.device = device
        self.graph = None
        self.out = None
        self.delta = None
        self.replays = 0
        self.capture_s = None

    def __call__(self):
        if self.graph is None:
            return self._warm_up_and_capture()
        self.graph.replay()
        _add_launch_counts(self.delta)
        self.replays += 1
        return clone_outputs(self.out)

    def _warm_up_and_capture(self):
        if torch.is_anomaly_enabled():
            raise RuntimeError("autograd anomaly detection cannot be captured in a CUDA "
                               "graph: build the step with eager=True")
        s = capture_stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            out = self.fn()
        cur.wait_stream(s)
        t0 = time.perf_counter()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            self.out = self.fn()
        after = launch_counts()
        self.capture_s = time.perf_counter() - t0
        CAPTURES["count"] += 1
        CAPTURES["seconds"] += self.capture_s
        self.delta = tuple(a - b for a, b in zip(after, before))
        _add_launch_counts(tuple(-d for d in self.delta))  # the capture launched nothing
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
