"""``gsjax_torch.ops.kernels``: every launch goes through ``launch``, which
counts it in the registry of ``utils.profiling``; a launch recorded into a
CUDA graph counts at each replay, not at the capture. The card, the kernel
library and the graph are fakes here (``fake_card``), so this runs on the
CPU; the real ones: ``tests/test_torch_cuda.py``.

Imports neither JAX nor gsjax:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_kernels.py
"""

import ast
import contextlib
import os
import types

import pytest
import torch

from gsjax_torch.ops import kernels
from gsjax_torch.utils import graphs, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeStream:
    cuda_stream = 0

    def wait_stream(self, other):
        pass


class _FakeGraph:
    """A CUDA graph that records nothing: its replay launches nothing."""

    def replay(self):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    """A registry of its own, a kernel library whose C entries append
    ``(entry, args)`` to the returned ``calls`` and return ``calls.rc``,
    and the CUDA stream and graph calls ``launch`` and ``graphs.Graph``
    make, as fakes."""
    calls = types.SimpleNamespace(log=[], rc=0)

    def entry(name):
        def fn(*args):
            calls.log.append((name, args))
            return calls.rc
        return fn

    lib = types.SimpleNamespace(**{name: entry(name) for fns in kernels.SOURCES.values()
                                   for name in fns})
    monkeypatch.setattr(profiling, "REGISTRY", profiling.Registry())
    monkeypatch.setattr(kernels, "load_library", lambda verbose=False: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", lambda g, stream=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(graphs, "capture_stream", lambda device: _FakeStream())
    monkeypatch.setattr(profiling, "_current_stream", lambda: None)
    return calls


def graphed_launch(name):
    """A ``graphs.Graph`` of one launch of kernel ``name`` (no tensor
    arguments: nothing needs a card)."""
    def fn():
        kernels.launch(name, 7, 3)
        return torch.zeros(1)
    return graphs.Graph(fn, torch.device("cuda", 0))


def assert_replays_count(name, open_call: bool):
    """Graph ``name``'s launch and call it 4 times: the first call's eager
    warm-up counts once and its capture nothing, each of the 3 replays
    once, with a dispatch open around each call or none."""
    g = graphed_launch(name)
    seen = []
    for i in range(4):
        with (profiling.REGISTRY.call("dispatch", "train", 1) if open_call
              else contextlib.nullcontext()) as c:
            if c is not None:
                c.take("capture" if i == 0 else "graph")
            g()
        seen.append(profiling.launches().get(name, 0))
    assert seen == [1, 2, 3, 4]
    assert g.kernels == {name: 1}


def test_an_eager_launch_counts_once(fake_card):
    kernels.launch("composite_infer", 5, None, 2.5)
    assert fake_card.log == [("gsjax_composite_infer", (5, None, 2.5, 0))]
    assert profiling.launches() == {"composite_infer": 1}
    assert profiling.records()["launches"] == {"composite_infer": 1}


@pytest.mark.parametrize("open_call", [False, True], ids=["no_call", "open_call"])
def test_a_captured_launch_counts_at_each_replay(fake_card, open_call):
    assert_replays_count("composite_fwd", open_call)
    # the capture called the C entry; the replays are the graph's
    assert [n for n, _ in fake_card.log] == ["gsjax_composite_fwd"] * 2


def test_a_launch_inside_capturing_counts_nothing_until_a_replay(fake_card):
    reg = profiling.REGISTRY
    with reg.capturing() as (_, _, captured):
        kernels.launch("composite_bwd", 1)
        profiling.launched("composite_bwd_bf16")
    assert profiling.launches() == {}
    assert captured == {"composite_bwd": 1, "composite_bwd_bf16": 1}
    reg.replayed(captured)
    reg.replayed(captured)
    assert profiling.launches() == {"composite_bwd": 2, "composite_bwd_bf16": 2}


def test_traced_and_untraced_launches_sum(fake_card, monkeypatch):
    kernels.launch("sol_probe", 1)
    monkeypatch.setattr(profiling, "profiler_on", lambda: True)
    kernels.launch("sol_probe", 1)
    rec = profiling.records()
    assert profiling.launches() == rec["launches"] == {"sol_probe": 2}
    assert profiling.launches_since({"sol_probe": 1}, ("sol_probe", "composite_fwd")) == {
        "sol_probe": 1, "composite_fwd": 0}
    profiling.REGISTRY.reset()
    assert profiling.launches() == {}


def test_launch_refuses_a_cpu_tensor_and_counts_nothing(fake_card):
    with pytest.raises(RuntimeError, match="composite_fwd runs on CUDA or CPU tensors, not cpu"):
        kernels.launch("composite_fwd", torch.zeros(3), 4)
    assert fake_card.log == [] and profiling.launches() == {}


def test_a_failed_launch_raises_and_counts_nothing(fake_card):
    fake_card.rc = 700
    with pytest.raises(RuntimeError, match="preprocess_bwd launch failed: CUDA error 700"):
        kernels.launch("preprocess_bwd", 1)
    assert profiling.launches() == {}


def _imports(path):
    """Every module a file imports from, function-level imports included."""
    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            module = "." * node.level + (node.module or "")
            found += [module] + [f"{module}.{a.name}" for a in node.names]
    return found


@pytest.mark.parametrize("path", ["gsjax_torch/utils/graphs.py", "gsjax_torch/ops/kernels.py"])
def test_the_library_and_the_graphs_import_nothing_from_ops(path):
    got = _imports(path)
    assert "gsjax_torch.utils.profiling" in got  # the scan sees the imports
    assert [m for m in got if m.startswith(("gsjax_torch.ops", "."))] == []


def test_projection_imports_nothing_from_cuda_composite():
    got = _imports("gsjax_torch/ops/projection.py")
    assert "gsjax_torch.ops.kernels" in got
    assert [m for m in got if "cuda_composite" in m] == []
