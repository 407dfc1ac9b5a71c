"""``preprocess``'s dispatch where no card is: every CPU call, with or
without autograd, is the plain version bit for bit and launches nothing;
a graph's replay counts the kernel's launch; and the kernels' C entries
agree with the ctypes signatures that load them. The kernel against the plain version
on the card: ``tests/test_torch_cuda.py``.

Imports neither JAX nor gsjax:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_preprocess.py
"""

import ctypes
import os
import re

import pytest
import torch

from gsjax_torch.ops import kernels, projection
from gsjax_torch.utils import profiling

from test_torch_cuda import PREP_CASES, _prep_inputs
from test_torch_kernels import assert_replays_count, fake_card  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_CASES = ("deg3", "deg1_k5", "scale_modifier", "cov3d", "colors", "offset", "no_mask",
             "sigma3_radius")


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "autograd"])
@pytest.mark.parametrize("case", CPU_CASES)
def test_preprocess_on_cpu_is_the_plain_version(case, grad):
    assert case in PREP_CASES
    args, cam, deg, kw = _prep_inputs(case, "cpu", n=3000)
    if grad:
        for t in args[:4]:
            t.requires_grad_(True)
    before = profiling.launches()
    with torch.set_grad_enabled(grad):
        got = projection.preprocess(*args, cam, deg, **kw)
        want = projection.preprocess_plain(*args, cam, deg, **kw)
    assert profiling.launches() == before
    for f, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), f
    assert got.means2d.requires_grad == grad
    if grad:
        got.means2d.sum().backward()
        assert args[0].grad is not None


def test_preprocess_infer_refuses_cpu_tensors():
    args, cam, deg, kw = _prep_inputs("deg3", "cpu", n=64)
    before = profiling.launches()
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        projection.preprocess_infer(*args, cam, deg, **kw)
    assert profiling.launches() == before


def test_graph_replays_count_preprocess_launches(fake_card):
    """A graphed frame's preprocess launch counts at its warm-up and at each
    replay, not at the capture."""
    assert_replays_count("preprocess_infer", open_call=True)
    assert "gsjax_preprocess_infer" in kernels.SOURCES["preprocess_infer.cu"]


def test_only_the_preprocess_kernel_is_built_without_contraction():
    assert kernels.SOURCE_FLAGS == {"preprocess_infer.cu": ("-fmad=false",)}
    assert "preprocess_infer.cu" in kernels.SOURCES
    assert ("-fmad=false" not in kernels.NVCC_FLAGS
            and "--use_fast_math" not in kernels.NVCC_FLAGS)


_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float,
            "float*": ctypes.POINTER(ctypes.c_float), "int*": ctypes.POINTER(ctypes.c_int)}


def _c_signature(source, name):
    """The parameter types of ``extern "C" int <name>(...)`` in ``csrc/<source>``."""
    with open(os.path.join(ROOT, "gsjax_torch", "csrc", source)) as f:
        text = f.read()
    m = re.search(r'extern "C" int ' + name + r"\s*\(([^)]*)\)", text)
    assert m, (source, name)
    types = []
    for param in m.group(1).split(","):
        words = param.replace("const ", "").replace("*", " * ").split()
        types.append(words[0] + "*" * words.count("*"))
    return types


@pytest.mark.parametrize("source,name",
                         [(s, n) for s, fns in kernels.SOURCES.items() for n in fns])
def test_ctypes_signatures_match_the_c_entries(source, name):
    want = kernels.SOURCES[source][name]
    got = [_C_TYPES[t] for t in _c_signature(source, name)]
    assert got == want, (name, _c_signature(source, name))
