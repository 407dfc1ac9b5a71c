"""The speed-of-light probe's occupancy instances and the exps' pricing,
on the CPU.

``csrc/sol_probe.cu`` compiles every swept (k_ops, k_exp) pair at 8, 24
and 48 resident warps per SM; the wrapper refuses anything else on every
device, before it takes the plain version. ``profiling.sol_probe_work``
counts the probe's exps and ``profiling.bound_ms`` prices them at the
special-function units' rate (``PEAK_EXP_PER_S``) beside the bytes and the
float32 operations; the forward and backward kernels' work counts carry
their exps too. The card tests (``tests/test_torch_cuda.py``) hold every
instance against the plain version. Imports no JAX:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_probe_occupancy.py
"""

import itertools
import os
import re

import numpy as np
import pytest
import torch

from gsjax_torch.ops import cuda_composite as cc
from gsjax_torch.ops import cuda_probe as cp
from gsjax_torch.utils import profiling as prof
from test_torch_bwd_counts import _case
from test_torch_fwd_work import _frame, direct_fwd_counts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per-tile pair counts (as tests/test_torch_probes.py): windows of 0, 1, 1,
# 1, 2, 2, 2 and 3 chunks
COUNTS = (0, 5, 0, 1, 127, 128, 130, 300)
CHUNKS = 12
# bench1080's probe: 34,180 started chunks (0.1509 ms x 67e12 / 9 / 32,768)
BENCH_CHUNKS = 34_180


def _tile_start(counts=COUNTS):
    return torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)


@pytest.fixture(scope="module")
def probe_inputs():
    ts = _tile_start()
    return ts, cp.sol_probe_inputs(ts, seed=3)


@pytest.mark.parametrize("k", cp.SWEPT, ids=lambda k: f"k{k[0]}e{k[1]}")
def test_probe_work_counts_exps(k):
    bytes_, ops, elements, exps = prof.sol_probe_work(_tile_start(), *k)
    assert elements == CHUNKS * 256 * 128
    assert exps == elements * k[1]
    assert ops == elements * (1 + 2 * k[0] + 3 * k[1])
    assert bytes_ == CHUNKS * 512 + (len(COUNTS) + 1) * 4 + len(COUNTS) * 256 * 4


@pytest.mark.parametrize("k,by", [((4, 0), "operations"), ((40, 0), "operations"),
                                  ((20, 0), "operations"), ((20, 5), "exps"),
                                  ((20, 10), "exps")], ids=lambda v: str(v))
def test_bound_prices_exps_at_the_mufu_rate(k, by):
    """At bench1080's chunk count the MUFU term bounds the exp pairs and
    leaves the others' bounds as they were: (20, 5) about 1.34 ms and
    (20, 10) about 2.69 ms, against 0.94 and 1.19 ms by operations."""
    assert prof.PEAK_EXP_PER_S == 132 * 16 * 1.98e9
    counts = np.full(BENCH_CHUNKS, 128)  # one chunk a tile
    bytes_, ops, elements, exps = prof.sol_probe_work(_tile_start(counts), *k)
    assert elements == BENCH_CHUNKS * 256 * 128
    ms, got_by = prof.bound_ms(bytes_, ops, exps)
    assert got_by == by
    assert ms == max(bytes_ / prof.PEAK_BYTES_PER_S, ops / prof.PEAK_F32_PER_S,
                     exps / prof.PEAK_EXP_PER_S) * 1e3
    assert prof.bound_ms(bytes_, ops) == (ops / prof.PEAK_F32_PER_S * 1e3, "operations")
    if by == "exps":
        assert ms == pytest.approx({5: 1.34, 10: 2.68}[k[1]], rel=0.01)
        assert ms > prof.bound_ms(bytes_, ops)[0]


def test_bound_ms_terms():
    ms, by = prof.bound_ms(0, 0, prof.PEAK_EXP_PER_S * 1e-3)
    assert by == "exps" and ms == pytest.approx(1.0, rel=1e-12)
    assert prof.bound_ms(3.35e9, 67e9, 1) == (1.0, "bytes")  # the first of equal terms
    assert prof.bound_ms(0, 67e9, prof.PEAK_EXP_PER_S * 1e-3 / 2) == (1.0, "operations")


@pytest.mark.parametrize("warps", cp.OCCUPANCIES)
def test_probe_wrapper_on_cpu_at_each_occupancy(probe_inputs, warps):
    tile_start, table = probe_inputs
    for k in cp.SWEPT:
        assert torch.equal(cp.sol_probe(tile_start, table, *k, warps_per_sm=warps),
                           cp.sol_probe_plain(tile_start, table, *k))
    coefs = cp.check_exp_coefs(20)
    assert torch.equal(cp.sol_probe(tile_start, table, 20, 5, coefs, warps_per_sm=warps),
                       cp.sol_probe_plain(tile_start, table, 20, 5, coefs))


def test_probe_refuses_missing_instances_before_the_plain_path(probe_inputs, monkeypatch):
    tile_start, table = probe_inputs

    def plain(*a, **k):
        raise AssertionError("the plain version ran for an instance that does not exist")

    monkeypatch.setattr(cp, "sol_probe_plain", plain)
    for k, warps in [((4, 0), 16), ((4, 0), 32), ((20, 10), 64), ((40, 0), 0),
                     ((8, 0), 24), ((20, 2), 48)]:
        with pytest.raises(ValueError, match="no kernel instance"):
            cp.sol_probe(tile_start, table, *k, warps_per_sm=warps)
        with pytest.raises(ValueError, match="no kernel instance"):
            cp.sol_probe_info(*k, warps)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cp.sol_probe_info(4, 0, 24)


def _body(src, name):
    """The text of the C++ function ``name`` in ``src``, braces matched."""
    i = src.index("{", re.search(rf"\bint {name}\(", src).end())
    depth = 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i:j + 1]
    raise AssertionError(f"{name}: unbalanced braces")


def test_dispatch_lists_every_instance():
    """``csrc/sol_probe.cu``'s dispatch: exactly the swept pairs at 8, 24
    and 48 warps per SM; each exp pair with its timed and its checking
    instance, each other pair with the timed one only."""
    with open(os.path.join(ROOT, "gsjax_torch", "csrc", "sol_probe.cu")) as f:
        src = f.read()
    pairs = [(int(a), int(b)) for a, b in
             re.findall(r"k_ops == (\d+) && k_exp == (\d+)", _body(src, "with_pair"))]
    warps = [int(a) for a, b in re.findall(r"case (\d+): return with_pair<(\d+)>",
                                           _body(src, "with_instance")) if a == b]
    assert sorted(pairs) == sorted(cp.SWEPT) and sorted(warps) == list(cp.OCCUPANCIES)
    assert set(itertools.product(pairs, warps)) == set(itertools.product(cp.SWEPT,
                                                                         cp.OCCUPANCIES))
    inst = re.findall(r"Instance<(\d+), (\d+), (true|false), WARPS>", _body(src, "with_pair"))
    want = {(k, e, "true") for k, e in cp.SWEPT} | {(k, e, "false") for k, e in cp.SWEPT if e}
    assert {(int(k), int(e), p) for k, e, p in inst} == want
    assert re.search(r"static_assert\(WARPS == 8 \|\| WARPS == 24 \|\| WARPS == 48", src)


@pytest.mark.parametrize("name", ["sparse", "saturating"])
def test_forward_exps_count_the_tested_pixels(name):
    """``fwd_work``'s exps: one per pixel of each (pair, warp) step the
    per-warp cull leaves, from the direct numpy walk; priced, they stay
    under the frame's operations term."""
    args = _frame(name)
    want = direct_fwd_counts(*args)[2]
    work = prof.fwd_work(*args)
    assert work["exps"] == 32 * want["steps_walked"] > 0
    walk = prof.composite_work(args[1], args[2], args[3], args[4], 32 * work["steps_walked"],
                               work["blends"])["composite_fwd"]
    assert work["exps"] / prof.PEAK_EXP_PER_S < walk[1] / prof.PEAK_F32_PER_S
    assert prof.bound_ms(*walk, work["exps"]) == prof.bound_ms(*walk)


def test_backward_exps_count_the_contributions():
    bwd = _case("saturating")
    _, n_live, stats = cc.composite_bwd_plain(*bwd, return_evals=True)
    w = prof.bwd_work(stats)
    assert w["exps"] == stats["contrib"] == int(n_live.sum()) > 0
