"""``gsjax_torch.ab_smoke``: the numbers it reads from a chip_smoke.py log,
and a run of a stand-in tree. Imports neither JAX nor torch."""

import json
import os

import pytest

from gsjax_torch import ab_smoke

LOG = """\
phase 1: card NVIDIA H100 80GB HBM3, 700.00 W
composite_fwd.cu:
ptxas info    : Compiling entry function '_ZN5gsjax22composite_blend_kernelILb1ELb0EEEvPKiS2_PK6float4PfS6_Pii' for 'sm_90a'
ptxas info    : Function properties for _ZN5gsjax22composite_blend_kernelILb1ELb0EEEvPKiS2_PK6float4PfS6_Pii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers, 6144 bytes smem
ptxas info    : Compiling entry function '_ZN5gsjax22composite_blend_kernelILb1ELb1EEEvPKiS2_PK6float4PfS6_Pii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 8192 bytes smem
composite_bwd.cu:
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__94bb_20composite_bwd_kernelILb1ELb0EEEvPKiS2_PK6float4PKfS7_S7_S2_PfPii' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 79 registers, used 1 barriers, 28164 bytes smem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__94bb_20composite_bwd_kernelILb0ELb1EEEvPKiS2_PK6float4PKfS7_S7_S2_PfPii' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 26116 bytes smem
sol_probe.cu:
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__b2_16sol_probe_kernelILi20ELi10ELb1EEEvPKiPKfiNS_7ExpCoefEPf' for 'sm_90a'
ptxas info    : Used 254 registers, used 1 barriers, 512 bytes smem
  frame ms (CUDA events, n=40): median 9.514, p75 10.445, min 9.239, max 18.166; fps 105.11
  composite_fwd 1.261 ms (plain 1264.1); composite_bwd 2.288 ms (plain 995.1); reduction 1.031 ms
  step ms (CUDA events, n=24): median 44.266, p75 45.973, min 41.489, max 324.832; host wall 56.322
  one step's phases, ms: preprocess+binning 11.473, forward kernel 1.496, backward kernel 2.395, Adam 3.196; sum 46.913
  trace of 4 steps: device busy 148.419 ms of a 265.746 ms window, busy share 0.5585
total 86.3 s
{"kernels": [{"name": "composite_infer", "ms": 0.702}, {"name": "composite_fwd", "ms": 0.711}, {"name": "composite_bwd", "ms": 2.288}, {"name": "sol_probe", "ms": 0.33}]}
card: NVIDIA H100 80GB HBM3, 700.00 W
{"ok": true, "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
"""


def test_parse_log_reads_every_number():
    got = ab_smoke.parse_log(LOG)
    assert got["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert got["composite_bwd_ms"] == 2.288
    assert (got["frame_median_ms"], got["frame_p75_ms"]) == (9.514, 10.445)
    assert (got["step_median_ms"], got["step_p75_ms"]) == (44.266, 45.973)
    assert (got["busy_ms"], got["window_ms"], got["busy_share"]) == (148.419, 265.746, 0.5585)
    assert got["split"] == {"preprocess+binning": 11.473, "forward kernel": 1.496,
                            "backward kernel": 2.395, "Adam": 3.196}
    assert got["total_s"] == 86.3
    assert got["kernels_ms"] == {"composite_infer": 0.702, "composite_fwd": 0.711,
                                 "composite_bwd": 2.288, "sol_probe": 0.33}
    assert (got["composite_infer_ms"], got["composite_fwd_ms"]) == (0.702, 0.711)
    # the backward's instances only, by their template arguments
    assert got["bwd_instances"] == {
        "composite_bwd_kernelILb1ELb0E": {"registers": 79, "smem_bytes": 28164,
                                          "spill_bytes": 0},
        "composite_bwd_kernelILb0ELb1E": {"registers": 72, "smem_bytes": 26116,
                                          "spill_bytes": 12},
    }
    # and the forward's (composite_blend_kernel<kNcon, kCull>)
    assert got["fwd_instances"] == {
        "composite_blend_kernelILb1ELb0E": {"registers": 38, "smem_bytes": 6144,
                                            "spill_bytes": 0},
        "composite_blend_kernelILb1ELb1E": {"registers": 40, "smem_bytes": 8192,
                                            "spill_bytes": 0},
    }


def test_parse_log_of_a_failed_run_has_no_numbers():
    assert ab_smoke.parse_log("Traceback (most recent call last):\nAssertionError\n") == {}


def _stand_in(root, bwd_ms, rc):
    root.mkdir()
    (root / "chip_smoke.py").write_text(
        f"import sys\nprint('  composite_bwd {bwd_ms} ms (plain 997.6); x')\n"
        f"print('card: stub, 1 W')\nsys.exit({rc})\n")


@pytest.mark.parametrize("rc", [0, 3])
def test_runs_two_trees_in_turns(tmp_path, capsys, monkeypatch, rc):
    """Stand-ins for both trees (this checkout's root is ``HERE``): A, B,
    B, A, each run's log in the logs directory."""
    _stand_in(tmp_path / "a", 3.338, rc)
    _stand_in(tmp_path / "b", 2.288, 0)
    monkeypatch.setattr(ab_smoke, "HERE", str(tmp_path / "b"))
    code = ab_smoke.main([str(tmp_path / "a"), "--logs", str(tmp_path / "logs")])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert code == (1 if rc else 0)
    assert [r["tree"] for r in lines[:4]] == list("ABBA")
    for r in lines[:4]:
        want = (rc, 3.338) if r["tree"] == "A" else (0, 2.288)
        assert (r["rc"], r["composite_bwd_ms"]) == want and r["card"] == "stub, 1 W"
        assert r["log"] == str(tmp_path / "logs" / f"{r['run']}_{r['tree']}.log")
        assert os.path.isfile(r["log"])
    assert lines[4] == {"ab": "done", "failed": [0, 3] if rc else []}


def test_b_puts_another_tree_in_bs_place(tmp_path, capsys, monkeypatch):
    """``--b TREE``: two older trees against each other, A, B, B, A, and
    this checkout runs in neither."""
    _stand_in(tmp_path / "a", 3.338, 0)
    _stand_in(tmp_path / "b", 2.288, 0)
    _stand_in(tmp_path / "here", 9.999, 0)
    monkeypatch.setattr(ab_smoke, "HERE", str(tmp_path / "here"))
    assert ab_smoke.main([str(tmp_path / "a"), "--b", str(tmp_path / "b"), "--logs",
                          str(tmp_path / "logs")]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [r["tree"] for r in lines[:4]] == list("ABBA")
    for r in lines[:4]:
        assert r["root"] == str(tmp_path / ("a" if r["tree"] == "A" else "b"))
        assert r["composite_bwd_ms"] == (3.338 if r["tree"] == "A" else 2.288)
    assert lines[4] == {"ab": "done", "failed": []}


def test_refuses_a_tree_without_chip_smoke(tmp_path):
    assert ab_smoke.main([str(tmp_path)]) == 2
