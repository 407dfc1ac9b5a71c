"""The control (the reference in bfloat16, in the program's place) and the
planted faults fail the committed limits, at a tiny size on the CPU; on
the card the same readings are taken at the cells' own sizes
(``python -m gsbench.control``)."""

import pytest
import torch

from gsbench import control, harness
from gsbench.reference import compare
from gsbench.tests import tiny


def _run(kind, workload):
    torch.set_num_threads(2)
    limits = harness.load_json("limits", f"{workload}.json")
    r = harness.Run(tiny.bench(), workload, 31, 0, False, "cpu", limits=limits,
                    config=tiny.config(), traffic=tiny.traffic(kind))
    return r, limits


@pytest.mark.parametrize("fault", ["bf16", "half_image", "frozen"])
def test_train_control_fails(fault):
    r, limits = _run("train", "bench1080.train")
    ok, rows = compare.judge(control.train_readings(r, fault), limits)
    assert not ok, rows


@pytest.mark.parametrize("fault", ["bf16", "tile_zero"])
def test_view_control_fails(fault):
    r, limits = _run("view", "bench1080.view")
    ok, rows = compare.judge(control.view_readings(r, fault), limits)
    assert not ok, rows


@pytest.mark.cuda
def test_card_run_is_correct(card):
    """A short run of a tiny cell on the card: the kernels' path."""
    r = harness.Run(tiny.bench(), "bench1080.train", 5, 0.5, False, "cuda",
                    config=tiny.config(), traffic=tiny.traffic("train"))
    out = r.run()
    assert out["correct"], out["checks"]
