"""The harness end to end on the CPU at a tiny size: the program's plain
path against the reference, under the committed limits; and the same run
with the timed path broken underneath, which must come out not correct."""

import pytest
import torch

from gsbench.tests import tiny


@pytest.mark.parametrize("kind", ["train", "view"])
def test_sound_run_is_correct(kind):
    out = tiny.run(kind)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    names = set(out["metrics"])
    want = {"train": {"train_step_ms", "setup_s"},
            "view": {"frame_ms", "frame_p95_ms", "setup_s"}}[kind]
    assert names == want


def _frozen_adam(monkeypatch):
    from gsjax_torch.train import optim

    monkeypatch.setattr(optim.GaussianAdam, "update", lambda self, row, names=None: None)


def _half_batch(monkeypatch):
    from gsjax_torch.train import step

    full_l1, full_ssim = step.l1_loss, step.ssim

    def half(fn):
        return lambda a, b: fn(a[: a.shape[0] // 2], b[: b.shape[0] // 2])

    monkeypatch.setattr(step, "l1_loss", half(full_l1))
    monkeypatch.setattr(step, "ssim", half(full_ssim))


def _altered_render(monkeypatch):
    from gsjax_torch.ops import rasterize

    full = rasterize.assemble_image

    def altered(*a, **k):
        img, t = full(*a, **k)
        return torch.cat([img[:16] * 0.5, img[16:]]), t

    monkeypatch.setattr(rasterize, "assemble_image", altered)


@pytest.mark.parametrize("fault", [_frozen_adam, _half_batch, _altered_render],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_train_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = tiny.run("train")
    assert not out["correct"], out["checks"]


def _altered_frame(monkeypatch):
    from gsjax_torch.train import step

    full = step.quantize

    def altered(img):
        q = full(img).clone()
        q[:16, :16] = 0
        return q

    monkeypatch.setattr(step, "quantize", altered)


def _stale_frame(monkeypatch):
    from gsjax_torch.train import step

    full = step.make_render_fn

    def stale(*a, **k):
        fn = full(*a, **k)
        first = {}

        def wrapped(state, camera, bg, *r, **kw):
            out = fn(state, camera, bg, *r, **kw)
            return first.setdefault("frame", out)

        return wrapped

    monkeypatch.setattr(step, "make_render_fn", stale)


@pytest.mark.parametrize("fault", [_altered_frame, _stale_frame],
                         ids=["answer_altered", "stale_frame"])
def test_view_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = tiny.run("view")
    assert not out["correct"], out["checks"]


def test_trace_run_reports_per_layer_metrics_only():
    out = tiny.run("train", trace=True)
    assert out["correct"]
    assert "train_step_ms" not in out["metrics"]
