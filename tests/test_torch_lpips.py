"""gsjax_torch's LPIPS against gsjax's, on the CPU: the five tapped VGG16
feature maps and the distance at full VGG16 widths with synthetic weights
(``tests/test_lpips.py:synth_params``; the real weights are gated), the
independent torch evaluator of the reference's semantics, the committed
structure-test weights loaded by both packages, the gating, and the
torch-checkpoint converter."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.eval import lpips as J
from gsjax_torch.eval import lpips as T
from test_lpips import _torch_lpips_reference, synth_params
from test_torch_densify import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRUCTURE_NPZ = os.path.join(ROOT, "evidence", "lpips_vgg_structure_test.npz")


def _carried(jparams):
    return T.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")


def _pair(rng, shape):
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    return x, y


def _torch_state_dicts(rng):
    """Random torchvision-layout VGG16 features and LPIPS head state dicts."""
    conv_layers = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    chans = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    vgg, cin = {}, 3
    for li, co in zip(conv_layers, chans):
        vgg[f"{li}.weight"] = rng.normal(0, 0.08, (co, cin, 3, 3)).astype(np.float32)
        vgg[f"{li}.bias"] = rng.normal(0, 0.02, co).astype(np.float32)
        cin = co
    lin = {f"lin{j}.model.1.weight": np.abs(rng.normal(0, 0.1, (1, c, 1, 1))).astype(np.float32)
           for j, c in enumerate([64, 128, 256, 512, 512])}
    return vgg, lin


@pytest.mark.parametrize("shape", [(32, 32, 3), (2, 48, 64, 3)], ids=["32x32", "2x48x64"])
def test_features_and_distance_match_gsjax(shape):
    """The five tapped maps and the distance against gsjax's
    ``_vgg_features`` / ``lpips``. The distance within rtol 1e-4, atol 1e-6;
    each map within 1e-4 of its largest value + 1e-6 (max |diff|): with
    these weights relu5_3 reaches ~500, and an element near 0 there is a
    cancelling sum that two float32 convolutions (XLA's, torch's) round
    apart by up to ~1e-3, so an elementwise rtol cannot hold."""
    rng = np.random.default_rng(0)
    jp = synth_params(rng)
    tp = _carried(jp)
    x, y = _pair(rng, shape)
    batch = x if x.ndim == 4 else x[None]
    jf = J._vgg_features(jnp.asarray(batch), jp)
    tf = T.VGG16Features(tp)(torch.as_tensor(batch).permute(0, 3, 1, 2))
    assert len(tf) == len(jf) == 5
    for a, b in zip(jf, tf):
        a, b = np.asarray(a), b.permute(0, 2, 3, 1).numpy()
        assert a.shape == b.shape
        err, scale = float(np.abs(b - a).max()), float(np.abs(a).max())
        assert err <= 1e-4 * scale + 1e-6, (a.shape, err, scale)
    want = np.asarray(J.lpips(jnp.asarray(x), jnp.asarray(y), jp))
    got = T.lpips(torch.as_tensor(x), torch.as_tensor(y), tp).numpy()
    assert got.shape == want.shape == shape[:-3]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert np.all(got > 0)
    same = T.lpips(torch.as_tensor(x), torch.as_tensor(x), tp)
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)


def test_matches_independent_torch_reference(tmp_path):
    """The reference's pipeline in plain torch (``_torch_lpips_reference``)
    and the port, with the same weights through ``convert_torch_state``."""
    rng = np.random.default_rng(7)
    vgg, lin = _torch_state_dicts(rng)
    out = T.convert_torch_state({k: torch.as_tensor(v) for k, v in vgg.items()},
                                {k: torch.as_tensor(v) for k, v in lin.items()},
                                str(tmp_path / "w.npz"))
    params = T.load_weights(out, device="cpu")
    x, y = _pair(rng, (64, 48, 3))
    ours = float(T.lpips(torch.as_tensor(x), torch.as_tensor(y), params))
    theirs = _torch_lpips_reference(vgg, lin, x, y)
    assert ours == pytest.approx(theirs, rel=1e-4, abs=1e-6)


def test_structure_npz_loads_alike_in_both_packages():
    """The committed f16 structure-test weights (full VGG16 shapes): both
    loaders cast to f32, and the distances agree."""
    jp = J.load_weights(STRUCTURE_NPZ)
    tp = T.load_weights(STRUCTURE_NPZ, device="cpu")
    assert set(tp) == set(jp)
    for k, v in tp.items():
        assert v.dtype == torch.float32
        want = np.asarray(jp[k])
        if k.endswith("_w"):
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(v.numpy(), want)
    rng = np.random.default_rng(3)
    x, y = _pair(rng, (32, 32, 3))
    want = float(J.lpips(jnp.asarray(x), jnp.asarray(y), jp))
    got = float(T.lpips(torch.as_tensor(x), torch.as_tensor(y), tp))
    assert got == pytest.approx(want, rel=1e-4, abs=1e-6)


def test_gated_without_weights(tmp_path, monkeypatch):
    missing = str(tmp_path / "missing.npz")
    monkeypatch.setenv("GSJAX_LPIPS_WEIGHTS", missing)
    assert T.default_weight_path() == missing
    assert not T.available()
    with pytest.raises(FileNotFoundError, match="LPIPS weights not found at"):
        T.load_weights(device="cpu")
    with pytest.raises(FileNotFoundError, match="LPIPS weights not found at"):
        T.lpips(torch.zeros(8, 8, 3), torch.zeros(8, 8, 3))
    monkeypatch.delenv("GSJAX_LPIPS_WEIGHTS")
    assert T.default_weight_path() == os.path.expanduser("~/.cache/gsjax/lpips_vgg.npz")
    # the argument comes first
    assert T.available(STRUCTURE_NPZ)


def test_convert_torch_state_matches_gsjax(tmp_path):
    """The same npz arrays as gsjax's converter from the same random state
    dicts (numpy and torch tensors alike), so either package loads it."""
    rng = np.random.default_rng(1)
    vgg, lin = _torch_state_dicts(rng)
    lin = {k.replace("lin", "lin."): v for k, v in lin.items()}  # the lpipsPyTorch keys
    want = J.convert_torch_state(vgg, lin, str(tmp_path / "j" / "w.npz"))
    got_np = T.convert_torch_state(vgg, lin, str(tmp_path / "t" / "w.npz"))
    got_t = T.convert_torch_state({k: torch.as_tensor(v) for k, v in vgg.items()},
                                  {k: torch.as_tensor(v) for k, v in lin.items()},
                                  str(tmp_path / "tt" / "w.npz"))
    with np.load(want) as w, np.load(got_np) as g, np.load(got_t) as gt:
        assert sorted(w.files) == sorted(g.files) == sorted(gt.files)
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(gt[k], w[k])
    with pytest.raises(KeyError, match="no linear head"):
        T.convert_torch_state(vgg, {}, str(tmp_path / "bad.npz"))


def test_tf32_is_off():
    """LPIPS runs with TF32 off: the package sets both flags on import
    (TF32 would move the distance in its third decimal)."""
    import gsjax_torch  # noqa: F401

    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
