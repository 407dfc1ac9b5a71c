"""gsjax_torch.synthetic_scene against scripts/make_synthetic_scene.py, on
the CPU at a small size: the same GT model, cameras and COLMAP files, and
GT images that agree to the uint8 level."""

import os

import numpy as np

from test_torch_densify import one_torch_thread  # noqa: F401


def test_synthetic_scene_matches_the_script(tmp_path):
    import sys

    from PIL import Image

    from gsjax_torch import synthetic_scene

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "scripts"))
    try:
        import make_synthetic_scene as script
    finally:
        sys.path.remove(os.path.join(root, "scripts"))

    args = ["--n_gauss", "6000", "--n_views", "2", "--width", "64", "--height", "48",
            "--n_sparse", "500", "--seed", "2", "--structure_amp", "0.3", "--hf_amp", "0.1"]
    script.main([str(tmp_path / "j")] + args + ["--platform", "cpu"])
    synthetic_scene.main([str(tmp_path / "t")] + args + ["--device", "cpu"])

    # the numpy parts, draw for draw
    want = script.build_gt_model(6000, 2, hf_amp=0.1, structure_amp=0.3)
    got = synthetic_scene.build_gt_model(6000, 2, hf_amp=0.1, structure_amp=0.3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        path = os.path.join("sparse", "0", name)
        assert (tmp_path / "t" / path).read_bytes() == (tmp_path / "j" / path).read_bytes(), name
    names = sorted(os.listdir(tmp_path / "j" / "images"))
    assert names == sorted(os.listdir(tmp_path / "t" / "images")) and len(names) == 2
    for name in names:
        a = np.asarray(Image.open(tmp_path / "t" / "images" / name), np.int16)
        b = np.asarray(Image.open(tmp_path / "j" / "images" / name), np.int16)
        assert a.shape == b.shape == (48, 64, 3)
        # the port renders the GT through its model state (exp of log scales,
        # sigmoid of logit opacities) with another scan: a value on a uint8
        # step can floor to its neighbour
        d = np.abs(a - b)
        assert d.max() <= 1 and (d > 0).mean() <= 0.02, (name, d.max(), (d > 0).mean())
        assert b.mean() > 20  # the views see the scene
