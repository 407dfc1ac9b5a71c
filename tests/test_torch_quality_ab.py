"""The two quality A/Bs of the port on the CPU, at a tiny size:
``python -m gsjax_torch.drop_ab`` on the 64x64 fixture scene resumed from a
checkpoint, and ``python -m gsjax_torch.densify_grad_ab`` on a 64x64
synthetic scene, each arm 5 or 12 iterations. Their reports have the keys of
gsjax's (the committed ``evidence/quality`` reports of
``scripts/drop_ab.py`` and ``scripts/densify_grad_ab.py``) and finite
scores. A pair budget on the CPU is at least 65,536 pairs (the probe's
alignment), which no 64x64 frame fills, so the drops themselves show only
at full size (chip_smoke.py phase 14)."""

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# TensorFlow, where installed, is what TensorBoard's writer imports first
# (seconds a process); the trainer logs through TensorBoard's own stub
# without it
NO_TF = "import sys\nsys.modules['tensorflow'] = None\n"


def _env(tmp_path):
    site = tmp_path / "site"
    site.mkdir(exist_ok=True)
    (site / "sitecustomize.py").write_text(NO_TF)
    return {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": f"{site}{os.pathsep}{ROOT}"}


def _keys(d, depth=3):
    """The nested key structure of a report, to ``depth`` levels."""
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


def _run(args, env):
    res = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return res.stdout


def test_drop_ab_report_has_gsjax_keys(tmp_path):
    from fixtures import make_blender_scene

    scene, model = str(tmp_path / "scene"), str(tmp_path / "model")
    make_blender_scene(scene, n_train=4, n_test=2, width=64, height=64)
    _run(["gsjax_torch.train", "-s", scene, "-m", model, "--eval", "--iterations", "5",
          "--checkpoint_iterations", "5", "--test_iterations", "5", "--save_iterations", "5",
          "--quiet", "--disable_viewer", "--device", "cpu"], _env(tmp_path))
    out = str(tmp_path / "drop_ab.json")
    _run(["gsjax_torch.drop_ab", "-s", scene, "-m", model, "--from_iter", "5",
          "--to_iter", "10", "--mult", "2", "--mult_baseline", "0.55", "--out", out,
          "--device", "cpu"], _env(tmp_path))
    with open(out) as f:
        got = json.load(f)
    with open(os.path.join(ROOT, "evidence", "quality", "garden_growth2", "drop_ab.json")) as f:
        want = json.load(f)
    want.pop("note")  # a hand-written remark beside the script's report
    assert _keys(got, 2) == _keys(want, 2)
    for arm in ("baseline", "big_budget"):
        a, w = got["arms"][arm], want["arms"][arm]
        assert set(a) == set(w)
        psnr = a["results"]["ours_10"]["PSNR"]
        assert np.isfinite(psnr) and psnr > 0
        assert a["mean_dropped_pairs"] == a["max_dropped_pairs"] == 0
        assert os.path.exists(os.path.join(model + f"_dropab_{arm}", "chkpnt5.npz")) is False
    assert got["psnr_cost_of_drops"] == round(
        got["arms"]["big_budget"]["results"]["ours_10"]["PSNR"]
        - got["arms"]["baseline"]["results"]["ours_10"]["PSNR"], 4)
    assert (got["from_iter"], got["to_iter"], got["mult"], got["mult_baseline"]) == (
        5, 10, 2.0, 0.55)


def test_densify_grad_ab_report_has_gsjax_keys(tmp_path):
    out = str(tmp_path / "densify_grad_ab.json")
    _run(["gsjax_torch.densify_grad_ab", "--scene", str(tmp_path / "synth"), "--width", "64",
          "--height", "64", "--n_views", "6", "--n_gauss", "2000", "--n_sparse", "300",
          "--iterations", "12", "--densify_from_iter", "3", "--densification_interval", "4",
          "--densify_until_iter", "10", "--model_root", str(tmp_path / "models"), "--out", out,
          "--device", "cpu"], _env(tmp_path))
    with open(out) as f:
        got = json.load(f)
    with open(os.path.join(ROOT, "evidence", "quality", "densify_grad_ab.json")) as f:
        want = json.load(f)
    assert _keys(got) == _keys(want)
    assert got["device"] == "cpu" and got["iterations"] == 12
    for mode in ("apply", "discard"):
        r = got["results"][mode]
        assert all(np.isfinite(r["report"][s]["psnr"]) for s in ("test", "train"))
        assert r["final_gaussians"] > 0
    # discarding the densify steps' update changes the trained state
    assert got["results"]["apply"]["report"] != got["results"]["discard"]["report"]
