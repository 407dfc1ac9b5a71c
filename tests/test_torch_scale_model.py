"""``python -m gsjax_torch.scale_model`` against gsjax's
``scripts/scale_model.py`` on the CPU: the same 50-gaussian model, seed and
target through both (each as a subprocess) write PLYs equal array for array
and the same ``scale_meta.json`` but for its ``src``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(path, n=50, it=7):
    """A trained-looking model directory: ``n`` gaussians with random
    parameters, cfg_args and cameras.json."""
    from gsjax_torch.models.gaussians import save_gaussian_ply, state_from_numpy

    rng = np.random.default_rng(4)
    params = {
        "xyz": rng.normal(0, 1, (n, 3)), "features_dc": rng.normal(0, 0.5, (n, 1, 3)),
        "features_rest": rng.normal(0, 0.1, (n, 15, 3)), "scaling": rng.normal(-3, 0.5, (n, 3)),
        "rotation": rng.normal(0, 1, (n, 4)), "opacity": rng.normal(0, 2, (n, 1)),
    }
    state = state_from_numpy({k: v.astype(np.float32) for k, v in params.items()},
                             np.ones(n, bool), 3, max_sh_degree=3, device="cpu")
    pc = os.path.join(path, "point_cloud", f"iteration_{it}")
    os.makedirs(pc)
    save_gaussian_ply(state, os.path.join(pc, "point_cloud.ply"))
    with open(os.path.join(path, "cfg_args"), "w") as f:
        f.write("Namespace(sh_degree=3, source_path='scene', eval=True)")
    with open(os.path.join(path, "cameras.json"), "w") as f:
        json.dump([{"id": 0}], f)


@pytest.mark.parametrize("target,k", [(1100, 22), (50, 1)], ids=["x22", "x1"])
def test_scale_model_equals_gsjax_script(tmp_path, target, k):
    from gsjax_torch.data.ply import read_ply

    out = {}
    for name, cmd in (("gsjax", [sys.executable, os.path.join(ROOT, "scripts", "scale_model.py")]),
                      ("port", [sys.executable, "-m", "gsjax_torch.scale_model"])):
        model = str(tmp_path / name / "model")
        _model(model)
        res = subprocess.run([*cmd, "-m", model, "--target", str(target), "--seed", "3"],
                             cwd=ROOT, capture_output=True, text=True, timeout=120,
                             env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert res.returncode == 0, res.stderr
        assert res.stdout.splitlines()[-1] == f"wrote {model}_x{k}"
        out[name] = f"{model}_x{k}"
    plys = {name: read_ply(os.path.join(d, "point_cloud", "iteration_7", "point_cloud.ply"))
            for name, d in out.items()}
    got, want = plys["port"]["vertex"], plys["gsjax"]["vertex"]
    assert list(got) == list(want) and len(got["x"]) == 50 * k
    for name in want:
        assert got[name].dtype == want[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    metas = {}
    for name, d in out.items():
        with open(os.path.join(d, "scale_meta.json")) as f:
            metas[name] = json.load(f)
        for aux in ("cfg_args", "cameras.json"):
            assert os.path.exists(os.path.join(d, aux))
    assert metas["port"].pop("src").startswith(str(tmp_path / "port"))
    metas["gsjax"].pop("src")
    assert metas["port"] == metas["gsjax"] == {
        "n_src": 50, "k": k, "n_out": 50 * k, "jitter": 0.35, "seed": 3,
        "opacity_split": "1-(1-a)^(1/K)"}
    # the clones composite to the parent's alpha; the first copy stays put
    src = read_ply(os.path.join(str(tmp_path / "port" / "model"), "point_cloud", "iteration_7",
                                "point_cloud.ply"))["vertex"]
    alpha = 1 / (1 + np.exp(-got["opacity"][:50].astype(np.float64)))
    parent = 1 / (1 + np.exp(-src["opacity"].astype(np.float64)))
    np.testing.assert_allclose(1 - (1 - alpha) ** k, parent, atol=1e-5)
    for name in "xyz":
        np.testing.assert_array_equal(got[name][:50], src[name])
