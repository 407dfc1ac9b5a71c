"""gsjax_torch stands alone: it imports without JAX and without gsjax, and
its entry points default to CUDA and refuse to run without it."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import gsjax_torch

    names = ["gsjax_torch"]
    for info in pkgutil.walk_packages(gsjax_torch.__path__, "gsjax_torch."):
        names.append(info.name)
    return names


def test_port_imports_without_jax_or_gsjax():
    mods = _port_modules()
    assert {"gsjax_torch.ops.cuda_composite", "gsjax_torch.render",
            "gsjax_torch.train.loop", "gsjax_torch.models.densify",
            "gsjax_torch.train.checkpoint", "gsjax_torch.train.__main__",
            "gsjax_torch.metrics", "gsjax_torch.full_eval",
            "gsjax_torch.synthetic_scene", "gsjax_torch.eval.lpips",
            "gsjax_torch.viewer", "gsjax_torch.viewer.network_gui",
            "gsjax_torch.viewer.local_viewer", "gsjax_torch.view",
            "gsjax_torch.render_bench", "gsjax_torch.viewer_bench",
            "gsjax_torch.parallel", "gsjax_torch.parallel.multihost",
            "gsjax_torch.parallel.mesh", "gsjax_torch.parallel.comm",
            "gsjax_torch.parallel.shard", "gsjax_torch.parallel.multi_scene",
            "gsjax_torch.train_multiscene", "gsjax_torch.scaling_bench"} <= set(mods)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        "sys.modules['gsjax'] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gsjax')"
        " and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card, and in a directory holding only the script, it exits
    nonzero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd in (ROOT, str(tmp_path)):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_entry_points_default_to_cuda():
    from gsjax_torch.data.cameras import Camera
    from gsjax_torch.models.gaussians import create_empty
    from gsjax_torch.render import main as render_main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would succeed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_empty(8)
    cam = Camera(uid=0, image_name="c", R=torch.eye(3).numpy(), T=[0, 0, 0],
                 fov_x=0.9, fov_y=0.9, width=32, height=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cam.to_render_camera()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_main(["-m", "/nonexistent-model"])
    # the CPU works when asked for
    assert create_empty(8, device="cpu").capacity == 8


@pytest.mark.parametrize("entry", ["train", "metrics", "full_eval", "synthetic_scene",
                                   "training", "scene", "view", "render_bench",
                                   "viewer_bench", "LocalViewer", "viewer_from_model",
                                   "lpips_weights", "train_multiscene", "scaling_bench",
                                   "sharded_training", "sharded_train"])
def test_training_entry_points_refuse_without_cuda(entry, tmp_path):
    """The training, serving and sharded slices' entry points default to CUDA and
    raise without it, before they read or write anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would run")
    from gsjax_torch import (
        full_eval,
        metrics,
        render_bench,
        scaling_bench,
        synthetic_scene,
        train_multiscene,
        view,
        viewer_bench,
    )
    from gsjax_torch.eval.lpips import load_weights
    from gsjax_torch.models.gaussians import create_empty
    from gsjax_torch.configs import ModelParams, OptimizationParams, PipelineParams
    from gsjax_torch.train.__main__ import main as train_main
    from gsjax_torch.train.loop import training
    from gsjax_torch.train.scene import Scene
    from gsjax_torch.viewer import LocalViewer, viewer_from_model

    missing = str(tmp_path / "missing")
    calls = {
        "train": lambda: train_main(["-s", missing, "-m", str(tmp_path / "m")]),
        "metrics": lambda: metrics.main(["-m", missing]),
        "full_eval": lambda: full_eval.main(["--scenes", missing]),
        "synthetic_scene": lambda: synthetic_scene.main([str(tmp_path / "s")]),
        "training": lambda: training(ModelParams(source_path=missing),
                                     OptimizationParams(), PipelineParams()),
        "scene": lambda: Scene(ModelParams(source_path=os.path.join(
            ROOT, "tests", "data_missing"), model_path=str(tmp_path / "m"))),
        "view": lambda: view.main(["-m", missing]),
        "render_bench": lambda: render_bench.main(["-m", missing]),
        "viewer_bench": lambda: viewer_bench.main(["-m", missing, "--port", "0"]),
        "LocalViewer": lambda: LocalViewer(create_empty(8, device="cpu"), [0, 0, 0], port=0),
        "viewer_from_model": lambda: viewer_from_model(missing),
        "lpips_weights": lambda: load_weights(os.path.join(ROOT, "evidence",
                                                           "lpips_vgg_structure_test.npz")),
        "train_multiscene": lambda: train_multiscene.main(
            ["-s", missing, missing, "-m", str(tmp_path / "a"), str(tmp_path / "b")]),
        "scaling_bench": lambda: scaling_bench.main(["--gauss", "1", "2"]),
        "sharded_training": lambda: training(ModelParams(source_path=missing),
                                             OptimizationParams(), PipelineParams(),
                                             gauss_shards=2),
        "sharded_train": lambda: train_main(["-s", missing, "-m", str(tmp_path / "m"),
                                             "--gauss_shards", "2", "--dist_coordinator",
                                             "127.0.0.1:1", "--dist_num_processes", "2",
                                             "--dist_process_id", "0"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
    assert not os.listdir(tmp_path)
