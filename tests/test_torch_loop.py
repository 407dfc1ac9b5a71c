"""gsjax_torch's training loop against gsjax's, on the CPU: ``training``
on the 64x64 fixture scene with the same seed on both sides (the port's
scan backend against gsjax's XLA scan), then a resume from a checkpoint;
``evaluate_state``; ``Scene``'s shuffled order, ``cameras.json`` and
``input.ply``; and the CLIs' ``main()`` (train, metrics, full_eval).

The fixture scene's GT images come from gsjax's oracle renderer
(``tests/fixtures.py``). ``training`` runs twice: clone-only (percent_dense
1.0), and at the default percent_dense with random backgrounds, where the
splits draw their noise and every step its background from gsjax's key
chain (``utils.prng``), so both sides take the same decisions; the budget
starts too small, so both react to the same pair overflow."""

import json
import os
import random

import numpy as np
import pytest
import torch

from gsjax.configs import ModelParams as JM
from gsjax.configs import OptimizationParams as JO
from gsjax.configs import PipelineParams as JP
from gsjax.ops.rasterize import RasterizeSettings as JS
from gsjax_torch.configs import ModelParams as TM
from gsjax_torch.configs import OptimizationParams as TO
from gsjax_torch.configs import PipelineParams as TP
from gsjax_torch.ops.rasterize import RasterizeSettings as TS
from test_torch_densify import one_torch_thread  # noqa: F401

ITERS = 40
OPT = dict(iterations=ITERS, densification_interval=10, densify_from_iter=9,
           densify_until_iter=30, opacity_reset_interval=20, percent_dense=1.0,
           position_lr_max_steps=ITERS)
BUDGET = dict(max_pairs=1 << 10, max_splats_per_tile=512)
RUN = dict(testing_iterations=(20, ITERS), saving_iterations=(ITERS,),
           checkpoint_iterations=(20,), quiet=True, capacity=128, seed=0,
           steps_per_dispatch=5)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from fixtures import make_blender_scene

    path = str(tmp_path_factory.mktemp("scene"))
    make_blender_scene(path, n_train=12, n_test=3, width=64, height=64)
    return path


def _log(path):
    with open(os.path.join(path, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


class _Recorder:
    """Records every ``random.randint`` draw (the camera order) and, once
    per dispatch, the iteration, the active count and the L1 of a render
    of the first test view against its GT: the loss trajectory."""

    def __init__(self, monkeypatch, view, to_image):
        self.draws, self.trace = [], []
        self._view, self._to_image = view, to_image
        orig = random.randint

        def randint(a, b):
            r = orig(a, b)
            self.draws.append((a, b, r))
            return r

        monkeypatch.setattr(random, "randint", randint)

    def __call__(self, iteration, state, render_fn):
        img = self._to_image(render_fn, state)
        gt = np.asarray(self._view.image)
        self.trace.append((iteration, int(state.num_active),
                           float(np.abs(np.clip(img, 0, 1) - gt).mean())))


def _run_gsjax(src, out, monkeypatch, start=None, **opt):
    import jax.numpy as jnp

    from gsjax.data.dataset_readers import load_camera_images, load_scene_info
    from gsjax.train.loop import training

    view = load_camera_images(load_scene_info(src, eval_split=True).test_cameras[:1])[0]
    rc = view.to_render_camera()
    rec = _Recorder(monkeypatch, view,
                    lambda fn, st: np.asarray(fn(st, rc, jnp.zeros(3))))
    scene, state = training(
        JM(source_path=src, model_path=out, eval=True), JO(**{**OPT, **opt}), JP(),
        settings=JS(**BUDGET), passive_callback=rec, start_checkpoint=start, **RUN)
    monkeypatch.undo()
    return scene, state, rec


def _run_port(src, out, monkeypatch, start=None, **opt):
    from gsjax_torch.data.dataset_readers import load_camera_images, load_scene_info
    from gsjax_torch.train.loop import training

    view = load_camera_images(load_scene_info(src, eval_split=True).test_cameras[:1])[0]
    rc = view.to_render_camera("cpu")
    rec = _Recorder(monkeypatch, view,
                    lambda fn, st: fn(st, rc, torch.zeros(3)).numpy())
    scene, state = training(
        TM(source_path=src, model_path=out, eval=True), TO(**{**OPT, **opt}), TP(),
        settings=TS(**BUDGET), passive_callback=rec, start_checkpoint=start, device="cpu", **RUN)
    monkeypatch.undo()
    return scene, state, rec


def _events(log, kind):
    return [{k: v for k, v in r.items() if k != "pause_s"} for r in log
            if r.get("event") == kind]


def _assert_runs_agree(jrun, trun, jdir, tdir):
    (jscene, jstate, jrec), (tscene, tstate, trec) = jrun, trun
    # the camera order, draw for draw (Python's random, seeded alike)
    assert trec.draws == jrec.draws and len(trec.draws) > 0
    assert ([c.image_name for c in tscene.get_train_cameras()]
            == [c.image_name for c in jscene.get_train_cameras()])
    jlog, tlog = _log(jdir), _log(tdir)
    for kind in ("densify", "capacity_growth", "pair_overflow"):
        assert _events(tlog, kind) == _events(jlog, kind), kind
    # the loss trajectory, dispatch for dispatch: the same iterations and
    # active counts; the L1 of the first test view within 2e-3 (float32
    # sums in other orders over the steps; the scene's L1 falls by ~5x that)
    assert [t[:2] for t in trec.trace] == [t[:2] for t in jrec.trace]
    np.testing.assert_allclose([t[2] for t in trec.trace], [t[2] for t in jrec.trace],
                               rtol=0, atol=2e-3)
    # evaluation at each test iteration: PSNR within 0.1 dB
    jev = [r for r in jlog if "eval" in r]
    tev = [r for r in tlog if "eval" in r]
    assert [r["iter"] for r in tev] == [r["iter"] for r in jev]
    for a, b in zip(tev, jev):
        for split in ("test", "train"):
            assert a["eval"][split]["n_views"] == b["eval"][split]["n_views"]
            assert a["eval"][split]["psnr"] == pytest.approx(b["eval"][split]["psnr"], abs=0.1)
    assert tstate.capacity == jstate.capacity
    np.testing.assert_array_equal(tstate.active.numpy(), np.asarray(jstate.active))
    return jlog, tlog


# clone-only; and the default percent_dense (splits draw their noise) with
# a random background every step
CASES = {"clone_only": {}, "splits_random_background": dict(
    percent_dense=JO().percent_dense, random_background=True)}


@pytest.mark.parametrize("case", list(CASES))
def test_training_follows_gsjax(scene_dir, tmp_path, monkeypatch, case):
    opt = CASES[case]
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jrun = _run_gsjax(scene_dir, jdir, monkeypatch, **opt)
    trun = _run_port(scene_dir, tdir, monkeypatch, **opt)
    jlog, tlog = _assert_runs_agree(jrun, trun, jdir, tdir)
    # every event of the schedule happened
    dens = _events(tlog, "densify")
    assert [r["iter"] for r in dens] == [10, 20]
    assert _events(tlog, "capacity_growth")
    if opt:
        assert all(r["split"] > 0 for r in dens)
    else:
        assert all(r["cloned"] > 0 and r["split"] == 0 for r in dens)
        assert _events(tlog, "pair_overflow")
    # the first dispatch, before any event, lowered the loss
    assert trun[2].trace[1][2] < trun[2].trace[0][2]
    # artifacts (reference scene/__init__.py:51-63, train.py:108-132)
    for name in ("cfg_args", "cameras.json", "input.ply", "chkpnt20.npz",
                 os.path.join("point_cloud", f"iteration_{ITERS}", "point_cloud.ply")):
        assert os.path.exists(os.path.join(tdir, name)), name
    if opt:
        return

    # resume from gsjax's checkpoint at 20 (the port reads gsjax's file):
    # the first dispatch sees the state gsjax's run had at iteration 21,
    # and the run goes on as gsjax's resumed run would (the camera stack
    # starts anew, as in gsjax)
    tres = _run_port(scene_dir, str(tmp_path / "t2"), monkeypatch,
                     start=os.path.join(jdir, "chkpnt20.npz"))
    first = tres[2].trace[0]
    want = next(t for t in jrun[2].trace if t[0] == 21)
    assert first[:2] == want[:2]
    assert first[2] == pytest.approx(want[2], abs=1e-5)  # one render, two scans
    assert [t[0] for t in tres[2].trace][-1] == ITERS - 4  # its last dispatch
    assert _events(_log(str(tmp_path / "t2")), "densify") == []  # 20 was the last


def test_scene_matches_gsjax(scene_dir, tmp_path):
    """The shuffled train / test order (Python's random after one seed),
    ``cameras.json``, the ``input.ply`` copy and the PLY snapshot."""
    from gsjax.train.scene import Scene as JScene
    from gsjax_torch.train.scene import Scene as TScene

    scenes = {}
    for name, cls, model, kw in (("j", JScene, JM, {}), ("t", TScene, TM, {"device": "cpu"})):
        random.seed(3)
        scenes[name] = cls(model(source_path=scene_dir, model_path=str(tmp_path / name),
                                 eval=True), capacity=128, **kw)
    j, t = scenes["j"], scenes["t"]
    for get in ("get_train_cameras", "get_test_cameras"):
        assert ([c.image_name for c in getattr(t, get)()]
                == [c.image_name for c in getattr(j, get)()])
    assert t.cameras_extent == j.cameras_extent
    with open(tmp_path / "j" / "cameras.json") as fj, open(tmp_path / "t" / "cameras.json") as ft:
        assert json.load(ft) == json.load(fj)
    for name in ("input.ply",):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    j.save(7)
    t.save(7)
    from gsjax_torch.data.ply import read_ply

    ply = os.path.join("point_cloud", "iteration_7", "point_cloud.ply")
    got, want = (read_ply(str(tmp_path / d / ply))["vertex"] for d in "tj")
    assert list(got) == list(want)  # the same properties in the same order
    for k in want:
        # the init's log-scales come from two kNN searches (float32 sums)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    # without shuffle the dataset's order; without images none are loaded
    plain = TScene(TM(source_path=scene_dir, model_path=str(tmp_path / "p")), shuffle=False,
                   load_images=False, device="cpu")
    from gsjax.data.dataset_readers import load_scene_info as j_info

    assert ([c.image_name for c in plain.get_train_cameras()]
            == [c.image_name for c in j_info(scene_dir, load_images=False).train_cameras])
    assert plain.get_train_cameras()[0].image is None


def test_evaluate_state_matches_gsjax(scene_dir, tmp_path):
    import jax.numpy as jnp

    from gsjax.train.loop import evaluate_state as j_eval
    from gsjax.train.scene import Scene as JScene
    from gsjax.train.step import TrainConfig as JCfg
    from gsjax.train.step import make_render_fn as j_make
    from gsjax_torch.train.loop import evaluate_state
    from gsjax_torch.train.scene import Scene as TScene
    from gsjax_torch.train.step import TrainConfig, make_render_fn
    from test_torch_render import _carry

    js = JScene(JM(source_path=scene_dir, model_path=str(tmp_path / "j"), eval=True),
                shuffle=False, capacity=64)
    ts = TScene(TM(source_path=scene_dir, model_path=str(tmp_path / "t"), eval=True),
                shuffle=False, capacity=64, device="cpu")
    jmedia, tmedia = [], []
    want = j_eval(js.gaussians, js, j_make(JCfg(settings=JS(**BUDGET))), jnp.zeros(3),
                  media=jmedia)
    got = evaluate_state(_carry(js.gaussians), ts,
                         make_render_fn(TrainConfig(settings=TS(**BUDGET))), torch.zeros(3),
                         media=tmedia)
    assert got.keys() == want.keys() == {"test", "train"}
    for split in want:
        assert got[split]["n_views"] == want[split]["n_views"]
        # float32 images from two scan implementations: L1 and PSNR agree to
        # float rounding
        assert got[split]["l1"] == pytest.approx(want[split]["l1"], rel=1e-4)
        assert got[split]["psnr"] == pytest.approx(want[split]["psnr"], abs=1e-3)
    assert [m[0] for m in tmedia] == [m[0] for m in jmedia]
    np.testing.assert_allclose(tmedia[0][1], jmedia[0][1], atol=1e-4)


def test_train_cli_runs_and_refuses_what_is_not_ported(scene_dir, tmp_path, capfd):
    import sys

    from gsjax_torch.train.__main__ import main

    out = str(tmp_path / "cli")
    stdout = sys.stdout
    try:
        scene, state = main(["-s", scene_dir, "-m", out, "--eval", "--iterations", "20",
                             "--densify_from_iter", "9", "--densification_interval", "10",
                             "--densify_until_iter", "15", "--test_iterations", "20",
                             "--checkpoint_iterations", "10", "--capacity", "64",
                             "--device", "cpu", "--quiet", "--steps_per_dispatch", "5",
                             "--disable_viewer"])
    finally:
        sys.stdout = stdout  # safe_state wraps stdout
    last = json.loads(capfd.readouterr().out.strip().splitlines()[-1])
    assert last["stage"] == "done" and last["iterations"] == 20
    # on the CPU the plain versions run: no kernel launch is counted
    assert last["launches"] == {"composite_infer": 0, "composite_fwd": 0, "composite_bwd": 0}
    assert last["capacity"] == state.capacity >= 128
    # the profiling registry's counters, spans and layer clock: every step
    # ran op by op on the CPU (the scan backend: no kernel's own segments)
    assert last["step_paths"] == {"graph": 0, "capture": 0, "eager": 20}
    assert last["graph_captures"] == {"count": 0, "seconds": 0.0}
    assert {"dispatch", "dispatch.prepare", "dispatch.eager", "frame"} <= set(last["spans"])
    assert list(last["layers"]["train"]["eager"]) == ["prep", "composite_fwd", "prep_bwd",
                                                      "adam", "stats"]
    for name in ("chkpnt10.npz", os.path.join("point_cloud", "iteration_20", "point_cloud.ply")):
        assert os.path.exists(os.path.join(out, name))
    assert any(r.get("event") == "densify" for r in _log(out))
    # --web_viewer and the sharded flags are ported (tests/test_torch_viewer.py,
    # tests/test_torch_parallel_cli.py); an incomplete bootstrap is refused
    # before anything is read or written
    for flags, err, match in ((["--multihost"], ValueError, "WORLD_SIZE"),
                              (["--dist_coordinator", "localhost:1"], ValueError,
                               "num_processes"),
                              (["--data_shards", "2"], RuntimeError, "not initialized")):
        with pytest.raises(err, match=match):
            main(["-s", scene_dir, "-m", str(tmp_path / "s"), "--device", "cpu",
                  "--disable_viewer"] + flags)
        assert not os.path.exists(tmp_path / "s")
    sys.stdout = stdout


def test_metrics_cli_matches_gsjax(tmp_path, monkeypatch):
    """The same results.json / per_view.json keys and values as the root
    metrics.py: SSIM, PSNR and LPIPS, its gated weights found through
    ``$GSJAX_LPIPS_WEIGHTS`` (full-width synthetic weights, 32x32 views)."""
    _metrics_clis_agree(tmp_path, monkeypatch, with_lpips=True)


def test_metrics_cli_without_lpips_weights(tmp_path, monkeypatch):
    """Without the weights both CLIs report SSIM and PSNR only."""
    _metrics_clis_agree(tmp_path, monkeypatch, with_lpips=False)


def _metrics_clis_agree(tmp_path, monkeypatch, with_lpips):
    from PIL import Image

    import metrics as j_metrics
    from gsjax_torch.metrics import main
    from test_lpips import synth_params

    rng = np.random.default_rng(16)
    weights = str(tmp_path / "lpips_vgg.npz")
    if with_lpips:
        np.savez(weights, **{k: np.asarray(v) for k, v in synth_params(rng).items()})
    monkeypatch.setenv("GSJAX_LPIPS_WEIGHTS", weights)
    shape = (32, 32, 3) if with_lpips else (40, 56, 3)
    model = tmp_path / "model"
    for method in ("ours_7", "ours_30"):
        for sub in ("renders", "gt"):
            os.makedirs(model / "test" / method / sub)
        for i in range(3):
            gt = rng.integers(0, 256, shape, dtype=np.uint8)
            noisy = np.clip(gt + rng.normal(0, 12, gt.shape), 0, 255).astype(np.uint8)
            Image.fromarray(gt).save(model / "test" / method / "gt" / f"{i:05d}.png")
            Image.fromarray(noisy).save(model / "test" / method / "renders" / f"{i:05d}.png")
    j_metrics.evaluate([str(model)])
    want = {n: json.loads((model / n).read_text()) for n in ("results.json", "per_view.json")}
    got_ret = main(["-m", str(model), "--device", "cpu"])
    got = {n: json.loads((model / n).read_text()) for n in ("results.json", "per_view.json")}
    assert got_ret == {str(model): got["results.json"]}
    assert got["results.json"].keys() == want["results.json"].keys() == {"ours_7", "ours_30"}
    keys = {"SSIM", "PSNR", "LPIPS"} if with_lpips else {"SSIM", "PSNR"}
    for method, m in want["results.json"].items():
        assert got["results.json"][method].keys() == m.keys() == keys
        for k, v in m.items():
            # float32 SSIM / PSNR from two implementations of one formula;
            # LPIPS through two float32 convolution libraries
            rel = 1e-4 if k == "LPIPS" else 1e-5
            assert got["results.json"][method][k] == pytest.approx(v, rel=rel)
            views = want["per_view.json"][method][k]
            assert got["per_view.json"][method][k].keys() == views.keys()
            for name, x in views.items():
                assert got["per_view.json"][method][k][name] == pytest.approx(x, rel=rel)


def test_full_eval_runs_the_port_s_clis(monkeypatch):
    """The commands the root full_eval.py would run, with the port's
    modules in place of the root scripts and ``--device`` passed on."""
    import full_eval as j_full_eval
    from gsjax_torch import full_eval

    root = os.path.dirname(os.path.abspath(j_full_eval.__file__))
    argv = ["-m360", "/data/360", "--scenes", "/data/synth/", "--iterations", "3000",
            "--extra_train_args", "--seed 3", "--output_path", "/tmp/ev"]
    want = []
    monkeypatch.setattr(j_full_eval, "run", want.append)
    j_full_eval.main(argv)
    got = []
    monkeypatch.setattr(full_eval, "run", got.append)
    full_eval.main(argv + ["--device", "cpu"])
    assert len(got) == len(want) == 10 + 10 + 1  # one snapshot (3000) per scene
    for g, w in zip(got, want):
        for script in ("train", "render", "metrics"):
            w = w.replace(os.path.join(root, f"{script}.py"), f"-m gsjax_torch.{script}")
        assert g == w + " --device cpu"
    assert "images_4" in got[0] and "--iterations 3000 --save_iterations 3000" in got[0]


def test_wall_budget_and_stop_file_save_and_stop(scene_dir, tmp_path):
    """A spent wall budget, or a STOP file in the model directory, ends the
    run after the dispatch in flight with a checkpoint and a PLY snapshot
    (gsjax's graceful stop), and the checkpoint resumes."""
    from gsjax_torch.train.loop import training

    opt = TO(iterations=40, densify_from_iter=10_000, opacity_reset_interval=10_000)
    run = dict(testing_iterations=(), saving_iterations=(), quiet=True,
               settings=TS(**BUDGET), capacity=128, steps_per_dispatch=5, device="cpu")
    out = str(tmp_path / "budget")
    training(TM(source_path=scene_dir, model_path=out), opt, TP(), wall_budget=1e-9, **run)
    stop = [r for r in _log(out) if r.get("event") == "wall_budget_stop"]
    assert [r["iter"] for r in stop] == [5]
    for name in ("chkpnt5.npz", os.path.join("point_cloud", "iteration_5", "point_cloud.ply")):
        assert os.path.exists(os.path.join(out, name)), name

    out2 = str(tmp_path / "stop")
    os.makedirs(out2)
    open(os.path.join(out2, "STOP"), "w").close()
    _, state = training(TM(source_path=scene_dir, model_path=out2), opt, TP(),
                        start_checkpoint=os.path.join(out, "chkpnt5.npz"), **run)
    assert [r["iter"] for r in _log(out2) if r.get("event") == "wall_budget_stop"] == [10]
    assert not os.path.exists(os.path.join(out2, "STOP"))
    assert os.path.exists(os.path.join(out2, "chkpnt10.npz"))
