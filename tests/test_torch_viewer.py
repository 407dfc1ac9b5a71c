"""gsjax_torch's serving surfaces against gsjax's, on the CPU: the SIBR
bridge's camera decoding and its wire protocol against a scripted SIBR
client (``tests/test_viewer.py:_client_message`` builds the messages), the
local web viewer's pages and frames, the train CLI's web viewer rendering
while training runs, and the render and viewer benches rehearsed on a tiny
model directory."""

import ast
import io
import json
import os
import queue
import socket
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from conftest import make_test_camera
from gsjax.viewer import local_viewer as JL
from gsjax.viewer.network_gui import _camera_from_message as j_camera_from_message
from gsjax_torch.models.gaussians import state_from_numpy
from gsjax_torch.ops.rasterize import RasterizeSettings
from gsjax_torch.train.step import TrainConfig, make_render_fn
from gsjax_torch.viewer import local_viewer as L
from gsjax_torch.viewer import network_gui as N
from test_torch_densify import one_torch_thread  # noqa: F401
from test_viewer import _client_message

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 64
SETTINGS = RasterizeSettings(max_pairs=1 << 14, max_splats_per_tile=256)


def _states(seed, n=120, spread=1.0, z=0.0):
    """A gsjax state from a random point cloud and the port's copy of it."""
    from gsjax.models.gaussians import create_from_pcd

    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * spread + [0, 0, z]).astype(np.float32)
    cols = rng.uniform(0.2, 1.0, size=(n, 3)).astype(np.float32)
    js = create_from_pcd(pts, cols, spatial_lr_scale=1.0, capacity=128)
    ts = state_from_numpy({k: np.asarray(v) for k, v in js.params.items()},
                          np.asarray(js.active), int(js.active_sh_degree), device="cpu")
    return js, ts


def _get(url, timeout=120):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _jpeg(body):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)))


def test_camera_from_message_matches_gsjax():
    cam = make_test_camera(width=96, height=64, seed=3)
    msg = _client_message(cam, 96, 64)
    want = j_camera_from_message(msg)
    got = N._camera_from_message(msg, "cpu")
    for k in ("world_view", "full_proj", "camera_center", "tan_fov_x", "tan_fov_y"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   atol=1e-6, err_msg=k)
        assert getattr(got, k).dtype == torch.float32
    assert (got.width, got.height) == (96, 64)
    assert N._camera_from_message(_client_message(cam, 0, 0), "cpu") is None


def _serve(bridge, state, render_fn, msgs):
    """A scripted SIBR client on a thread sends ``msgs`` on one connection
    and reads each reply; the bridge is polled as the training loop polls
    it. Returns the replies: (image bytes or None, source path)."""
    port = bridge.listener.getsockname()[1]
    replies = []

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            f = s.makefile("rb")
            for m in msgs:
                payload = json.dumps(m).encode("utf-8")
                s.sendall(len(payload).to_bytes(4, "little") + payload)
                n_img = m["resolution_x"] * m["resolution_y"] * 3
                img = f.read(n_img) if n_img else None
                n = int.from_bytes(f.read(4), "little")
                replies.append((img, f.read(n).decode("ascii")))

    t = threading.Thread(target=client)
    t.start()
    for _ in range(400):
        bridge.poll(iteration=1, state=state, render_fn=render_fn)
        if not t.is_alive():
            break
        t.join(timeout=0.02)
    t.join(timeout=10)
    bridge.close()
    assert not t.is_alive()
    return replies


@pytest.mark.parametrize("scale,shs_python,rot_scale_python",
                         [(1.0, False, False), (0.3, True, True)],
                         ids=["plain", "scaled-python-paths"])
def test_bridge_serves_scripted_sibr_client(scale, shs_python, rot_scale_python):
    """The frame's bytes equal ``make_render_fn(as_uint8=True)``'s for the
    decoded camera, bit for bit; the source path comes back; the message's
    scaling_modifier and python-path toggles reach the render."""
    _, state = _states(0, spread=1.5, z=7.0)
    cam = make_test_camera(width=W, height=H)
    msg = _client_message(cam, W, H, scaling_modifier=scale, shs_python=shs_python,
                          rot_scale_python=rot_scale_python)
    fn = make_render_fn(TrainConfig(settings=SETTINGS))
    calls = []

    def render_fn(*a, **kw):
        calls.append((a[3], kw))
        return fn(*a, **kw)

    bridge = N.ViewerBridge(port=0, source_path="/data/test_scene")
    [(img, path)] = _serve(bridge, state, render_fn, [msg])
    assert path == "/data/test_scene"
    assert calls == [(scale, {"shs_python": shs_python, "cov3d_python": rot_scale_python})]
    rcam = N._camera_from_message(msg, "cpu")
    u8 = make_render_fn(TrainConfig(settings=SETTINGS), as_uint8=True)
    want = u8(state, rcam, torch.zeros(3), scale, shs_python=shs_python,
              cov3d_python=rot_scale_python).numpy()
    np.testing.assert_array_equal(np.frombuffer(img, np.uint8).reshape(H, W, 3), want)
    if scale != 1.0:
        unscaled = u8(state, rcam, torch.zeros(3)).numpy()
        assert np.abs(want.astype(int) - unscaled.astype(int)).max() > 5


def test_bridge_empty_resolution_is_noop_frame():
    _, state = _states(1)
    bridge = N.ViewerBridge(port=0, source_path="x")
    replies = _serve(bridge, state, None, [_client_message(make_test_camera(), 0, 0)])
    assert replies == [(None, "x")]


def test_local_viewer_serves_pages_and_frames_like_gsjax():
    """/, /info and /render over real HTTP, 403 off the allowed sizes; the
    viewer's cached function's uint8 frame against gsjax's
    ``LocalViewer._fn_for`` on the same carried state and lookat camera:
    within 1 on at most 0.5% of pixels."""
    from gsjax.data.cameras import lookat_camera as j_lookat
    from gsjax_torch.data.cameras import lookat_camera

    jstate, state = _states(5)
    viewer = L.LocalViewer(state, np.zeros(3, np.float32), port=0,
                           extra_sizes=((64, 48),), device="cpu")
    jviewer = JL.LocalViewer(jstate, np.zeros(3, np.float32), port=0,
                             extra_sizes=((64, 48),))
    port = viewer.start()
    base = f"http://127.0.0.1:{port}"
    try:
        assert b"gsjax_torch" in _get(f"{base}/")
        info = json.loads(_get(f"{base}/info"))
        jinfo = jviewer.scene_stats()
        assert info.keys() == jinfo.keys()
        assert info["n_gaussians"] == jinfo["n_gaussians"] == 120
        np.testing.assert_allclose(info["center"], jinfo["center"], atol=1e-6)
        assert info["extent"] == pytest.approx(jinfo["extent"], rel=1e-6)

        c = info["center"]
        eye = np.asarray(c) + np.array([0.0, -3.5 * info["extent"], 1.0])
        q = (f"ex={eye[0]}&ey={eye[1]}&ez={eye[2]}"
             f"&tx={c[0]}&ty={c[1]}&tz={c[2]}&w=64&h=48&scale=1.0")
        jpg = _get(f"{base}/render?{q}")
        img = _jpeg(jpg)
        assert img.shape == (48, 64, 3) and img.max() > 12
        assert _get(f"{base}/render?{q.replace('scale=1.0', 'scale=0.3')}") != jpg
        for path, code in (("/render?w=123&h=77", 403), ("/nothing", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base + path, timeout=30)
            assert e.value.code == code
    finally:
        viewer.stop()

    cam = lookat_camera(eye, c, (0, 0, 1), 1.1, 64, 48)
    got = viewer._fn_for(64, 48)(state, cam.to_render_camera("cpu"), viewer.bg, 1.0).numpy()
    want = np.asarray(jviewer._fn_for(64, 48)(
        jstate, j_lookat(eye, c, (0, 0, 1), 1.1, 64, 48).to_render_camera(),
        np.zeros(3, np.float32), np.float32(1.0)))
    assert got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, (diff.max(), (diff > 0).mean())
    assert np.abs(got.astype(int) - _jpeg(jpg).astype(int)).mean() < 8  # JPEG loss


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A 64x64 Blender scene (3 training, 2 test views) and a model
    directory holding a point-cloud PLY at iteration 7 and its cfg_args."""
    from fixtures import make_blender_scene
    from gsjax_torch.configs import ModelParams, save_cfg_args
    from gsjax_torch.models.gaussians import create_from_pcd, save_gaussian_ply

    root = tmp_path_factory.mktemp("served")
    scene, model = str(root / "scene"), str(root / "model")
    make_blender_scene(scene, n_train=3, n_test=2, width=64, height=64)
    rng = np.random.default_rng(0)
    state = create_from_pcd(rng.normal(size=(300, 3)).astype(np.float32),
                            rng.uniform(0.2, 1, (300, 3)).astype(np.float32), 1.0,
                            capacity=512, device="cpu")
    ply = os.path.join(model, "point_cloud", "iteration_7", "point_cloud.ply")
    os.makedirs(os.path.dirname(ply))
    save_gaussian_ply(state, ply)
    save_cfg_args(model, ModelParams(source_path=scene, model_path=model, eval=True))
    return scene, model


def test_web_viewer_renders_between_iterations(model_dir, tmp_path, monkeypatch):
    """``--web_viewer``: frames fetched while training runs (densification
    and a capacity growth included) are whole images, and the trained
    parameters are bit-identical to a run without the viewer."""
    from gsjax_torch.train.__main__ import main

    monkeypatch.setattr(L, "ALLOWED_SIZES", L.ALLOWED_SIZES | {(W, H)})
    ports = queue.Queue()
    start = L.LocalViewer.start
    monkeypatch.setattr(L.LocalViewer, "start", lambda self: ports.put(start(self)) or self.port)
    frames, infos, errors = [], [], []
    done = threading.Event()  # set when the run stops its viewer
    stop = L.LocalViewer.stop
    monkeypatch.setattr(L.LocalViewer, "stop", lambda self: (done.set(), stop(self)))

    def poll():
        base = f"http://127.0.0.1:{ports.get(timeout=300)}"
        q = f"ex=0&ey=-7&ez=2&tx=0&ty=0&tz=0&w={W}&h={H}"
        while not done.is_set():
            try:
                frames.append(_jpeg(_get(f"{base}/render?{q}")))
                infos.append(json.loads(_get(f"{base}/info")))
            except OSError as e:
                if not done.is_set():
                    errors.append(e)
                return

    args = ["-s", model_dir[0], "--iterations", "8", "--densify_from_iter", "2",
            "--densification_interval", "3", "--densify_until_iter", "7",
            "--capacity", "64", "--device", "cpu", "--quiet", "--steps_per_dispatch", "1",
            "--disable_viewer"]
    stdout = sys.stdout
    t = threading.Thread(target=poll, daemon=True)
    t.start()
    try:
        _, watched = main(args + ["-m", str(tmp_path / "watched"), "--web_viewer", "0"])
    finally:
        done.set()
        sys.stdout = stdout  # safe_state wraps stdout
    assert len(frames) >= 3, (frames, errors)
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    try:
        _, plain = main(args + ["-m", str(tmp_path / "plain")])
    finally:
        sys.stdout = stdout
    assert all(f.shape == (H, W, 3) for f in frames)
    its = [i["iteration"] for i in infos]
    assert its == sorted(its) and its[-1] > its[0]
    assert watched.capacity == plain.capacity > 64  # grew while watched
    assert torch.equal(watched.active, plain.active)
    for k, v in plain.params.items():
        assert torch.equal(watched.params[k], v), k


def _report_keys(report):
    return {k: _report_keys(v) if isinstance(v, dict) else None for k, v in report.items()}


def _gsjax_report_keys(script):
    """The keys of the ``report`` dict literal of one of gsjax's scripts
    (``**`` for a spread)."""
    def keys(d):
        return {("**" if k is None else k.value): keys(v) if isinstance(v, ast.Dict) else None
                for k, v in zip(d.keys, d.values)}

    with open(os.path.join(ROOT, "scripts", script)) as f:
        tree = ast.parse(f.read())
    [node] = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
              and getattr(n.targets[0], "id", None) == "report"]
    return keys(node.value)


def test_render_bench_rehearsal(model_dir, tmp_path, capsys):
    from gsjax_torch import render_bench

    out = str(tmp_path / "report.json")
    assert render_bench.main(["-m", model_dir[1], "--device", "cpu", "--views", "2",
                              "--out", out]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _report_keys(report) == _gsjax_report_keys("render_bench.py")
    ex = report["extra"]
    assert report["value"] > 0 and ex["num_dropped"] == 0 and ex["device"] == "cpu"
    assert (ex["n_views"], ex["iteration"], ex["n_gaussians"]) == (2, 7, 300)
    with open(out) as f:
        assert json.load(f) == report


def test_render_bench_refuses_after_a_drop(model_dir, tmp_path, capsys, monkeypatch):
    """A starved pair budget: exit 1, no frames/s, no report written."""
    import dataclasses

    from gsjax_torch import render_bench
    from gsjax_torch.train import loop

    probe = loop.probe_rasterize_settings
    monkeypatch.setattr(loop, "probe_rasterize_settings", lambda *a, **k: dataclasses.replace(
        probe(*a, **k), max_pairs=64))
    out = str(tmp_path / "report.json")
    assert render_bench.main(["-m", model_dir[1], "--device", "cpu", "--views", "2",
                              "--out", out]) == 1
    captured = capsys.readouterr()
    assert "frames/s" not in captured.out and "pairs dropped" in captured.err
    assert not os.path.exists(out)


def test_viewer_bench_rehearsal(model_dir, capsys, monkeypatch):
    from gsjax_torch import viewer_bench

    monkeypatch.setattr(L, "ALLOWED_SIZES", L.ALLOWED_SIZES | {(W, H)})
    assert viewer_bench.main(["-m", model_dir[1], "--device", "cpu", "--port", "0",
                              "--width", str(W), "--height", str(H), "--frames", "5"]) == 0
    lines = capsys.readouterr().out.splitlines()
    report = json.loads("\n".join(lines[lines.index("{"):]))  # printed last, indented
    want = _gsjax_report_keys("viewer_bench.py")
    del want["**"]  # gsjax spreads its viewer's scene_stats
    want.update(dict.fromkeys(JL.LocalViewer(_states(2)[0], np.zeros(3)).scene_stats()))
    assert _report_keys(report) == want
    assert report["frames_timed"] == 2 and report["n_gaussians"] == 300
    assert report["p50_ms"] > 0 and report["jpeg_kb_mean"] > 0


def test_render_lock_shows_only_whole_iterations():
    """Stress: 8 client threads read /info while a training thread writes
    the state in place in two halves per iteration, holding the render
    lock: every read sees whole iterations (the center moved by exactly
    the iteration count), and queued requests are served at boundaries."""
    import time

    _, state = _states(3)
    viewer = L.LocalViewer(state, np.zeros(3, np.float32), port=0, device="cpu")
    base = f"http://127.0.0.1:{viewer.start()}"
    x0 = viewer.scene_stats()["center"][0]
    seen, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            info = json.loads(_get(f"{base}/info", timeout=30))
            seen.append((info["iteration"], info["center"][0] - x0))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    clients = [threading.Thread(target=client, daemon=True) for _ in range(8)]
    try:
        viewer.hold()
        for t in clients:
            t.start()
        for it in range(1, 41):
            state.params["xyz"] += 0.5  # half a step...
            time.sleep(0.02)  # requests queue meanwhile
            state.params["xyz"] += 0.5  # ...and the other half
            viewer.between_iterations(state, it)
    finally:
        stop.set()
        viewer.release()
        sys.setswitchinterval(switch)
        for t in clients:
            t.join(timeout=30)
        viewer.stop()
    assert not any(t.is_alive() for t in clients)
    assert len({it for it, _ in seen}) >= 10, seen  # served at many boundaries
    for it, dx in seen:
        assert 1 <= it <= 40 and dx == pytest.approx(it, abs=1e-4), (it, dx)
