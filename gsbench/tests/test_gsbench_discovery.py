"""Every name in BENCHMARK.json resolves to its files, and a new
configuration, mix or metric is found by its file name alone."""

import json
import os
import shutil

from gsbench import harness
from gsbench.tests import tiny


def test_every_cell_finds_its_files():
    b = tiny.bench()
    for c in b["configs"]:
        assert os.path.exists(os.path.join(tiny.REPO, c["file"]))
        cfg = harness.load_json("configs", f"{c['name']}.json")
        assert harness.scene_maker(cfg["scene"])
    for w in b["workloads"]:
        harness.load_json("traffic", f"{w['traffic']}.json")
        lim = harness.load_json("limits", f"{w['name']}.json")
        assert lim and all(v > 0 for v in lim.values())
    for m in b["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_per_layer_metrics_follow_their_end_to_end_cells():
    b = tiny.bench()
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in b["workloads"]]))
           for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) == e2e[m["moves"]], m["name"]


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    root = tmp_path / "gsbench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "metrics" / "new_layer_ms.py").write_text(
        "def read(ctx):\n    return 1e3 * ctx['spans'].get('gsbench.new', 0.0)\n")
    (root / "traffic" / "train_long.json").write_text(json.dumps(
        dict(harness.load_json("traffic", "train.json"), steps_per_dispatch=50)))
    (root / "configs" / "bench720.json").write_text(json.dumps(
        dict(harness.load_json("configs", "bench1080.json"), name="bench720", width=1280,
             height=720)))
    monkeypatch.setattr(harness, "ROOT", str(root))
    assert harness.metric_reader("new_layer_ms")({"spans": {"gsbench.new": 0.002}}) == 2.0
    assert harness.load_json("traffic", "train_long.json")["steps_per_dispatch"] == 50
    assert harness.load_json("configs", "bench720.json")["width"] == 1280
    bench = {"workloads": [{"name": "bench720.train_long", "config": "bench720",
                            "traffic": "train_long", "chips": 1}],
             "end_to_end": [], "per_layer": []}
    run = harness.Run(bench, "bench720.train_long", 1, 0, False, "cpu", limits={})
    assert run.cfg["width"] == 1280 and run.traffic["steps_per_dispatch"] == 50


def test_for_cell_takes_listed_and_unlisted_metrics():
    ms = [{"name": "a"}, {"name": "b", "workloads": ["x"]}, {"name": "c", "workloads": ["y"]}]
    assert [m["name"] for m in harness.for_cell(ms, "x")] == ["a", "b"]
