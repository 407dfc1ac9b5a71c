"""The sharded training CLI on the CPU: ``python -m gsjax_torch.train
--device cpu --gauss_shards 2 --dist_*`` on two gloo ranks against the
port's single-rank run of the same flags, on the fixture scene of
tests/fixtures.py (64x64). 20 iterations: densifications at 5 and 10 with
a capacity growth, an opacity reset at 15, an evaluation at 20. The two
runs go side by side; gsjax's sharded ``training`` is not run here (its
cold XLA compiles would take minutes)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
FLAGS = ["--device", "cpu", "--disable_viewer", "--eval", "--quiet", "--iterations", "20",
         "--densify_from_iter", "4", "--densification_interval", "5",
         "--densify_until_iter", "12", "--opacity_reset_interval", "15",
         "--test_iterations", "20", "--capacity", "64", "--steps_per_dispatch", "4",
         "--percent_dense", "1.0"]


def _log(model):
    with open(os.path.join(model, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from fixtures import make_blender_scene
    from gsjax_torch.parallel.multihost import spawn_ranks

    tmp = tmp_path_factory.mktemp("cli")
    scene = str(tmp / "scene")
    make_blender_scene(scene, n_train=12, n_test=3, width=64, height=64)
    single_dir, sharded_dir = str(tmp / "single"), str(tmp / "sharded")
    cmd = [sys.executable, "-m", "gsjax_torch.train", "-s", scene]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with subprocess.Popen(cmd + ["-m", single_dir, *FLAGS], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) as single:
        try:
            sharded = spawn_ranks(cmd + ["-m", sharded_dir, *FLAGS, "--gauss_shards", "2"], 2,
                                  TIMEOUT_S, cwd=ROOT, threads=1)
            out, err = single.communicate(timeout=TIMEOUT_S)
        finally:
            single.kill()
    assert single.returncode == 0, err[-3000:]
    return {
        "single": (json.loads(out.strip().splitlines()[-1]), _log(single_dir)),
        "sharded": [json.loads(r.stdout.strip().splitlines()[-1]) for r in sharded],
        "sharded_log": _log(sharded_dir),
        "sharded_dir": sharded_dir,
    }


def test_sharded_cli_trains_like_the_single_rank_run(runs):
    single, records = runs["single"]
    dens = {r["iter"]: r["num_active"] for r in records if r.get("event") == "densify"}
    s_dens = {r["iter"]: r["num_active"] for r in runs["sharded_log"]
              if r.get("event") == "densify"}
    assert set(dens) == set(s_dens) == {5, 10}
    for it, n in dens.items():  # float reassociation may flip a threshold decision
        assert abs(s_dens[it] - n) <= max(1, 0.02 * n), (it, s_dens[it], n)
    assert any(r.get("event") == "capacity_growth" for r in runs["sharded_log"])
    psnr = [r["eval"]["test"]["psnr"] for r in records if "eval" in r]
    s_psnr = [r["eval"]["test"]["psnr"] for r in runs["sharded_log"] if "eval" in r]
    assert len(psnr) == len(s_psnr) == 1
    assert abs(s_psnr[0] - psnr[0]) < 0.2, (s_psnr, psnr)


def test_sharded_cli_ranks_agree_and_rank0_writes(runs):
    ranks = runs["sharded"]
    assert [d["rank"] for d in ranks] == [0, 1]
    assert all(d["stage"] == "done" and d["iterations"] == 20 for d in ranks)
    # the returned state is the whole one on every rank
    assert ranks[0]["num_active"] == ranks[1]["num_active"]
    assert ranks[0]["capacity"] == ranks[1]["capacity"] == runs["single"][0]["capacity"]
    sharded_dir = runs["sharded_dir"]
    assert os.path.exists(os.path.join(sharded_dir, "point_cloud", "iteration_20",
                                       "point_cloud.ply"))
    assert os.path.exists(os.path.join(sharded_dir, "cameras.json"))


def test_scaling_bench_mechanics_on_the_cpu():
    """``python -m gsjax_torch.scaling_bench --device cpu`` at gauss 1 and
    2: a rate for each and the note that ranks sharing a device give no
    scaling efficiency (here the CPU)."""
    res = subprocess.run(
        [sys.executable, "-m", "gsjax_torch.scaling_bench", "--device", "cpu", "--gauss", "1",
         "2", "--gaussians", "2000", "--capacity", "4096", "--width", "64", "--height", "48",
         "--steps", "2"], cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(report["steps_per_s"]) == {"1", "2"}
    assert all(v > 0 for v in report["steps_per_s"].values())
    assert report["backend"] == {"1": "gloo", "2": "gloo"}
    assert report["num_dropped_pairs"] == {"1": 0, "2": 0}
    assert "efficiency" not in report and "no scaling efficiency" in report["note"]
