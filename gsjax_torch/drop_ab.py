"""Residual-drop A/B: ``python -m gsjax_torch.drop_ab``.

Counterpart of gsjax's ``scripts/drop_ab.py``: what steady-state pair drops
cost in PSNR. Both arms resume the same ``chkpnt<from_iter>.npz`` and train
to ``--to_iter`` with the same seed through ``python -m gsjax_torch.train``;
the big arm scales every probed pair budget by ``--mult`` through
``GSJAX_PAIR_BUDGET_MULT`` (``train/loop.py``), the baseline arm by
``--mult_baseline`` when given (below 1 it forces drops that the probed
budget would not have). ``python -m gsjax_torch.render`` and ``python -m
gsjax_torch.metrics`` then score both. The report has gsjax's keys: each
arm's ``results.json`` and its ``train_log.jsonl`` tail (mean and max
``dropped_pairs``, mean it/s, from the records at or after ``from_iter``),
and ``psnr_cost_of_drops`` (big arm's PSNR - baseline's).

The trainer reacts to a dropped pair by doubling the budget, and a
``--quiet`` run logs ``dropped_pairs`` every 100 iterations: a forced drop
heals within the first dispatch and shows in the log as a
``pair_overflow`` record. ``--device`` (default ``cuda``) goes to every
subprocess. The report goes to ``--out`` (default
``output/quality/<scene>/drop_ab.json``).

    python -m gsjax_torch.drop_ab -s data/garden1m -m output/garden1m \\
        [--from_iter 28000] [--to_iter 30000] [--mult 2] [--mult_baseline 0.55]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(cmd, env=None):
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, env={**os.environ, **(env or {})}, cwd=REPO)


def tail_metrics(model_dir, from_iter, log_name="train_log.jsonl"):
    """Mean and max dropped pairs and mean it/s over the A/B window."""
    drops, its = [], []
    path = os.path.join(model_dir, log_name)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("iter", 0) >= from_iter:
                drops.append(rec.get("dropped_pairs", 0))
                its.append(rec.get("it_per_s"))
    if not drops:
        return {}
    return {
        "mean_dropped_pairs": sum(drops) / len(drops),
        "max_dropped_pairs": max(drops),
        "mean_it_per_s": sum(x for x in its if x) / max(1, sum(1 for x in its if x)),
    }


def build_parser():
    ap = argparse.ArgumentParser(description="gsjax_torch residual-drop A/B")
    ap.add_argument("-s", "--source", required=True)
    ap.add_argument("-m", "--model", required=True,
                    help="trained model dir containing chkpnt<iter>.npz")
    ap.add_argument("--from_iter", type=int, default=28000)
    ap.add_argument("--to_iter", type=int, default=30000,
                    help="train both arms to this iteration (passed as --iterations)")
    ap.add_argument("--mult", type=float, default=2.0)
    ap.add_argument("--mult_baseline", type=float, default=None,
                    help="pair-budget multiplier for the baseline arm (e.g. 0.55 forces "
                         "drops when the probed budget never saturates)")
    ap.add_argument("--out", default=None,
                    help="report path (default output/quality/<scene>/drop_ab.json)")
    ap.add_argument("--device", default="cuda", help="cuda or cpu, for every subprocess")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    source, model = os.path.abspath(args.source), os.path.abspath(args.model)
    ckpt = os.path.join(model, f"chkpnt{args.from_iter}.npz")
    if not os.path.exists(ckpt):
        raise SystemExit(f"missing {ckpt}")
    out_path = os.path.abspath(args.out or os.path.join(
        "output", "quality", os.path.basename(source.rstrip("/")), "drop_ab.json"))

    results = {"from_iter": args.from_iter, "to_iter": args.to_iter, "mult": args.mult,
               "mult_baseline": args.mult_baseline, "arms": {}}
    base_env = ({"GSJAX_PAIR_BUDGET_MULT": str(args.mult_baseline)}
                if args.mult_baseline else {})
    py = sys.executable
    for arm, env in (("baseline", base_env),
                     ("big_budget", {"GSJAX_PAIR_BUDGET_MULT": str(args.mult)})):
        out = model + f"_dropab_{arm}"
        shutil.rmtree(out, ignore_errors=True)
        run([py, "-m", "gsjax_torch.train", "-s", source, "-m", out, "--eval",
             "--start_checkpoint", ckpt, "--iterations", str(args.to_iter),
             "--test_iterations", str(args.to_iter), "--save_iterations", str(args.to_iter),
             "--quiet", "--disable_viewer", "--device", args.device], env=env)
        run([py, "-m", "gsjax_torch.render", "-m", out, "--skip_train", "--quiet",
             "--device", args.device])
        run([py, "-m", "gsjax_torch.metrics", "-m", out, "--device", args.device])
        with open(os.path.join(out, "results.json")) as f:
            res = json.load(f)
        results["arms"][arm] = {"results": res, **tail_metrics(out, args.from_iter)}

    b = results["arms"]["baseline"]["results"].get(f"ours_{args.to_iter}", {})
    g = results["arms"]["big_budget"]["results"].get(f"ours_{args.to_iter}", {})
    if b and g:
        results["psnr_cost_of_drops"] = round(g.get("PSNR", 0) - b.get("PSNR", 0), 4)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))
    print("wrote", out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
