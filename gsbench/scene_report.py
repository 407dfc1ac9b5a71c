"""``python -m gsbench.scene_report --config <name> --seed <n> [--set key=json ...]``:
what a configuration's scene asks of the budgets, over every training pose.

Prints one JSON line: the footprints (``tiles_touched``) of the visible
gaussians of all poses together (median, 99th percentile, largest, the
share at 4 tiles or fewer), the pairs a view (least, median, most), the
widest footprint and the most pairs of the four poses that gsjax's probe
samples beside those of every pose, and the share of pixels whose final
transmittance is above 0.1, rendered by the program under the trainer's
own budgets (``harness.Run.settings``), with the pairs they dropped.
``--set`` overrides a key of the configuration (say ``sigma_px=2.5``).
Runs on the card, or with ``--device cpu`` at a size the CPU holds.
"""

from __future__ import annotations

import argparse
import json
import sys


def report(run, device) -> dict:
    import torch

    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.ops.projection import preprocess
    from gsjax_torch.ops.rasterize import render

    sc = run.scene()
    state = run.program_state(sc)
    _, rcams, host = run.cameras(sc["train_poses"])
    w, h = run.cfg["width"], run.cfg["height"]
    settings = run.settings(run.cfg["train_budgets"], state, host, w, h, train=True)
    attrs = activated(state)
    top = 1 << 16
    hist = torch.zeros(top + 1, dtype=torch.int64, device=device)
    pairs, widest, t_high, pixels, dropped = [], [], 0, 0, 0
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        for rc in rcams:
            tt = preprocess(*attrs, rc, state.active_sh_degree,
                            active_mask=state.active).tiles_touched.to(torch.int64)
            tt = tt[tt > 0]
            hist += torch.bincount(tt.clamp_max(top), minlength=top + 1)
            pairs.append(int(tt.sum()))
            widest.append(int(tt.max()))
            out = render(rc, *attrs, state.active_sh_degree, bg, settings,
                         active_mask=state.active)
            t_high += int((out["final_T"] > 0.1).sum())
            pixels += out["final_T"].numel()
            dropped += int(out["num_dropped"])
    cum = hist.cumsum(0)
    total = int(cum[-1])

    def quantile(q):
        return int(torch.searchsorted(cum, torch.tensor(q * total, device=device,
                                                        dtype=torch.float64).ceil().long()))

    four = list(range(len(rcams)))[:: max(1, len(rcams) // 4)][:4]
    srt = sorted(pairs)
    return {"config": run.cfg["name"], "seed": run.seed, "views": len(rcams),
            "footprint_median": quantile(0.5), "footprint_p99": quantile(0.99),
            "footprint_max": max(widest), "share_le_4_tiles": int(cum[4]) / total,
            "pairs_min": srt[0], "pairs_median": srt[len(srt) // 2], "pairs_max": srt[-1],
            "widest_view": widest.index(max(widest)), "most_pairs_view": pairs.index(srt[-1]),
            "four_poses": four, "four_footprint_max": max(widest[i] for i in four),
            "four_pairs_max": max(pairs[i] for i in four),
            "share_T_above_0.1": t_high / pixels, "dropped_pairs": dropped,
            "settings": {k: getattr(settings, k) for k in (
                "max_pairs", "max_tiles_per_gauss", "tier_frac", "expansion")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from gsbench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("gsbench.scene_report: needs a CUDA device", file=sys.stderr)
        return 2
    cfg = harness.load_json("configs", f"{args.config}.json")
    for kv in args.set:
        key, value = kv.split("=", 1)
        cfg[key] = json.loads(value)
    bench = harness.benchmark()
    cell = {"name": f"{args.config}.report", "config": args.config, "traffic": "train"}
    bench = {**bench, "workloads": [cell]}
    run = harness.Run(bench, cell["name"], args.seed, 0.0, False, args.device, limits={},
                      config=cfg)
    print(json.dumps(report(run, run.dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
