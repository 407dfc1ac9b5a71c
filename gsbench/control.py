"""The control of ``correct``: the reference put in the program's place
and computed one precision lower (bfloat16 for the configuration's
float32), or with a planted fault, read by the same numbers against the
float32 reference. It must come out not correct.

``python -m gsbench.control --workload <name> --seeds 1,2,3 [--fault F]``
prints one JSON line a seed with the numbers. Faults: ``bf16`` (the
control), ``half_image`` (the loss over the image's top half, its mean
over the rest), ``frozen`` (Adam skipped: the state comes back unchanged)
for training cells; ``bf16`` and ``tile_zero`` (a 16x16 tile of the frame
zeroed where it is produced) for viewing cells. Set-up is the benchmark
run's own (``harness.Run``); no window is measured.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys

import torch

from gsbench import harness
from gsbench.reference import compare
from gsbench.reference import render as R
from gsbench.reference import train as RT


@contextlib.contextmanager
def half_image_loss():
    full = RT.loss_fn

    def half(img, gt, lambda_dssim=0.2):
        h = img.shape[0] // 2
        return full(img[:h], gt[:h], lambda_dssim)

    RT.loss_fn = half
    try:
        yield
    finally:
        RT.loss_fn = full


@contextlib.contextmanager
def frozen_adam():
    full = RT.adam_

    def skip(params, grads, mu, nu, count, lrs):
        return None

    RT.adam_ = skip
    try:
        yield
    finally:
        RT.adam_ = full


def train_readings(run: harness.Run, fault: str) -> dict:
    """The control's numbers on ``run``'s cell and seed."""
    tr = run.traffic
    sc = run.scene()
    state = run.program_state(sc)
    ref_cams, _, host = run.cameras(sc["train_poses"])
    w, h = run.cfg["width"], run.cfg["height"]
    settings = run.settings(run.cfg["train_budgets"], state, host, w, h, train=True)
    run.tie = harness.tie_of(settings, state.capacity)
    del state
    targets = run.render_targets(sc, ref_cams, run.tie)
    order = harness.shuffled_stack(run.seed, len(ref_cams))
    cams0 = [next(order) for _ in range(tr["steps_per_dispatch"])]
    p0, active = sc["params"], sc["active"]
    bg = torch.tensor(tr["background"], dtype=torch.float32, device=run.dev)
    args = (p0, active, ref_cams, targets, cams0, bg, sc["sh_degree"], run.tie,
            tr["optimizer"], float(sc["extent"]), tr["start_iteration"])
    with harness.tf32_off():
        rp, rmu, rnu, rst, losses, first = RT.run(*args)
        ref = compare.train_norms(p0, rp, rmu, rnu, rst)
        ref.update(loss_mean=statistics.fmean(losses), loss_last=losses[-1], first_grads=first)
        del rp, rmu, rnu, rst
        dtype = torch.bfloat16 if fault == "bf16" else torch.float32
        with (half_image_loss() if fault == "half_image" else
              frozen_adam() if fault == "frozen" else contextlib.nullcontext()):
            cp, cmu, cnu, cst, closs, _ = RT.run(*args, dtype=dtype)
        ctl = compare.train_norms(p0, {k: v.float() for k, v in cp.items()}, cmu, cnu, cst)
    ctl.update(loss_mean=statistics.fmean(closs), loss_last=closs[-1])
    return compare.train_numbers(ctl, ref)


def view_readings(run: harness.Run, fault: str) -> dict:
    tr = run.traffic
    sc = run.scene()
    state = run.program_state(sc)
    ref_cams, _, host = run.cameras(sc["view_poses"])
    w, h = ref_cams[0]["width"], ref_cams[0]["height"]
    settings = run.settings(run.cfg["view_budgets"], state, host, w, h, train=False)
    run.tie = harness.tie_of(settings, state.capacity)
    del state
    path = sc["view_path"](run.seed)
    at = sorted(harness.sample_positions(run.seed, tr["sample_mean_gap"], tr["sample_max"]))
    poses, i = [], 0
    while at and i < at[-1]:
        k = next(path)
        i += 1
        if i in at:
            poses.append(k)
    bg = torch.tensor(tr["background"], dtype=torch.float32, device=run.dev)
    pairs = []
    with harness.tf32_off():
        for k in poses:
            ref = R.quantize_u8(R.render(sc["params"], sc["active"], ref_cams[k], bg,
                                         sc["sh_degree"], run.tie)[0])
            if fault == "bf16":
                p16 = {n: v.to(torch.bfloat16) for n, v in sc["params"].items()}
                out = R.quantize_u8(R.render(p16, sc["active"], ref_cams[k], bg,
                                             sc["sh_degree"], run.tie)[0].float())
            else:
                out = ref.clone()
                out[:16, :16] = 0
            pairs.append((out, ref))
    return compare.frame_numbers(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control of gsbench's correct")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default="bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gsbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(bench, args.workload, seed, 0.0, False, "cuda")
        read = train_readings if run.traffic["kind"] == "train" else view_readings
        nums = read(run, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          **nums}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
