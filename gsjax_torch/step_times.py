"""Train-step times of the tree in the working directory, on one card.

    python -P /path/to/gsjax_torch/step_times.py [N] [alone|turns]   (from a tree's root)
    python -m gsjax_torch.step_times [N] [alone|turns]

The 1M-gaussian 1080p bench scene trained through ``make_train_step`` as
``chip_smoke.py`` phase 5 drives it (4 poses, targets rendered with the
base color shifted by 0.3, compact binning, ``max_pairs`` 3,538,944,
``max_tiles_per_gauss`` 128, grad_dtype float32): 4 warm-up steps, then
N float32 steps (default 24), each between two CUDA events. ``alone``
(the default) runs one step closure; ``turns`` alternates it with a
second closure at grad_dtype bfloat16, step for step, as phase 5 does,
and times the float32 steps only. Prints one JSON line: the float32
steps' median, quartiles and minimum in ms and the host's wall time per
step over all the timed steps. It imports ``gsjax_torch`` from the working
directory (``-P`` keeps the file's own directory off ``sys.path``) and
uses only what every tree of the port has had since its training slice
(a tree that ignores ``grad_dtype`` computes float32 in both closures),
so ``python -m gsjax_torch.ab_smoke OTHER --steps N`` runs this file in
another tree and in this one, in turns. Without CUDA it exits 2 and
prints nothing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import sys
import time

STEPS = 24
WARM_UP = 4
POSES = [(0.0, (0.0, 0.0, 0.0)), (0.01, (0.02, 0.0, 0.0)),
         (-0.01, (-0.02, 0.01, 0.0)), (0.0, (0.0, -0.02, 0.0))]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else STEPS
    mode = argv[1] if len(argv) > 1 else "alone"
    if mode not in ("alone", "turns"):
        print(f"step_times: unknown mode {mode!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("step_times: CUDA is not available; this times the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from gsjax_torch.bench_scene import bench_camera, toy_state
    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.data.cameras import stack_render_cameras
    from gsjax_torch.ops.rasterize import RasterizeSettings
    from gsjax_torch.train.optim import make_optimizer
    from gsjax_torch.train.step import TrainConfig, make_render_fn, make_train_step

    state = toy_state(1_000_000, 1 << 20, log_scale=-5.2, device="cuda")
    rcams = [bench_camera(1920, 1080, yaw, shift).to_render_camera("cuda")
             for yaw, shift in POSES]
    settings = RasterizeSettings(max_pairs=3_538_944, expansion="compact",
                                 max_tiles_per_gauss=128)
    cfgs = {dt: TrainConfig(settings=dataclasses.replace(settings, grad_dtype=dt), extent=3.0)
            for dt in ("float32", "bfloat16")}
    params = dict(state.params)
    params["features_dc"] = params["features_dc"].detach() + 0.3
    shifted = dataclasses.replace(state, params=params)
    render_fn = make_render_fn(cfgs["float32"], as_uint8=True)
    with torch.no_grad():
        images = torch.stack([render_fn(shifted, rc, torch.zeros(3, device="cuda"))
                              for rc in rcams])
    del shifted, params
    tx = make_optimizer(OptimizationParams(), 3.0)
    opt = tx.init(state.params)
    cams = stack_render_cameras(rcams, "cuda")
    steps = {dt: make_train_step(tx, cams, images, c) for dt, c in cfgs.items()}
    order = ["float32"] if mode == "alone" else ["float32", "bfloat16"]
    for i in range(WARM_UP):
        for dt in order:
            state, opt, _ = steps[dt](state, opt, i % len(rcams))
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(n)]
    t0 = time.perf_counter()
    for i in range(n):
        for dt in order:
            if dt == "float32":
                ev[i][0].record()
            state, opt, _ = steps[dt](state, opt, i % len(rcams))
            if dt == "float32":
                ev[i][1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / (n * len(order)) * 1e3
    ms = [a.elapsed_time(b) for a, b in ev]
    q = statistics.quantiles(ms, n=4)
    print(json.dumps({"steps": n, "mode": mode, "median_ms": statistics.median(ms),
                      "p25_ms": q[0], "p75_ms": q[2], "min_ms": min(ms),
                      "host_wall_ms": wall_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
