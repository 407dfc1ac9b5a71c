"""Render-frame times of the tree in the working directory, on one card.

    python -P /path/to/gsjax_torch/frame_times.py [N]   (from a tree's root)
    python -m gsjax_torch.frame_times [N]

The 1M-gaussian 1080p bench scene through ``make_render_fn`` (as
``chip_smoke.py`` phase 4 drives it: 4 poses, compact binning,
``max_pairs`` 3,538,944, ``max_tiles_per_gauss`` 128), one warm-up frame
per pose, then N frames (default 200), each between two CUDA events.
Prints one JSON line: the frames' median, quartiles and minimum in ms, the
host's wall time per frame, the composite_infer launches and the dropped
pairs. It imports ``gsjax_torch`` from the working directory (``-P``
keeps the file's own directory off ``sys.path``), and uses
only what every tree of the port has had since its bench scene, so
``python -m gsjax_torch.ab_smoke OTHER --frames N`` runs this file in
another tree (the parent) and in this one, in turns. Without CUDA it exits
2 and prints nothing.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

FRAMES = 200
POSES = [(0.0, (0.0, 0.0, 0.0)), (0.01, (0.02, 0.0, 0.0)),
         (-0.01, (-0.02, 0.01, 0.0)), (0.0, (0.0, -0.02, 0.0))]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else FRAMES
    import torch

    if not torch.cuda.is_available():
        print("frame_times: CUDA is not available; this times the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from gsjax_torch.bench_scene import bench_camera, toy_state
    from gsjax_torch.ops import cuda_composite
    from gsjax_torch.ops.rasterize import RasterizeSettings
    from gsjax_torch.train.step import TrainConfig, make_render_fn

    state = toy_state(1_000_000, 1 << 20, log_scale=-5.2, device="cuda")
    rcams = [bench_camera(1920, 1080, yaw, shift).to_render_camera("cuda")
             for yaw, shift in POSES]
    settings = RasterizeSettings(max_pairs=3_538_944, expansion="compact",
                                 max_tiles_per_gauss=128)
    render_fn = make_render_fn(TrainConfig(settings=settings), with_stats=True)
    bg = torch.zeros(3, device="cuda")
    for rc in rcams:
        render_fn(state, rc, bg)
    torch.cuda.synchronize()
    cuda_composite.composite_infer.launches = 0
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(n)]
    drops = []
    t0 = time.perf_counter()
    for i in range(n):
        ev[i][0].record()
        drops.append(render_fn(state, rcams[i % len(rcams)], bg)[1])
        ev[i][1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    ms = [a.elapsed_time(b) for a, b in ev]
    q = statistics.quantiles(ms, n=4)
    print(json.dumps({"frames": n, "median_ms": statistics.median(ms), "p25_ms": q[0],
                      "p75_ms": q[2], "min_ms": min(ms), "host_wall_ms": wall_ms,
                      "launches": cuda_composite.composite_infer.launches,
                      "num_dropped": max(int(d) for d in drops)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
