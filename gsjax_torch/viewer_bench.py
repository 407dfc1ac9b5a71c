"""Drive the port's local viewer (``gsjax_torch.viewer.local_viewer``) over
HTTP exactly like an interactive client and log per-frame latency — the
counterpart of ``scripts/viewer_bench.py``, with the same flags plus
``--device`` (default ``cuda``).

Starts the HTTP viewer on a trained model, orbits the camera through
``--frames`` distinct viewpoints (each a fresh /render request,
JPEG-encoded server-side as a browser would get it), and reports the
latency distribution. ``--port 0`` binds any free port. The device (on
CUDA the card's name and power limit) is printed on standard error.

    python -m gsjax_torch.viewer_bench -m output/garden \\
        [--width 1920 --height 1080] [--frames 60] > viewer_frametimes.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import urllib.request

WARMUP = 3  # the first frames pay the budget probe


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-m", "--model_path", required=True)
    ap.add_argument("--iteration", type=int, default=-1)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--radius", type=float, default=7.0)
    ap.add_argument("--port", type=int, default=18931)
    ap.add_argument("--out", default=None,
                    help="write the JSON report atomically to this path "
                         "on success (crash-safe; see end of main)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda or cpu)")
    args = ap.parse_args(argv)

    from gsjax_torch.utils.system import resolve_device
    from gsjax_torch.viewer.local_viewer import viewer_from_model

    device = resolve_device(args.device)  # fail before reading anything
    if device.type == "cuda":
        from gsjax_torch.utils.profiling import card

        print(f"device: {card()}", file=sys.stderr)
    else:
        print(f"device: {device}", file=sys.stderr)
    viewer = viewer_from_model(args.model_path, iteration=args.iteration,
                               port=args.port, device=device)
    port = viewer.start()
    stats = viewer.scene_stats()
    base = f"http://127.0.0.1:{port}"

    times = []
    bytes_total = 0
    try:
        for i in range(args.frames):
            az = 2 * math.pi * i / args.frames
            ex = args.radius * math.cos(az)
            ey = args.radius * math.sin(az)
            ez = 2.5 + 0.5 * math.sin(3 * az)
            url = (
                f"{base}/render?ex={ex:.3f}&ey={ey:.3f}&ez={ez:.3f}"
                f"&tx=0&ty=0&tz=0&w={args.width}&h={args.height}"
            )
            t0 = time.perf_counter()
            with urllib.request.urlopen(url, timeout=600 if i == 0 else 120) as r:
                body = r.read()
            dt = time.perf_counter() - t0
            bytes_total += len(body)
            if i >= WARMUP:
                times.append(dt)
    finally:
        viewer.stop()

    times.sort()
    n = len(times)
    report = {
        "model": args.model_path,
        "resolution": f"{args.width}x{args.height}",
        "frames_timed": n,
        "warmup_frames": WARMUP,
        **stats,
        "mean_ms": round(sum(times) / n * 1e3, 1),
        "p50_ms": round(times[n // 2] * 1e3, 1),
        "p90_ms": round(times[int(n * 0.9)] * 1e3, 1),
        "fps_mean": round(n / sum(times), 2),
        "jpeg_kb_mean": round(bytes_total / (n + WARMUP) / 1024, 1),
        "note": "end-to-end HTTP client latency: render + JPEG encode + "
                "localhost transfer, one request in flight (interactive "
                "browser pattern)",
    }
    print(json.dumps(report, indent=1))
    if args.out:
        # written atomically, and only when the run completed: a crash
        # leaves the previous file untouched
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        with open(tmp) as f:
            json.load(f)  # round-trip guard
        os.replace(tmp, args.out)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
