"""``python -m gsbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``, from the root of a checkout that holds ``BENCHMARK.json``.

Prints the run's log and, last, each number compared beside its limit on
standard error, and one JSON line on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, last, ``checks``.
Exits 2 without a result where CUDA or the cell's cards are missing, and 3
where ``jax``, ``jaxlib``, ``flax`` or ``gsjax`` were loaded.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from gsbench import harness

    bench = harness.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"gsbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"gsbench: {args.workload} needs {need} CUDA device(s); CUDA available "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "found", file=sys.stderr)
        return 2
    out = harness.Run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda").run()
    bad = harness.forbidden_modules()
    if bad:
        print(f"gsbench: modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
