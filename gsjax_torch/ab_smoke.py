"""Two trees of this repository on one card, in turns: the A/B of a
kernel change.

    python -m gsjax_torch.ab_smoke OTHER_TREE [--logs DIR]

Runs ``python3 chip_smoke.py`` from the root of OTHER_TREE (``A``, the
tree compared against, e.g. the parent commit unpacked by ``git archive
<commit> | tar -x -C build/ab/parent``) and from the root of this
checkout (``B``) in turns, A, B, B, A: a drift of the card or the host
shows as a difference between the two runs of one tree. Each run's
output goes to ``DIR/<i>_<A|B>.log`` (default ``build/ab/logs`` of this
checkout). Then one JSON line per run: the tree, exit code,
seconds, the card's name and power limit, ``composite_bwd`` ms, the
frame and step median and p75, the training split (one step's phases),
the device's busy share of the traced training window, the per-kernel
ms of the kernels line and each backward kernel instance's registers,
shared memory and spills (``-Xptxas -v``, printed when chip_smoke
builds a tree's kernels, so in its first run when nothing was built
before). Last, one JSON line ``{"ab": "done", "failed": [...]}``; the
exit code is nonzero when a run failed.

Needs a card, as chip_smoke.py does; the runs are sequential, so one
card serves all four. Imports neither torch nor JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 1200  # chip_smoke's own limit
ORDER = "ABBA"

_NUM = r"([0-9.]+)"
PATTERNS = {
    "card": re.compile(r"^card: (.+)$"),
    "composite_bwd_ms": re.compile(r"composite_bwd " + _NUM + r" ms \(plain"),
    "frame": re.compile(r"frame ms \(CUDA events, n=\d+\): median " + _NUM + r", p75 " + _NUM),
    "step": re.compile(r"step ms \(CUDA events, n=\d+\): median " + _NUM + r", p75 " + _NUM),
    "busy": re.compile(r"device busy " + _NUM + r" ms of a " + _NUM
                       + r" ms window, busy share " + _NUM),
    "split": re.compile(r"one step's phases, ms: (.+)$"),
    "total_s": re.compile(r"^total " + _NUM + r" s$"),
}
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers, .*?(\d+) bytes smem")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def parse_log(text: str) -> dict:
    """The numbers of one chip_smoke.py output (see the module's
    docstring); a key is missing when its line is."""
    out: dict = {}
    bwd_regs = {}
    entry = None
    for line in text.splitlines():
        s = line.strip()
        m = _ENTRY.search(s)
        if m:
            entry = m.group(1)
            continue
        m = _SPILL.search(s)
        if m and entry and "composite_bwd" in entry:
            bwd_regs.setdefault(entry, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            continue
        m = _USED.search(s)
        if m and entry and "composite_bwd" in entry:
            bwd_regs.setdefault(entry, {}).update(registers=int(m.group(1)),
                                                  smem_bytes=int(m.group(2)))
            continue
        if s.startswith('{"kernels"'):
            out["kernels_ms"] = {k["name"]: k["ms"] for k in json.loads(s)["kernels"]}
            continue
        for key, pat in PATTERNS.items():
            m = pat.search(s)
            if not m:
                continue
            if key == "card":
                out["card"] = m.group(1)
            elif key == "split":
                parts = m.group(1).split("; sum")[0].split(", ")
                out["split"] = {k.strip(): float(v) for k, v in
                                (part.rsplit(" ", 1) for part in parts)}
            elif key in ("frame", "step"):
                out[f"{key}_median_ms"], out[f"{key}_p75_ms"] = map(float, m.groups())
            elif key == "busy":
                out["busy_ms"], out["window_ms"], out["busy_share"] = map(float, m.groups())
            else:
                out[key] = float(m.group(1))
    if bwd_regs:
        out["bwd_instances"] = {_short(k): v for k, v in bwd_regs.items()}
    return out


def _short(mangled: str) -> str:
    """``composite_bwd_kernel<template arguments>`` from a mangled name:
    the template argument part as the compiler mangled it (``ILb1ELb0EE``:
    two bools, 1 and 0)."""
    m = re.search(r"composite_bwd_kernel(I.*?E)E", mangled)
    return "composite_bwd_kernel" + (m.group(1) if m else "")


def run_tree(root: str, log_path: str) -> dict:
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             timeout=RUN_TIMEOUT_S)
        rc, text = res.returncode, res.stdout
    except subprocess.TimeoutExpired as e:
        rc, text = 124, e.stdout or ""
        if isinstance(text, bytes):
            text = text.decode(errors="replace")
    with open(log_path, "w") as f:
        f.write(text)
    return {"rc": rc, "seconds": time.perf_counter() - t0, **parse_log(text)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the tree compared against (A)")
    ap.add_argument("--logs", default=os.path.join(HERE, "build", "ab", "logs"),
                    help="directory for each run's output")
    args = ap.parse_args(argv)
    if not os.path.isfile(os.path.join(args.other, "chip_smoke.py")):
        print(f"ab_smoke: no chip_smoke.py in {args.other}", file=sys.stderr)
        return 2
    os.makedirs(args.logs, exist_ok=True)
    roots = {"A": os.path.abspath(args.other), "B": HERE}
    failed = []
    for i, tree in enumerate(ORDER):
        log_path = os.path.join(args.logs, f"{i}_{tree}.log")
        rec = run_tree(roots[tree], log_path)
        print(json.dumps({"run": i, "tree": tree, "root": roots[tree], "log": log_path, **rec}),
              flush=True)
        if rec["rc"] != 0:
            failed.append(i)
    print(json.dumps({"ab": "done", "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
