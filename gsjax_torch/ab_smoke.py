"""Two trees of this repository on one card, in turns: the A/B of a
kernel change.

    python -m gsjax_torch.ab_smoke OTHER_TREE [--logs DIR]
    python -m gsjax_torch.ab_smoke OTHER_TREE --frames N

Runs ``python3 chip_smoke.py`` from the root of OTHER_TREE (``A``, the
tree compared against, e.g. the parent commit unpacked by ``git archive
<commit> | tar -x -C build/ab/parent``) and from the root of this
checkout (``B``) in turns, A, B, B, A: a drift of the card or the host
shows as a difference between the two runs of one tree. Each run's
output goes to ``DIR/<i>_<A|B>.log`` (default ``build/ab/logs`` of this
checkout). Then one JSON line per run: the tree, exit code,
seconds, the card's name and power limit, ``composite_bwd``,
``composite_infer`` and ``composite_fwd`` ms, the frame and step median
and p75, the training split (one step's phases), the device's busy share
of the traced training window, the per-kernel ms of the kernels line and
each backward and forward kernel instance's registers, shared memory and
spills (``bwd_instances``, ``fwd_instances``; ``-Xptxas -v``, printed
when chip_smoke builds a tree's kernels, so in its first run when nothing
was built before). Last, one JSON line ``{"ab": "done", "failed": [...]}``; the
exit code is nonzero when a run failed.

With ``--frames N`` it runs ``gsjax_torch/frame_times.py`` of this
checkout in each tree instead, A, B, B, A twice: N render frames of the
bench scene each, so that the frame median, which chip_smoke's 40 frames
leave to the host's noise, is compared on its own. ``--steps N`` does the
same with ``gsjax_torch/step_times.py``: N float32 train steps, with one
step closure (``--mode alone``) or two in turns (``--mode turns``, phase
5's order). One JSON line per run (the tree, exit code and the script's
line), then the ``done`` line. ``--b TREE`` puts another tree in B's place
(two older trees against each other).

Needs a card, as chip_smoke.py does; the runs are sequential, so one
card serves them all. Imports neither torch nor JAX.
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
FRAMES_SCRIPT = os.path.join(HERE, "gsjax_torch", "frame_times.py")
STEPS_SCRIPT = os.path.join(HERE, "gsjax_torch", "step_times.py")

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
# kernel families whose instances' -Xptxas -v figures are kept, by key
_FAMILIES = {"bwd_instances": "composite_bwd_kernel", "fwd_instances": "composite_blend_kernel"}


def parse_log(text: str) -> dict:
    """The numbers of one chip_smoke.py output (see the module's
    docstring); a key is missing when its line is."""
    out: dict = {}
    regs = {family: {} for family in _FAMILIES}
    entry = family = None
    for line in text.splitlines():
        s = line.strip()
        m = _ENTRY.search(s)
        if m:
            entry = m.group(1)
            family = next((k for k, fam in _FAMILIES.items() if fam in entry), None)
            continue
        m = _SPILL.search(s)
        if m and family:
            regs[family].setdefault(entry, {})["spill_bytes"] = (int(m.group(1))
                                                                 + int(m.group(2)))
            continue
        m = _USED.search(s)
        if m and family:
            regs[family].setdefault(entry, {}).update(registers=int(m.group(1)),
                                                      smem_bytes=int(m.group(2)))
            continue
        if s.startswith('{"kernels"'):
            out["kernels_ms"] = {k["name"]: k["ms"] for k in json.loads(s)["kernels"]}
            for name in ("composite_infer", "composite_fwd"):
                if name in out["kernels_ms"]:
                    out[f"{name}_ms"] = out["kernels_ms"][name]
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
    for family, found in regs.items():
        if found:
            out[family] = {_short(k, _FAMILIES[family]): v for k, v in found.items()}
    return out


def _short(mangled: str, family: str) -> str:
    """``<family><template arguments>`` from a mangled name: the template
    argument part as the compiler mangled it (``ILb1ELb0E``: two bools, 1
    and 0)."""
    m = re.search(family + r"(I.*?E)E", mangled)
    return family + (m.group(1) if m else "")


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


def run_frames(root: str, frames: int, script: str = "", *args) -> dict:
    """``script`` (default :data:`FRAMES_SCRIPT`) with the tree ``root`` as
    working directory."""
    res = subprocess.run([sys.executable, "-P", script or FRAMES_SCRIPT, str(frames), *args],
                         cwd=root,
                         capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    lines = res.stdout.strip().splitlines()
    rec = {"rc": res.returncode}
    if res.returncode == 0 and lines:
        rec.update(json.loads(lines[-1]))
    else:
        rec["stderr"] = res.stderr[-2000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the tree compared against (A)")
    ap.add_argument("--logs", default=os.path.join(HERE, "build", "ab", "logs"),
                    help="directory for each run's output")
    ap.add_argument("--frames", type=int, default=0,
                    help="time N render frames in each tree instead of chip_smoke.py")
    ap.add_argument("--steps", type=int, default=0,
                    help="time N train steps in each tree instead of chip_smoke.py")
    ap.add_argument("--mode", choices=("alone", "turns"), default="alone",
                    help="--steps: one step closure, or two in turns")
    ap.add_argument("--b", default=HERE, help="root of the tree in B's place")
    args = ap.parse_args(argv)
    roots = {"A": os.path.abspath(args.other), "B": os.path.abspath(args.b)}
    for root in roots.values():
        if not os.path.isfile(os.path.join(root, "chip_smoke.py")):
            print(f"ab_smoke: no chip_smoke.py in {root}", file=sys.stderr)
            return 2
    failed = []
    short = args.frames or args.steps
    for i, tree in enumerate(ORDER * 2 if short else ORDER):
        if args.frames:
            rec = {"root": roots[tree], **run_frames(roots[tree], args.frames)}
        elif args.steps:
            rec = {"root": roots[tree], **run_frames(roots[tree], args.steps, STEPS_SCRIPT,
                                                     args.mode)}
        else:
            os.makedirs(args.logs, exist_ok=True)
            log_path = os.path.join(args.logs, f"{i}_{tree}.log")
            rec = {"root": roots[tree], "log": log_path, **run_tree(roots[tree], log_path)}
        print(json.dumps({"run": i, "tree": tree, **rec}), flush=True)
        if rec["rc"] != 0:
            failed.append(i)
    print(json.dumps({"ab": "done", "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
