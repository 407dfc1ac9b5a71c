"""The numbers that decide ``correct``, each against its limit.

Training: the program's first chained dispatch (the window's own call,
replayed from the seed's state) against the reference following the same
iterations. Norms are compared leaf by leaf (the six parameter groups):
the gap between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger.
A leaf whose reference gradient is under a thousandth of the median
leaf's moves by round-off alone and is left out.

Viewing: sampled frames of the window against the reference's frame of
the same pose, quantized as the program quantizes.
"""

from __future__ import annotations

import statistics
import sys

import torch

NOUGHT = 1e-3  # a leaf's first gradient under this share of the median leaf's


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def train_norms(p0: dict, params: dict, mu: dict, nu: dict, stats: dict) -> dict:
    """The norms the training numbers compare, leaf by leaf: each group's
    change from ``p0``, Adam's two moments, and the statistics."""
    return {"change": {k: _norm(params[k] - p0[k]) for k in params},
            "mu": {k: _norm(mu[k]) for k in mu}, "nu": {k: _norm(nu[k]) for k in nu},
            "stats": {k: _norm(v) for k, v in stats.items()}}


def leaf_gap(prog: dict, ref: dict, keys) -> float:
    """Worst leaf of |prog - ref| / max(ref, median leaf ref), over norms."""
    keys = list(keys)
    if not keys:
        return 0.0
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def moving_leaves(first_grads: dict) -> list:
    med = statistics.median(first_grads.values())
    return [k for k, v in first_grads.items() if v >= NOUGHT * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: :func:`train_norms` with ``loss_mean`` and
    ``loss_last``; ``ref`` also ``first_grads`` (norms by leaf)."""
    keys = moving_leaves(ref["first_grads"])
    loss = max(abs(prog["loss_mean"] - ref["loss_mean"]) / abs(ref["loss_mean"]),
               abs(prog["loss_last"] - ref["loss_last"]) / abs(ref["loss_last"]))
    moments = max(leaf_gap(prog["mu"], ref["mu"], keys), leaf_gap(prog["nu"], ref["nu"], keys))
    stats = max(abs(prog["stats"][k] - ref["stats"][k]) / max(ref["stats"][k], 1e-30)
                for k in ref["stats"])
    print(f"leaves (program, reference): change {[(k, prog['change'][k], ref['change'][k]) for k in keys]}; "
          f"mu {[(k, prog['mu'][k], ref['mu'][k]) for k in keys]}; "
          f"nu {[(k, prog['nu'][k], ref['nu'][k]) for k in keys]}; "
          f"stats {[(k, prog['stats'][k], ref['stats'][k]) for k in ref['stats']]}; "
          f"first gradients {ref['first_grads']}", file=sys.stderr, flush=True)
    return {"loss_gap": loss, "change_gap": leaf_gap(prog["change"], ref["change"], keys),
            "moment_gap": moments, "stats_gap": stats}


def frame_numbers(frames: list) -> dict:
    """``frames``: (program uint8, reference uint8) pairs of one pose each.
    ``px_off``: the worst frame's share of channels more than one level
    apart; ``mean_off``: the worst frame's mean absolute difference in
    levels."""
    px, mean = 0.0, 0.0
    for prog, ref in frames:
        d = (prog.to(torch.int16) - ref.to(prog.device).to(torch.int16)).abs()
        px = max(px, float((d > 1).double().mean()))
        mean = max(mean, float(d.double().mean()))
    return {"px_off": px, "mean_off": mean}


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, [[name, value, limit], ...])``: every number at or under
    its limit. A number that is not finite fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        lim = limits[name]
        good = value == value and value <= lim
        ok = ok and good
        rows.append([name, value, lim])
    return ok, rows
