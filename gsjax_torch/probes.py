"""Measured ceilings of the card at the bench scene's shapes — the
counterpart of the measurement stages of gsjax's ``scripts/_r4_session.py``
and ``scripts/_r5_session.py``.

    python -m gsjax_torch.probes --stages gather,sort,phases,bwdsplit,vpu,vpux [--out]

Each measurement is printed as one JSON line; the last line,
``{"stage": "done", ...}``, holds the launch counts of the port's kernels
in this run. With ``--out`` the ceilings also go to
``build/gsjax_torch/ceilings.json``, which ``python -m gsjax_torch.bench``
reports as ``roofline_ref``. Times are CUDA events
(``profiling.timed``: the fewest of 3 calls after a warm-up; ``phases``
the fewest of 10).

The scene is the bench's (1,000,000 gaussians at 1920x1080, compact
expansion, ``max_pairs`` 3,538,944), with ``max_tiles_per_gauss`` 128 so
that no pair is dropped (the sessions' 16 drops 16,838). Stages:

- ``gather`` (``_r4_session.py:66-91``): 4,194,304 random rows out of a
  1,000,000-row table, widths 16/9/8/4/32 float32 and 16 bfloat16, by
  ``index_select`` and by advanced indexing (``table[idx]``, the port's
  idiom, as in ``reduce_pair_grads``): Mrows/s, and the kernels PyTorch
  launched for it (its kernel choice depends on the row width).
- ``sort`` (``_r4_session.py:257-279``): the binning's sort primitive —
  ``torch.sort`` of int64 keys, then the permutation gather of the key and
  the int32 payloads (``ops/binning.py``) — at 3,538,944 rows with 2 and 5
  payloads and at 1,000,000 with 5: Mrows/s.
- ``phases`` (``_r4_session.py:175-232``, ``_r5_session.py:134-176``):
  ``profiling.phase_timings`` of the forward and forward + backward.
- ``expand`` (``_r4_session.py:93-113``): forward at tiered grid expansion
  (``tier_frac`` 0.875) against compact, both at ``max_pairs`` 2^22.
- ``snug`` (``_r4_session.py:115-173``): compact against tiered grid at
  ``max_pairs`` 3,538,944, forward and forward + backward.
- ``bwdsplit`` (``_r5_session.py:178-290``): ``composite_bwd`` alone, then
  with ``reduce_pair_grads``, and the reduction's parts at the frame's
  pair count: the stable sort of the pairs' gaussian ids, the (P, 9)
  gather into that order, and ``bincount`` + ``segment_reduce``. gsjax's
  blocked cumsum and boundary gather have no counterpart in the port's
  reduction; their lines say so.
- ``bwdwork`` (no gsjax counterpart): the backward kernel's work at the
  bench frame, counted by its plain version (``profiling.bwd_work``):
  (pair, warp) steps under the tile's and the warp's replay bound and
  after the per-warp cull, steps with a contributing lane, reduce-scatters
  and shuffles per group size, the per-tile ``n_contrib`` tail. Times
  nothing.
- ``bwdcull`` (no gsjax counterpart): what the backward kernel's per-warp
  cull is worth at the bench frame: ``composite_bwd`` and its two check
  instances (``composite_bwd_counts``, which also count each pixel's
  contributing pairs) with and without the cull, ms each.
- ``fwdwork`` (no gsjax counterpart): the forward kernels' work at the
  bench frame, counted by the training forward's plain version
  (``profiling.fwd_work``): (pair, warp) steps up to each warp's last
  exit, after the per-warp cull and with a blending lane; (pair, pixel)
  evaluations and blends. Times nothing.
- ``fwdcull`` (no gsjax counterpart): what the forward kernels' per-warp
  cull is worth at the bench frame: ``composite_infer``,
  ``composite_fwd`` and the forward's check instance without the cull
  (``composite_fwd_check``), ms each.
- ``vpu`` (``_r4_session.py:281-394``) and ``vpux``
  (``_r5_session.py:292-413``): the speed-of-light probe
  (``ops/cuda_probe.sol_probe``) at (k_ops, k_exp) = (4, 0), (40, 0) and
  (20, 0), (20, 5), (20, 10), each at 8, 24 and 48 resident warps per SM
  (``cuda_probe.OCCUPANCIES``: the first port's design, ``composite_bwd``'s
  and the forward kernels' occupancy): ms per configuration and, per
  occupancy, the skeleton's floor (the intercept of k 4 and 40), the ms
  per full-width multiply-add pass (their slope) and the float32 rate it
  gives, and the ms per exp pass (from k_exp 0 and 10) and the exp passes
  a second: the card's measured ceilings at those occupancies. The
  sessions' ``w20e0`` (``use_while=True``) is an A/B of the TPU kernel's
  loop construct; CUDA has one loop, so it is the (20, 0) instance timed
  again.

Not ported: ``exitk`` and ``chunk``, A/Bs of the Pallas kernel's loop
(``GSJAX_EXIT_CHECK_EVERY``, the saturation check's cadence) and of its
lane width (``pallas_chunk``), knobs that the CUDA kernels do not have;
the sessions' ``probe``, ``fwd`` and ``fwdbwd`` stages are the bench's.

A probe that fails fails the run: nothing is caught. Without CUDA it exits
nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

STAGES = ("gather", "sort", "phases", "expand", "snug", "bwdsplit", "bwdwork", "bwdcull",
          "fwdwork", "fwdcull", "vpu", "vpux")
MP = 3_538_944  # the bench's snug budget
MT = 128  # tiles per gaussian: drop-free at the bench scene
WIDTH, HEIGHT = 1920, 1080
GATHER_TABLE_ROWS, GATHER_ROWS = 1_000_000, 1 << 22
SORTS = ((MP, 2, "3.5Mx3ops"), (MP, 5, "3.5Mx6ops"), (1_000_000, 5, "1Mx6ops"))
SCENE = (1_000_000, 1 << 20)  # gaussians, capacity
VPU = {"k4": (4, 0), "k40": (40, 0)}
VPUX = {"f20e0": (20, 0), "f20e5": (20, 5), "f20e10": (20, 10), "w20e0": (20, 0)}


def log(rec):
    print(json.dumps(rec), flush=True)


def _round(x, nd=4):
    if isinstance(x, dict):
        return {k: _round(v, nd) for k, v in x.items()}
    return round(x, nd) if isinstance(x, float) else x


def stage_gather(timed, device):
    import torch

    from gsjax_torch.utils.profiling import kernel_names

    g = torch.Generator(device=device).manual_seed(0)
    n, p = GATHER_TABLE_ROWS, GATHER_ROWS
    idx = torch.randint(0, n, (p,), generator=g, device=device, dtype=torch.int64)
    out = {}
    for w, dt, tag in ((16, torch.float32, "16xf32"), (9, torch.float32, "9xf32"),
                       (8, torch.float32, "8xf32"), (16, torch.bfloat16, "16xbf16"),
                       (4, torch.float32, "4xf32"), (32, torch.float32, "32xf32")):
        tbl = torch.ones((n, w), dtype=dt, device=device)
        for how, fn in (("index_select", lambda eps, _t=tbl: _t.index_select(0, idx)),
                        ("indexing", lambda eps, _t=tbl: _t[idx])):
            t = timed(fn)
            out.setdefault(how, {})[tag] = p / t / 1e6
            log({"stage": "gather", "cfg": tag, "how": how, "rows": p, "ms": t * 1e3,
                 "mrows_s": p / t / 1e6, "kernels": kernel_names(fn)})
    return out


def sort_rows(keys, payloads):
    """The binning's sort primitive: the int64 keys' ascending order, then
    the permutation gather of the key and the payloads."""
    import torch

    order = torch.sort(keys).indices
    return (keys[order],) + tuple(p[order] for p in payloads)


def stage_sort(timed, device):
    import torch

    g = torch.Generator(device=device).manual_seed(1)
    out = {}
    for n_rows, n_pay, tag in SORTS:
        keys = torch.randint(0, 1 << 62, (n_rows,), generator=g, device=device)
        pays = [torch.arange(n_rows, dtype=torch.int32, device=device)] * n_pay
        t = timed(lambda eps, _k=keys, _p=pays: sort_rows(_k, _p))
        out[tag] = n_rows / t / 1e6
        log({"stage": "sort", "cfg": tag, "rows": n_rows, "ms": t * 1e3, "mrows_s": out[tag]})
    return out


def _settings(**kw):
    from gsjax_torch.ops.rasterize import RasterizeSettings

    base = dict(max_pairs=MP, backend="kernel", expansion="compact", max_tiles_per_gauss=MT)
    base.update(kw)
    return RasterizeSettings(**base)


def stage_frames(name, configs, timed, scene):
    """``expand`` / ``snug``: forward (and forward + backward of
    sum(img ** 2), as the sessions take it) per setting."""
    import torch

    from gsjax_torch.utils.profiling import frame_fns

    state, rcam, bg = scene
    for tag, settings, with_bwd in configs:
        drops = []
        fwd, fwdbwd = frame_fns(state, rcam, bg, settings, drops, reduce=torch.sum)
        t = timed(fwd)
        log({"stage": name, "cfg": tag, "ms": t * 1e3, "fps": 1 / t,
             "num_dropped": max(int(d) for d in drops)})
        if with_bwd:
            drops.clear()
            t = timed(fwdbwd)
            log({"stage": name, "cfg": tag + "_fwdbwd", "ms": t * 1e3, "fps": 1 / t,
                 "num_dropped": max(int(d) for d in drops)})


def stage_phases(scene):
    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.utils.profiling import phase_timings

    state, rcam, bg = scene
    ph = phase_timings(*activated(state), rcam, _settings(), bg=bg, active_mask=state.active)
    log({"stage": "phases", "cfg": "split", **ph})
    return ph


def _bwd_frame(scene):
    """The backward kernel's inputs at the bench frame: the forward's
    final T and n_contrib, seeded normal cotangents."""
    import torch

    from gsjax_torch.ops.cuda_composite import composite_fwd
    from gsjax_torch.utils.profiling import state_frame_inputs

    state, rcam, _ = scene
    args, _ = state_frame_inputs(state, rcam, _settings())
    tile_start, pair_gauss, attrs, tx, ty = args
    _, tT, ncon = composite_fwd(*args)
    g = torch.Generator(device=attrs.device).manual_seed(0)
    d_colors = torch.randn((tx * ty, 256, 3), generator=g, device=attrs.device)
    d_T = torch.randn((tx * ty, 256), generator=g, device=attrs.device)
    return (tile_start, pair_gauss, attrs, d_colors, d_T, tT, ncon, tx, ty)


def stage_bwdsplit(timed, scene):
    import torch

    from gsjax_torch.ops.cuda_composite import composite_bwd, reduce_pair_grads

    bwd_inputs = _bwd_frame(scene)
    tile_start, pair_gauss, attrs = bwd_inputs[:3]
    n_gauss = attrs.shape[0]

    def bwd(eps):
        return composite_bwd(*bwd_inputs)

    def bwd_full(eps):
        return reduce_pair_grads(bwd(eps), pair_gauss, tile_start, n_gauss)

    ms = {}
    for tag, fn in (("bwd_kernel_only", bwd), ("bwd_full", bwd_full)):
        ms[tag] = timed(fn) * 1e3
        log({"stage": "bwdsplit", "cfg": tag, "ms": ms[tag]})
    ms["reduction_delta"] = ms["bwd_full"] - ms["bwd_kernel_only"]
    log({"stage": "bwdsplit", "cfg": "reduction_delta", "ms": ms["reduction_delta"]})

    # the reduction's parts (reduce_pair_grads), at this frame's pair count
    num_valid = int(tile_start[-1])
    grads = bwd(0.0)
    ids = pair_gauss[:num_valid].to(torch.int64)
    g_sorted, order = torch.sort(ids, stable=True)
    rows = grads[:num_valid][order]
    parts = (
        ("stable_sort_ids", "stable torch.sort of the pairs' gaussian ids",
         lambda eps: torch.sort(ids, stable=True)),
        ("gather_p9", "(P, 9) gather of the pair gradients into that order",
         lambda eps: grads[:num_valid][order]),
        ("segment_reduce", "bincount + segment_reduce to (N, 9)",
         lambda eps: torch.segment_reduce(
             rows, "sum", lengths=torch.bincount(g_sorted, minlength=n_gauss), axis=0,
             unsafe=True)),
    )
    for tag, what, fn in parts:
        ms[tag] = timed(fn) * 1e3
        log({"stage": "bwdsplit", "cfg": tag, "what": what, "rows": num_valid,
             "ms": ms[tag], "mrows_s": num_valid / ms[tag] / 1e3})
    for tag in ("cumsum_ppad8", "boundary_gather"):
        log({"stage": "bwdsplit", "cfg": tag,
             "note": "no counterpart: gsjax's sort reduction segments by a blocked cumsum "
                     "and a boundary gather; the port sums each gaussian's rows with "
                     "segment_reduce"})
    ms["pairs"] = num_valid
    return ms


def stage_bwdwork(scene):
    from gsjax_torch.ops.cuda_composite import composite_bwd_plain
    from gsjax_torch.utils.profiling import bwd_work

    bwd = _bwd_frame(scene)
    _, n_live, stats = composite_bwd_plain(*bwd, return_evals=True)
    work = bwd_work(stats)
    log({"stage": "bwdwork", "walk_pixel_steps": int(bwd[6].long().sum()),
         "contrib_pixel_steps": int(n_live.sum()), **work})
    return work


def stage_bwdcull(timed, scene):
    from gsjax_torch.ops.cuda_composite import composite_bwd, composite_bwd_counts

    bwd = _bwd_frame(scene)
    ms = {"composite_bwd": timed(lambda eps: composite_bwd(*bwd)) * 1e3}
    for cull in (True, False):
        ms[f"counts_cull_{int(cull)}"] = timed(
            lambda eps, _c=cull: composite_bwd_counts(*bwd, cull=_c)) * 1e3
    for cfg, v in ms.items():
        log({"stage": "bwdcull", "cfg": cfg, "ms": v})
    return ms


def stage_fwdwork(scene):
    from gsjax_torch.utils.profiling import fwd_work, state_frame_inputs

    state, rcam, _ = scene
    args, _ = state_frame_inputs(state, rcam, _settings())
    work = fwd_work(*args)
    log({"stage": "fwdwork", **work})
    return work


def stage_fwdcull(timed, scene):
    from gsjax_torch.ops.cuda_composite import (
        composite_fwd, composite_fwd_check, composite_infer,
    )
    from gsjax_torch.utils.profiling import state_frame_inputs

    state, rcam, _ = scene
    args, _ = state_frame_inputs(state, rcam, _settings())
    ms = {"composite_infer": timed(lambda eps: composite_infer(*args)) * 1e3,
          "composite_fwd": timed(lambda eps: composite_fwd(*args)) * 1e3,
          "check_no_cull": timed(lambda eps: composite_fwd_check(*args)) * 1e3}
    for cfg, v in ms.items():
        log({"stage": "fwdcull", "cfg": cfg, "ms": v})
    return ms


def stage_probe(name, configs, timed, probe_inputs, warps_per_sm):
    from gsjax_torch.ops.cuda_probe import sol_probe

    tile_start, table = probe_inputs
    ms = {}
    for tag, (k_ops, k_exp) in configs.items():
        ms[tag] = timed(lambda eps, _k=(k_ops, k_exp): sol_probe(
            tile_start, table, *_k, warps_per_sm=warps_per_sm)) * 1e3
        rec = {"stage": name, "cfg": tag, "k_ops": k_ops, "k_exp": k_exp,
               "warps_per_sm": warps_per_sm, "ms": ms[tag]}
        if tag == "w20e0":
            rec["note"] = ("the TPU probe's while_loop A/B; CUDA has one loop: the (20, 0) "
                           "instance timed again")
        log(rec)
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Measured ceilings of the card "
                                             "(gsjax's measurement sessions).")
    ap.add_argument("--stages", default="gather,sort,phases,bwdsplit,vpu,vpux",
                    help=f"comma-separated, of {','.join(STAGES)}")
    ap.add_argument("--out", action="store_true",
                    help="also write the ceilings to build/gsjax_torch/ceilings.json")
    args = ap.parse_args(argv)
    stages = [s for s in args.stages.split(",") if s]
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        ap.error(f"unknown stages {unknown}; known: {STAGES}")

    import torch

    if not torch.cuda.is_available():
        print("gsjax_torch.probes: CUDA is not available; the probes measure the card",
              file=sys.stderr)
        return 2
    return run(stages, args.out, torch.device("cuda"))


def run(stages, out: bool, device) -> int:
    """The ``stages`` on ``device``, printing a line per measurement; with
    ``out`` also the ceilings file. The timing raises on a device that is
    not CUDA."""
    import torch

    from gsjax_torch.bench_scene import toy_scene
    from gsjax_torch.ops import cuda_probe as cp
    from gsjax_torch.utils.profiling import (
        card, ceilings_path, launches, launches_since, measure_rtt, sol_probe_work,
        state_frame_inputs,
    )
    from gsjax_torch.utils.profiling import timed as _timed

    rtt = measure_rtt(device)  # reported only

    def timed(fn):
        return _timed(fn, device=device)

    smi = card()
    log({"stage": "start", "rtt_ms": rtt * 1e3, "device": torch.cuda.get_device_name(device),
         "card": smi})
    state, cam = toy_scene(*SCENE, WIDTH, HEIGHT, log_scale=-5.2, device=device)
    scene = (state, cam.to_render_camera(device), torch.zeros(3, device=device))
    launched = launches()

    ceilings = {"card": smi, "source": "python -m gsjax_torch.probes"}
    if "gather" in stages:
        ceilings["gather_mrows_s"] = stage_gather(timed, device)
    if "sort" in stages:
        ceilings["sort_mrows_s"] = stage_sort(timed, device)
    if "phases" in stages:
        ceilings["phases_ms"] = stage_phases(scene)
    if "expand" in stages:
        stage_frames("expand", (
            ("grid_t875", _settings(max_pairs=1 << 22, expansion="grid", tier_frac=0.875),
             False),
            ("compact", _settings(max_pairs=1 << 22), False),
        ), timed, scene)
    if "snug" in stages:
        stage_frames("snug", (
            ("compact_snug", _settings(), True),
            ("grid_snug", _settings(expansion="grid", tier_frac=0.875), True),
        ), timed, scene)
    if "bwdsplit" in stages:
        ceilings["bwdsplit_ms"] = stage_bwdsplit(timed, scene)
    if "bwdwork" in stages:
        ceilings["bwd_work"] = stage_bwdwork(scene)
    if "bwdcull" in stages:
        ceilings["bwdcull_ms"] = stage_bwdcull(timed, scene)
    if "fwdwork" in stages:
        ceilings["fwd_work"] = stage_fwdwork(scene)
    if "fwdcull" in stages:
        ceilings["fwdcull_ms"] = stage_fwdcull(timed, scene)
    if "vpu" in stages or "vpux" in stages:
        (tile_start, *_), _ = state_frame_inputs(scene[0], scene[1], _settings())
        inputs = (tile_start, cp.sol_probe_inputs(tile_start, seed=0))
        elements = sol_probe_work(tile_start, 0, 0)[2]
        ceilings["sol_probe"] = {"elements": elements}
        for w in cp.OCCUPANCIES:
            probe = ceilings["sol_probe"][f"{w}_warps_per_sm"] = {"ms": {}}
            if "vpu" in stages:
                ms = stage_probe("vpu", VPU, timed, inputs, w)
                probe["ms"].update(ms)
                slope = (ms["k40"] - ms["k4"]) / 36
                probe["ms_per_fma_pass"] = slope
                probe["floor_ms"] = ms["k4"] - 4 * slope
                probe["f32_per_s"] = 2 * elements / (slope * 1e-3)  # measured multiply-adds
                log({"stage": "vpu", "cfg": "fit", "warps_per_sm": w,
                     "floor_ms": probe["floor_ms"], "ms_per_fma_pass": slope,
                     "f32_per_s": probe["f32_per_s"]})
            if "vpux" in stages:
                ms = stage_probe("vpux", VPUX, timed, inputs, w)
                probe["ms"].update(ms)
                probe["ms_per_exp_pass"] = (ms["f20e10"] - ms["f20e0"]) / 10
                probe["exp_pass_per_s"] = elements / (probe["ms_per_exp_pass"] * 1e-3)
                log({"stage": "vpux", "cfg": "fit", "warps_per_sm": w,
                     "ms_per_exp_pass": probe["ms_per_exp_pass"],
                     "ms_per_exp_pass_from_e5": (ms["f20e5"] - ms["f20e0"]) / 5,
                     "exp_pass_per_s": probe["exp_pass_per_s"]})

    counts = launches_since(launched, ("composite_infer", "composite_fwd",
                                       "composite_fwd_check", "composite_bwd",
                                       "composite_bwd_counts", "sol_probe"))
    if out:
        path = ceilings_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(_round(ceilings), f, indent=1)
        log({"stage": "out", "path": path})
    log({"stage": "done", "launches": counts})
    return 0


if __name__ == "__main__":
    sys.exit(main())
