"""The tile-strip design's work split across ranks: ``python -m
gsjax_torch.multichip_split``.

Counterpart of gsjax's ``scripts/multichip_split.py``. G ranks (one process
each, ``parallel.multihost.spawn_ranks``; gloo when they share a card or run
on the CPU) run the port's own sharded path up to binning
(``parallel.shard._strip_bins``: preprocess of the rank's rows, the splat
exchange, the binning of its strip) at gsjax's operating point: the bench
scene (``bench_scene``, 1M gaussians, log scale -5.2) at 1920x1080, the
1-chip budget ``max_pairs`` 3,538,944 split G ways with
``--strip_budget_mult`` headroom (128-aligned), the compact expansion,
gsjax's default ``max_tiles_per_gauss`` 16. Each rank's counts carry
gsjax's keys: ``visible_splats``, ``src_pairs`` (tiles its rows touch),
``recv_rows`` (live rows it received), ``recv_buf_rows``, ``strip_pairs``,
``bin_dropped``, ``exchange_dropped``; ``balance`` is the busiest strip's
pairs over the mean.

On the card (``--device cuda``) a projection of the G-card frame follows,
from single-card phase times measured on the card in the same run
(``utils.profiling.phase_timings`` at the same operating point): binning
and compositing scale with the busiest strip's share of the single-card
pairs, preprocess with 1/G. The exchange is reported in bytes (60 a row),
unpriced: no multi-card bandwidth has been measured. gsjax's projection
priced it, and preprocess, at TPU figures; none carries over.

    python -m gsjax_torch.multichip_split [--ranks 2] [--exchange a2a|all_gather] \\
        [--strip_budget_mult 1.2] [--out output/multichip_split_g2.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 900
BYTES_PER_ROW = 60  # 10 float32 + 4 int32 + the valid flag, per exchanged row
COUNT_KEYS = ("visible_splats", "src_pairs", "recv_rows", "recv_buf_rows", "strip_pairs",
              "bin_dropped", "exchange_dropped")


def build_parser():
    ap = argparse.ArgumentParser(description="gsjax_torch multi-rank work split")
    ap.add_argument("--ranks", type=int, default=2, help="G, the gauss mesh size")
    ap.add_argument("--exchange", default="a2a", choices=("a2a", "all_gather"))
    ap.add_argument("--strip_budget_mult", type=float, default=1.0,
                    help="headroom over the even max_pairs / G split")
    ap.add_argument("--max_tiles_per_gauss", type=int, default=16)
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--capacity", type=int, default=1 << 20)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--max_pairs", type=int, default=3_538_944,
                    help="the single-card pair budget that the strips split")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--rank", action="store_true", help=argparse.SUPPRESS)
    return ap


def strip_budget(max_pairs: int, ranks: int, mult: float) -> int:
    """A strip's pair budget: the even split times ``mult``, 128-aligned,
    at least 1024 (gsjax's ``mp_strip``)."""
    return max(-(-int(max_pairs // ranks * mult) // 128) * 128, 1024)


def settings_of(args):
    """The operating point's settings; ``max_pairs`` is G strip budgets, so
    that ``shard.bin_strip``'s ``max_pairs // G`` is one."""
    from gsjax_torch.ops.rasterize import RasterizeSettings

    mp_strip = strip_budget(args.max_pairs, args.ranks, args.strip_budget_mult)
    return RasterizeSettings(max_pairs=mp_strip * args.ranks, expansion="compact",
                             max_tiles_per_gauss=args.max_tiles_per_gauss,
                             splat_exchange=args.exchange), mp_strip


def rank_counts(args) -> list:
    """One rank: its counts, gathered from every rank in rank order."""
    import torch
    import torch.distributed as dist

    from gsjax_torch.bench_scene import toy_scene
    from gsjax_torch.ops.projection import num_tiles
    from gsjax_torch.parallel import make_mesh, shard_gaussian_state
    from gsjax_torch.parallel.multihost import maybe_initialize
    from gsjax_torch.parallel.shard import _a2a_rows_auto, _cdiv, _strip_bins

    maybe_initialize(device=args.device)
    mesh = make_mesh(data=1, device=args.device)
    if mesh.gauss != args.ranks:
        raise ValueError(f"{mesh.gauss} ranks, --ranks {args.ranks}")
    settings, _ = settings_of(args)
    state, cam = toy_scene(args.gaussians, args.capacity, args.width, args.height,
                           log_scale=-5.2, device="cpu")
    local = shard_gaussian_state(state, mesh)
    del state
    tiles_x, tiles_y = num_tiles(args.width, args.height)
    strips_y = _cdiv(tiles_y, mesh.gauss)
    with torch.no_grad():
        splats, alls, bins, _, exch_dropped = _strip_bins(
            local.params, local.active, local.active_sh_degree,
            cam.to_render_camera(mesh.device), None, settings, strips_y, mesh)
    if settings.splat_exchange == "a2a":
        buf_rows = mesh.gauss * _a2a_rows_auto(splats.depths.shape[0], mesh.gauss,
                                               settings.a2a_rows)
    else:
        buf_rows = alls.depths.shape[0]
    mine = dict(zip(COUNT_KEYS, (
        int((splats.tiles_touched > 0).sum()), int(splats.tiles_touched.sum()),
        int((alls.tiles_touched > 0).sum()), int(buf_rows),
        int(bins.tile_start[tiles_x * strips_y]), int(bins.num_dropped), int(exch_dropped))))
    every = [None] * mesh.world
    dist.all_gather_object(every, mine)
    return every


def single_card_phases(args):
    """The single-card phase times (ms) and pairs at the operating point,
    on the card."""
    import torch

    from gsjax_torch.bench_scene import toy_scene
    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.ops.rasterize import RasterizeSettings
    from gsjax_torch.utils.profiling import phase_timings, state_frame_inputs

    state, cam = toy_scene(args.gaussians, args.capacity, args.width, args.height,
                           log_scale=-5.2, device="cuda")
    rcam = cam.to_render_camera("cuda")
    settings = RasterizeSettings(max_pairs=args.max_pairs, expansion="compact",
                                 max_tiles_per_gauss=args.max_tiles_per_gauss)
    with torch.no_grad():
        _, bins = state_frame_inputs(state, rcam, settings)
    pairs = int(bins.num_pairs)
    phases = phase_timings(*activated(state), rcam, settings, active_mask=state.active)
    del state, bins
    torch.cuda.empty_cache()  # the ranks share the card
    return phases, pairs


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.rank:
        every = rank_counts(args)
        if int(os.environ.get("GSJAX_PROCESS_ID", "0")) == 0:
            print(json.dumps(every), flush=True)
        return 0

    from gsjax_torch.parallel.multihost import spawn_ranks
    from gsjax_torch.utils.system import resolve_device

    dev = resolve_device(args.device)  # fail before launching anything
    G = args.ranks
    phases = None
    if dev.type == "cuda":
        phases, ref_pairs = single_card_phases(args)
    forward = list(argv if argv is not None else sys.argv[1:])
    res = spawn_ranks([sys.executable, "-m", "gsjax_torch.multichip_split", *forward, "--rank"],
                      G, RANK_TIMEOUT_S, cwd=HERE, threads=1 if dev.type == "cpu" else None)
    per_chip = json.loads(res[0].stdout.strip().splitlines()[-1])

    _, mp_strip = settings_of(args)
    from gsjax_torch.ops.projection import num_tiles
    from gsjax_torch.parallel.shard import _cdiv

    pairs = [c["strip_pairs"] for c in per_chip]
    report = {
        "operating_point": {
            "scene": f"bench toy {args.gaussians} gaussians, {args.width}x{args.height}",
            "devices": G, "strips_y": _cdiv(num_tiles(args.width, args.height)[1], G),
            "max_pairs_total": args.max_pairs, "max_pairs_per_strip": mp_strip,
            "exchange": args.exchange,
        },
        "per_chip": per_chip,
        "balance": {
            "total_strip_pairs": sum(pairs),
            "max_over_mean_pairs": round(max(pairs) / (sum(pairs) / G), 3) if sum(pairs) else None,
        },
    }
    if phases is not None:
        from gsjax_torch.utils.profiling import card

        share = max(pairs) / ref_pairs
        proj = {
            "bin_ms": phases["binning_ms"] * share,
            "pack+kernel_ms": phases["composite_ms"] * share,
            "pre_ms": phases["preprocess_ms"] / G,
        }
        proj["frame_ms"] = sum(proj.values())
        proj["fps"] = 1e3 / proj["frame_ms"]
        proj["exchange_bytes"] = max(c["recv_rows"] for c in per_chip) * BYTES_PER_ROW
        proj["single_card"] = {"preprocess_ms": phases["preprocess_ms"],
                               "binning_ms": phases["binning_ms"],
                               "composite_ms": phases["composite_ms"], "pairs": ref_pairs}
        proj["assumptions"] = (
            f"single-card phase times measured on {card()} in this run (phase_timings, the "
            f"fewest of its reps); binning and pack+kernel scale with the busiest strip's "
            f"share of the single-card pairs ({max(pairs)}/{ref_pairs}), preprocess with "
            f"1/{G}; the exchange ({proj['exchange_bytes']} bytes to the busiest rank) is not "
            "priced and not in frame_ms: no multi-card bandwidth has been measured")
        report["projection"] = proj
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=1)
        os.replace(tmp, args.out)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
