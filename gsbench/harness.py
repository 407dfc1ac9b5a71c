"""The benchmark's one general harness: it finds a cell's configuration,
traffic mix, limits and metric readers by name, builds the inputs from the
seed, drives the program (``gsjax_torch``) through its own entry points,
measures a window, checks the window's outputs against the plain
reference and prints one result line.

Nothing here names a cell: a configuration is ``configs/<name>.json``
(its ``scene`` a module of ``scenes/``), a traffic mix is
``traffic/<name>.json`` (its ``kind``, "train" or "view", picks the
loop below), a cell's limits are ``limits/<workload>.json`` and a
per-layer metric is ``metrics/<name>.py``, a reader of the run's trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import random
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "gsjax")


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def benchmark(path=None) -> dict:
    """``BENCHMARK.json`` at the checkout's root (the working directory)."""
    with open(path or "BENCHMARK.json") as f:
        return json.load(f)


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = os.path.join(ROOT, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("gsbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def scene_maker(kind: str):
    return importlib.import_module(f"gsbench.scenes.{kind}").build


def for_cell(entries, workload: str) -> list:
    """The metric entries a cell reports: those without ``workloads`` and
    those that list it."""
    return [m for m in entries if "workloads" not in m or workload in m["workloads"]]


def process_age() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def shuffled_stack(seed: int, m: int):
    """The trainer's camera order: pop a random index of a stack refilled
    with all ``m`` cameras whenever it runs dry."""
    rng = random.Random(seed)
    stack = []
    while True:
        if not stack:
            stack.extend(range(m))
        yield stack.pop(rng.randint(0, len(stack) - 1))


def sample_positions(seed: int, mean_gap: int, count: int) -> set:
    """Frame positions to keep for the check, drawn from the seed."""
    rng = random.Random(seed ^ 0x5EED)
    out, pos = set(), 0
    for _ in range(count):
        pos += rng.randint(1, 2 * mean_gap - 1)
        out.add(pos)
    return out


def per_item_ms(window_s: float, n: int) -> float:
    """Milliseconds an item over the whole window: its length over every
    item it completed."""
    return 1e3 * window_s / n


def p95_ms(latencies) -> float:
    """The 95th percentile of every latency (seconds) in the window, in ms
    (``statistics.quantiles``' exclusive method)."""
    if len(latencies) < 2:
        return 1e3 * latencies[0]
    return 1e3 * statistics.quantiles(latencies, n=100)[94]


def frame_tile_cap(width: int, height: int) -> int:
    """The largest tile cap the trainer's overflow reaction reaches under
    the compact expansion (``train/loop.py``: the frame's tile count,
    rounded up to a power of two), where one gaussian covers the frame."""
    tiles = -(-width // 16) * -(-height // 16)
    return 2 ** math.ceil(math.log2(max(tiles, 2)))


def tie_of(settings, capacity: int) -> str:
    """The depth-tie order the program's binning gives these settings:
    the gaussians' (tiles touched, index) rank under the compact and the
    tiered expansions, the index under the plain grid."""
    mt = settings.max_tiles_per_gauss
    ca = min(int(capacity * settings.tier_frac) // 8 * 8, capacity)
    tiered = max(2, mt // 4) < mt and 0 < ca < capacity
    return "count_index" if settings.expansion == "compact" or tiered else "index"


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def tf32_off():
    """The reference's precision: plain float32 products and convolutions."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def log(msg):
    print(msg, file=sys.stderr, flush=True)


class Run:
    """One run of one cell."""

    def __init__(self, bench: dict, workload: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", limits: dict | None = None, config: dict | None = None,
                 traffic: dict | None = None):
        import torch

        cell = next(w for w in bench["workloads"] if w["name"] == workload)
        self.bench, self.workload = bench, workload
        self.cfg = config or load_json("configs", f"{cell['config']}.json")
        self.traffic = traffic or load_json("traffic", f"{cell['traffic']}.json")
        self.limits = limits if limits is not None else load_json("limits", f"{workload}.json")
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.dev = torch.device(device)
        if self.dev.type == "cuda" and self.dev.index is None:
            self.dev = torch.device("cuda", torch.cuda.current_device())
        self.ctx = {"kind": self.traffic["kind"]}
        self.info = {}
        self._last = time.perf_counter()

    def mark(self, what: str):
        """Log the seconds since the last mark (set-up's phases)."""
        now = time.perf_counter()
        log(f"  {what}: {now - self._last:.3f} s")
        self._last = now

    # ---- inputs ------------------------------------------------------------

    def scene(self):
        return scene_maker(self.cfg["scene"])(self.cfg, self.seed, self.dev)

    def program_state(self, sc):
        import torch

        from gsjax_torch.models.gaussians import GaussianState

        cap = sc["active"].shape[0]
        z = torch.zeros(cap, dtype=torch.float32, device=self.dev)
        return GaussianState(params=sc["params"], active=sc["active"], max_radii2d=z.clone(),
                             xyz_grad_accum=z.clone(), denom=z.clone(),
                             active_sh_degree=sc["sh_degree"], max_sh_degree=3,
                             spatial_lr_scale=float(sc["extent"]))

    def cameras(self, poses):
        """(reference tensors, program RenderCameras, program host Cameras)."""
        from gsjax_torch.data.cameras import Camera, RenderCamera

        from gsbench.reference.cameras import TENSORS, camera_tensors

        ref = [camera_tensors(p, self.dev) for p in poses]
        rc = [RenderCamera(**{k: t[k] for k in TENSORS}, width=t["width"], height=t["height"])
              for t in ref]
        host = [Camera(uid=i, image_name=f"{i:04d}", R=p["R"], T=p["T"], fov_x=p["fov_x"],
                       fov_y=p["fov_y"], width=p["width"], height=p["height"])
                for i, p in enumerate(poses)]
        return ref, rc, host

    def settings(self, budgets, state, host_cams, w, h, train: bool):
        """The program's own budgets: the trainer's heuristics and training
        probe, or the inference probe ``render.py`` and the viewers call.

        With ``"tile_cap": "reaction_ceiling"`` a compact expansion's tile
        cap starts where the trainer's reaction to an overflow would take
        it, the frame's tile count: the probe sizes the cap to the widest
        footprint of the seed's state, which training may widen past it
        within a window, and the trainer's reaction (a recapture) cannot
        run inside one. The compact expansion sorts ``max_pairs`` entries
        whatever the cap, so this costs it no sort slots; a grid's cap
        sets its slots, and stays as probed."""
        from gsjax_torch.train.loop import (
            _probe_initial_budgets, default_rasterize_settings, probe_rasterize_settings,
        )

        kind = budgets["kind"]
        if kind == "trainer" and train:
            s = default_rasterize_settings(w, h, state.capacity)
            s = _probe_initial_budgets(s, state, host_cams, w, h)
            if budgets.get("tile_cap") == "reaction_ceiling" and s.expansion == "compact":
                s = dataclasses.replace(s, max_tiles_per_gauss=frame_tile_cap(w, h))
            return s
        if kind == "probe":
            return probe_rasterize_settings(state, host_cams, w, h,
                                            every_view=budgets.get("every_view", False))
        raise ValueError(f"unknown budgets {kind!r}")

    def render_targets(self, sc, ref_cams, tie):
        """uint8 targets: the scene with each gaussian's DC color moved by
        N(0, ``target_dc_noise``), rendered by the reference."""
        import torch

        from gsbench.reference import render as R

        gen = torch.Generator(device=self.dev).manual_seed(self.seed + 1)
        params = {k: v.clone() for k, v in sc["params"].items()}
        params["features_dc"] += self.traffic["target_dc_noise"] * torch.randn(
            params["features_dc"].shape, generator=gen, device=self.dev)
        bg = torch.tensor(self.traffic["background"], dtype=torch.float32, device=self.dev)
        out = []
        with tf32_off():
            for c in ref_cams:
                img = R.render(params, sc["active"], c, bg, sc["sh_degree"], tie)[0]
                out.append(R.quantize_u8(img))
        return torch.stack(out)

    # ---- result --------------------------------------------------------------

    def device_info(self):
        import torch

        if self.dev.type == "cuda":
            return {"platform": "gpu", "kind": torch.cuda.get_device_name(self.dev),
                    "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(self.dev))}
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}

    def result(self, e2e: dict, numbers: dict, attempted: int, failed: int):
        from gsbench.reference.compare import judge

        correct, rows = judge(numbers, self.limits)
        correct = correct and failed == 0
        metrics = {}
        if self.trace:
            for m in for_cell(self.bench["per_layer"], self.workload):
                v = metric_reader(m["name"])(self.ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            for m in for_cell(self.bench["end_to_end"], self.workload):
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        dev = dict(self.device_info_window)
        out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
               "metrics": metrics, "device": dev}
        if self.trace and "busy_s" in self.ctx:
            dev["busy_s"], dev["window_s"] = self.ctx["busy_s"], self.ctx["window_s"]
            out["breakdown"] = self.ctx["breakdown"]
        out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
        out["checks"]["failed_operations"] = {"value": failed, "limit": 0}
        return out

    # ---- trace ---------------------------------------------------------------

    def read_trace(self, events, span):
        from gsbench import trace as T

        win = T.window(events, span)
        if win is None:
            return
        busy, gaps = T.busy_and_gaps(events, win)
        if busy <= 0:
            return
        self.ctx["busy_s"] = busy
        self.ctx["window_s"] = (win[1] - win[0]) * 1e-6
        self.ctx["breakdown"] = T.breakdown(events, win, gaps)
        times = {}
        for name, (sec, n) in T.kernel_seconds(events, win).items():
            k = T.kernel_of(name)
            if k is not None:
                t = times.setdefault(k, [0.0, 0])
                t[0] += sec
                t[1] += n
        self.ctx["kernel_time"] = times
        log(f"traced kernels (s, launches): {times}; busy {busy:.6f} s of "
            f"{self.ctx['window_s']:.6f} s")

    def count_work(self, sc, ref_cams, steps_poses, kernels, per_step_ops):
        """The reference's counts on the traced steps' poses: each kernel's
        least seconds summed over its traced launches, and the needed
        operations of the traced window."""
        from gsbench import work
        from gsbench.reference import render as R

        p0, active, n_active = sc["params"], sc["active"], int(sc["active"].sum())
        frames = {}
        with tf32_off():
            for k in sorted(set(steps_poses)):
                c = ref_cams[k]
                sp = R.preprocess(*R.activations(p0), c, sc["sh_degree"], active)
                pg, ts = R.pairs(sp, c["width"], c["height"], self.tie)
                blend = R.Blend(pg, ts, sp.means2d, sp.conics, sp.colors, sp.opacities,
                                c["width"], c["height"])
                blend.forward()
                tx, ty = R.num_tiles(c["width"], c["height"])
                frames[k] = {"pairs": int(pg.shape[0]),
                             "gauss_with_pairs": int(pg.unique().numel()),
                             "tiles": tx * ty, "blended": blend.blended,
                             "width": c["width"], "height": c["height"]}
                del blend, sp
        need = {}
        for kname in kernels:
            launches = self.ctx.get("kernel_time", {}).get(kname, [0.0, 0])[1]
            if launches != len(steps_poses):
                continue  # a launch count that does not match the traced steps reads nothing
            need[kname] = sum(work.least_seconds(*work.kernel_work(kname, frames[k]))
                              for k in steps_poses)
        self.ctx["kernel_need"] = need
        self.ctx["needed_ops"] = sum(per_step_ops(frames[k], n_active) for k in steps_poses)
        log(f"counted frames: {frames}; needed seconds {need}")
        self.ctx["frames_counted"] = {k: frames[k] for k in frames}

    # ---- the two loops ----------------------------------------------------------

    def run(self) -> dict:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.set_device(self.dev.index)
        kind = self.traffic["kind"]
        if kind == "train":
            return self.run_train()
        if kind == "view":
            return self.run_view()
        raise ValueError(f"unknown traffic kind {kind!r}")

    def run_train(self) -> dict:
        import torch

        from gsjax_torch.configs import OptimizationParams
        from gsjax_torch.data.cameras import stack_render_cameras
        from gsjax_torch.train.optim import adam_moments, make_optimizer
        from gsjax_torch.train.step import (
            TrainConfig, make_train_step_chained, restore, snapshot,
        )
        from torch.profiler import record_function

        from gsbench import stages, work
        from gsbench.reference import compare
        from gsbench.reference import train as RT

        tr, cfgc = self.traffic, self.cfg
        n_chain = tr["steps_per_dispatch"]
        log(f"set-up of {self.workload}, seed {self.seed}; process age {process_age():.3f} s")
        self.mark("imports")
        sc = self.scene()
        state = self.program_state(sc)
        ref_cams, rcams, host = self.cameras(sc["train_poses"])
        _sync(self.dev)
        self.mark("scene and cameras")
        w, h = cfgc["width"], cfgc["height"]
        settings = self.settings(cfgc["train_budgets"], state, host, w, h, train=True)
        self.tie = tie_of(settings, state.capacity)
        self.mark(f"budgets {settings}")
        t0 = time.perf_counter()
        targets = self.render_targets(sc, ref_cams, self.tie)
        _sync(self.dev)
        self.info["targets_s"] = time.perf_counter() - t0
        self.mark("targets (reference)")
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)

        extent = float(sc["extent"])
        cfg = TrainConfig(settings=settings, extent=extent)
        tx = make_optimizer(OptimizationParams(**tr["optimizer"]), extent)
        opt = tx.init(state.params)
        opt.count = tr["start_iteration"]
        batch = stack_render_cameras(rcams, self.dev)
        chained = make_train_step_chained(tx, batch, targets.clone(), cfg, n_chain)
        m = len(rcams)

        def read(metrics):
            names = list(metrics)
            vals = torch.stack([metrics[k].detach().to(torch.float64) for k in names]).tolist()
            return dict(zip(names, vals))

        # warm-up and capture, then the state back to the seed's
        snap = snapshot(state, opt)
        self.mark("program built")
        read(chained(state, opt, [i % m for i in range(n_chain)])[2])
        self.mark("warm-up dispatch and capture")
        restore(state, opt, snap)
        order = shuffled_stack(self.seed, m)
        # the checked dispatch: the window's call, replayed from the seed's state
        cams0 = [next(order) for _ in range(n_chain)]
        m0 = read(chained(state, opt, cams0)[2])
        mu, nu = adam_moments(opt)
        with torch.no_grad():
            prog = compare.train_norms(
                {k: snap[f"param/{k}"] for k in state.params}, state.params, mu, nu,
                {k: getattr(state, k) for k in ("max_radii2d", "xyz_grad_accum", "denom")})
        prog.update(loss_mean=m0["loss_mean"], loss_last=m0["loss"])
        del snap
        failed = n_chain if m0["num_dropped_pairs"] > 0 else 0
        if failed:
            log(f"the checked dispatch dropped pairs: "
                f"{ {k: v for k, v in m0.items() if k.startswith('num_')} }")
        self.mark("checked dispatch and its norms")

        # the window
        t_first = time.perf_counter()
        setup_s = process_age()
        issue, n_disp, window_failed = [], 0, 0
        while True:
            cams = [next(order) for _ in range(n_chain)]
            a = time.perf_counter()
            out = chained(state, opt, cams)[2]
            issue.append(time.perf_counter() - a)
            vals = read(out)
            n_disp += 1
            if vals["num_dropped_pairs"] > 0:
                window_failed += n_chain
                log(f"dispatch {n_disp} of the window dropped pairs: "
                    f"{ {k: v for k, v in vals.items() if k.startswith('num_')} }")
            if time.perf_counter() - t_first >= self.seconds:
                break
        _sync(self.dev)
        window_s = time.perf_counter() - t_first
        self.device_info_window = self.device_info()
        steps = n_disp * n_chain
        e2e = {"train_step_ms": per_item_ms(window_s, steps), "setup_s": setup_s}
        self.ctx["host_issue_ms"] = 1e3 * statistics.fmean(issue) / n_chain
        log(f"window: {n_disp} dispatches, {steps} steps in {window_s:.3f} s; "
            f"train_step_ms {e2e['train_step_ms']:.4f}; setup_s {setup_s:.3f} "
            f"(targets {self.info['targets_s']:.3f} s)")

        traced_cams = []
        if self.trace:
            from gsbench import trace as T

            with T.profiled() as prof:
                for _ in range(tr["trace_dispatches"]):
                    cams = [next(order) for _ in range(n_chain)]
                    traced_cams += cams
                    with record_function("gsbench.dispatch"):
                        read(chained(state, opt, cams)[2])
            self.read_trace(prof["events"], "gsbench.dispatch")
            gt = targets[0].to(torch.float32) / 255.0
            stages.train_iteration(state, opt, rcams[0], gt, cfg)  # warm-up
            with T.profiled() as prof2:
                stages.train_iteration(state, opt, rcams[0], gt, cfg)
                _sync(self.dev)
            self.ctx["spans"] = T.span_device_seconds(prof2["events"])
            self.ctx["traced_steps"] = len(traced_cams)
            log(f"spans (device s): {self.ctx['spans']}")
        del chained, opt, tx, state, batch, rcams, out, mu, nu
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

        # the reference, from the seed's own state
        t0 = time.perf_counter()
        sc0 = self.scene()
        p0, active = sc0["params"], sc0["active"]
        bg = torch.tensor(tr["background"], dtype=torch.float32, device=self.dev)
        with tf32_off():
            rp, rmu, rnu, rstats, losses, first = RT.run(
                p0, active, ref_cams, targets, cams0, bg, sc0["sh_degree"], self.tie,
                tr["optimizer"], extent, tr["start_iteration"])
            ref = compare.train_norms(p0, rp, rmu, rnu, rstats)
        ref.update(loss_mean=statistics.fmean(losses), loss_last=losses[-1],
                   first_grads=first)
        numbers = compare.train_numbers(prog, ref)
        del rp, rmu, rnu
        self.info["reference_s"] = time.perf_counter() - t0
        log(f"reference: {len(cams0)} iterations in {self.info['reference_s']:.3f} s; "
            f"loss mean program {prog['loss_mean']:.9g} reference {ref['loss_mean']:.9g}")
        if self.trace and traced_cams:
            self.count_work(sc0, ref_cams, traced_cams, ("composite_fwd", "composite_bwd"),
                            work.train_step_ops)
            self.ctx["mfu_seconds"] = self.ctx.get("window_s")
        return self.finish(e2e, numbers, steps, window_failed + failed)

    def run_view(self) -> dict:
        import torch

        from gsjax_torch.train.step import TrainConfig, make_render_fn
        from torch.profiler import record_function

        from gsbench import stages, work
        from gsbench.reference import compare
        from gsbench.reference import render as R

        tr, cfgc = self.traffic, self.cfg
        log(f"set-up of {self.workload}, seed {self.seed}; process age {process_age():.3f} s")
        self.mark("imports")
        sc = self.scene()
        state = self.program_state(sc)
        ref_cams, rcams, host = self.cameras(sc["view_poses"])
        _sync(self.dev)
        self.mark("scene and cameras")
        w, h = ref_cams[0]["width"], ref_cams[0]["height"]
        settings = self.settings(cfgc["view_budgets"], state, host, w, h, train=False)
        self.tie = tie_of(settings, state.capacity)
        self.mark(f"budgets {settings}")
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        render_fn = make_render_fn(TrainConfig(settings=settings), with_stats=True,
                                   as_uint8=True)
        bg = torch.tensor(tr["background"], dtype=torch.float32, device=self.dev)
        pin = self.dev.type == "cuda"
        host_frame = torch.empty((h, w, 3), dtype=torch.uint8, pin_memory=pin)
        path = sc["view_path"](self.seed)
        for _ in range(2):  # capture, then a replay
            img, dropped = render_fn(state, rcams[next(path)], bg)
            host_frame.copy_(img)
            int(dropped)
        self.mark("capture and a replay")
        keep_at = sample_positions(self.seed, tr["sample_mean_gap"], tr["sample_max"])
        kept, lat, issue, failed = [], [], [], 0

        t_first = time.perf_counter()
        setup_s = process_age()
        i = 0
        while True:
            k = next(path)
            a = time.perf_counter()
            img, dropped = render_fn(state, rcams[k], bg)
            b = time.perf_counter()
            n_drop = dropped.to("cpu", non_blocking=True)
            host_frame.copy_(img)  # waits for the frame, and so for the counter
            c = time.perf_counter()
            lat.append(c - a)
            issue.append(b - a)
            if int(n_drop) > 0:
                failed += 1
            i += 1
            if i in keep_at:
                kept.append((k, host_frame.clone()))
            if c - t_first >= self.seconds:
                break
        _sync(self.dev)
        window_s = time.perf_counter() - t_first
        self.device_info_window = self.device_info()
        frames = len(lat)
        if not kept:  # a short window keeps its last frame
            kept.append((k, host_frame.clone()))
        e2e = {"frame_ms": per_item_ms(window_s, frames), "frame_p95_ms": p95_ms(lat),
               "setup_s": setup_s}
        self.ctx["host_issue_ms"] = 1e3 * statistics.fmean(issue)
        log(f"window: {frames} frames in {window_s:.3f} s; frame_ms {e2e['frame_ms']:.4f}, "
            f"frame_p95_ms {e2e['frame_p95_ms']:.4f}; setup_s {setup_s:.3f}; "
            f"{len(kept)} frames kept for the check")

        traced = []
        if self.trace:
            from gsbench import trace as T

            with T.profiled() as prof:
                for _ in range(tr["trace_frames"]):
                    k = next(path)
                    traced.append(k)
                    with record_function("gsbench.frame"):
                        img, dropped = render_fn(state, rcams[k], bg)
                        host_frame.copy_(img)
                        int(dropped)
            self.read_trace(prof["events"], "gsbench.frame")
            stages.view_frame(state, rcams[traced[0]], settings)  # warm-up
            with T.profiled() as prof2:
                stages.view_frame(state, rcams[traced[0]], settings)
                _sync(self.dev)
            self.ctx["spans"] = T.span_device_seconds(prof2["events"])
        del render_fn, state, rcams, img
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        sc0 = self.scene()
        pairs = []
        with tf32_off():
            for k, frame in kept:
                ref = R.render(sc0["params"], sc0["active"], ref_cams[k], bg, sc0["sh_degree"],
                               self.tie)[0]
                pairs.append((frame.to(self.dev), R.quantize_u8(ref)))
        numbers = compare.frame_numbers(pairs)
        self.info["reference_s"] = time.perf_counter() - t0
        log(f"reference: {len(pairs)} frames in {self.info['reference_s']:.3f} s")
        if self.trace and traced:
            self.count_work(sc0, ref_cams, traced, ("composite_infer",), work.view_frame_ops)
            self.ctx["mfu_seconds"] = self.ctx.get("window_s")
        return self.finish(e2e, numbers, frames, failed)

    def finish(self, e2e, numbers, attempted, failed):
        out = self.result(e2e, numbers, attempted, failed)
        for name, row in out["checks"].items():
            log(f"check {name}: {row['value']!r} (limit {row['limit']!r})")
        return out

