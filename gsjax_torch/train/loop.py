"""The training loop (torch): orchestration around the train step.

Counterpart of ``gsjax.train.loop``, mirroring the reference's
``training()`` control flow (reference: train.py:31-132): shuffled-stack
camera sampling (Python's ``random``, so the order equals gsjax's draw for
draw), the SH-degree ramp every 1000 iterations, densify / prune every
``densification_interval`` in (densify_from_iter, densify_until_iter),
opacity resets, eval / save hooks and checkpoints; plus gsjax's pieces:
fixed-capacity buffers re-bucketed 2x when densification fills them, and
the overflow reactions that grow a rasterizer budget whenever a step drops
pairs. Event-free iteration ranges run ``steps_per_dispatch`` steps per
dispatch (``make_train_step_chained``), and the step's metrics are read
from the device once per dispatch. The random keys are gsjax's
(``utils.prng``): ``PRNGKey(seed)``, split once a dispatch for the step and
once a densification for the split noise.

On a card the steps, the chained dispatches and the evaluation renders
replay CUDA graphs (``utils.graphs``), the counterpart of gsjax's ``jit``:
a graph is captured at the first call of each (capacity, SH degree,
settings, resolution bucket, ``apply_update``), as gsjax compiles a
program, so growing capacity or a budget rebuilds the step closures and
the SH ramp captures anew. Three cases run eager, each logged: the
sharded steps (their gloo collectives cannot be captured), every step
from ``debug_from`` on (autograd's anomaly mode cannot be captured) and
the scan backend's steps (the backward of its cumprod reads the device).
The counters ``train.graph``, ``train.capture`` and ``train.eager`` of
``utils.profiling``'s registry count the steps each path ran. gsjax's
background compile of the next capacity bucket (``CapacityWarmer``,
``_grown_abstract``, ``_with_fallback``, ``_warmed_densify``) and the AOT
lowering of the step (``_attach_lower_images``) have no counterpart: the
grown capacity's graphs are captured at their first call.

Sharded training (``data_shards`` x ``gauss_shards`` ranks, one process
each: ``parallel.multihost``) runs ``parallel.shard``'s steps on each rank's
block of Gaussian rows, one camera per ``data`` row per step. Every rank
takes the same decisions (camera draws, budget reactions, densification),
so the collectives stay in step. Densification and capacity growth run on
the whole state: each rank gathers the state and Adam's moments over
``gauss``, runs :func:`make_densify_step` with the same key, and keeps
its own rows. Logging, evaluation and checkpoints come from the main rank,
on the gathered state.

Before a scene renders, :func:`default_rasterize_settings` and a
preprocess probe on the model (:func:`probe_rasterize_settings` for
inference, the training variant at startup) size its budgets.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from gsjax_torch.configs import ModelParams, OptimizationParams, PipelineParams, save_cfg_args
from gsjax_torch.data.cameras import stack_render_cameras
from gsjax_torch.eval.metrics import psnr
from gsjax_torch.models.gaussians import activated, create_empty, grow_capacity
from gsjax_torch.ops.cuda_composite import load_library
from gsjax_torch.ops.projection import num_tiles, preprocess
from gsjax_torch.ops.rasterize import RasterizeSettings
from gsjax_torch.train.checkpoint import (
    load_checkpoint,
    load_reference_checkpoint,
    save_checkpoint,
)
from gsjax_torch.train.loss import l1_loss
from gsjax_torch.train.optim import (
    adam_count,
    grow_optimizer,
    make_optimizer,
    with_adam_moments,
)
from gsjax_torch.train.scene import Scene
from gsjax_torch.train.step import (
    TrainConfig,
    make_densify_step,
    make_render_fn,
    make_train_step,
    make_train_step_chained,
    stack_images,
)
from gsjax_torch.parallel import comm
from gsjax_torch.parallel.multihost import is_main_process, process_count
from gsjax_torch.utils import profiling, prng
from gsjax_torch.utils.system import resolve_device

GROW_WATERMARK = 0.9  # grow capacity when the active fraction exceeds this

# small-tier cap candidates for the tier_frac safety check
_TIER_KS = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def default_rasterize_settings(
    width: int, height: int, capacity: int
) -> RasterizeSettings:
    """Heuristic budgets scaled to the scene / render size (gsjax's)."""
    tiles = -(-width // 16) * -(-height // 16)
    max_pairs = min(1 << 24, max(1 << 18, 2 ** int(np.ceil(np.log2(capacity * 4)))))
    mspt = 2048 if tiles > 1024 else 1024
    mt = int(min(128, max(16, 2 ** int(np.ceil(np.log2(max(max_pairs // max(capacity, 1), 1)))))))
    mt = min(mt, 2 ** int(np.ceil(np.log2(tiles))))
    return RasterizeSettings(
        max_pairs=max_pairs, max_splats_per_tile=mspt, chunk=32,
        max_tiles_per_gauss=mt, tier_frac=0.875, grad_dtype="bfloat16",
    )


@torch.no_grad()
def _probe_initial_budgets(settings, state, train_cams, width, height, inference=False,
                           every_view=False):
    """Measure the model's footprints and size the per-gaussian tile cap,
    the pair budget, ``tier_frac`` and the expansion before the first
    render or train step — gsjax's probe, same decisions, with two
    departures for training below. Training (``inference=False``) keeps
    twice the probed pairs up to 1<<24 (densification adds gaussians, and
    the trainer reacts to overflow); inference sizes the budget at 1.5x
    the probe.

    Inference measures four of the cameras, as gsjax's probe does (every
    camera with ``every_view``). Training departs from gsjax twice, so
    that no view of the training set drops a pair that the budgets could
    hold:

    - it measures every training camera (gsjax: four). Inside a scene the
      views differ widely: a wall is 0.5 m from one camera and 4 m from the
      next, and four cameras miss the widest footprint and the largest
      pair count. A camera costs one primal preprocess and three reads to
      the host;
    - a compact expansion starts its tile cap at the frame's tile count
      (rounded up to a power of two, :func:`frame_tile_cap`), where the
      overflow reaction ends. The compact expansion sorts ``max_pairs``
      entries whatever the cap, so the larger cap costs no sort slot, and a
      footprint that widens during training is not cut at the probed one.
      On a run that does not overflow it changes no pair and no tie order
      (``_partition_rows`` clamps counts at the cap). A grid expansion keeps
      the probed cap, which sets its slots.

    The training probe is the span ``budgets.probe`` of
    ``utils.profiling``'s registry, with the counters ``probe.views``
    (cameras measured) and ``probe.pairs`` (their pair counts summed)."""
    if inference:
        return _probe(settings, state, train_cams, width, height, True, every_view)
    if state.device.type == "cuda":
        load_library()  # a checkout's first use builds every kernel: not the probe's time
    with profiling.span("budgets.probe"):
        return _probe(settings, state, train_cams, width, height, False, True)


def frame_tile_cap(width: int, height: int) -> int:
    """The frame's tile count rounded up to a power of two: the largest
    tile cap a compact expansion needs, where one gaussian covers the
    whole frame."""
    tiles = -(-width // 16) * -(-height // 16)
    return 2 ** int(np.ceil(np.log2(max(tiles, 2))))


def _probe(settings, state, cams, width, height, inference, every_view):
    tiles_x, tiles_y = num_tiles(width, height)
    means3d, scales, quats, opac, shs = activated(state)

    probe_cams = cams if every_view else cams[:: max(1, len(cams) // 4)][:4]
    mt_need, pairs_need, views, pairs_sum = 0, 0, 0, 0
    frac_le_min = np.ones(len(_TIER_KS))
    for c in probe_cams:
        rc = c.to_render_camera(device=state.device)
        if (rc.width, rc.height) != (width, height):
            continue
        counts = preprocess(
            means3d, scales, quats, opac, shs, rc, state.active_sh_degree,
            active_mask=state.active,
            opacity_aware_radius=settings.opacity_aware_radius,
        ).tiles_touched
        frac_le = torch.stack(
            [(counts <= k).to(torch.float32).mean() for k in _TIER_KS]
        )
        pairs = int(counts.to(torch.int64).sum())
        mt_need = max(mt_need, int(counts.max()))
        pairs_need = max(pairs_need, pairs)
        frac_le_min = np.minimum(frac_le_min, frac_le.cpu().numpy())
        views += 1
        pairs_sum += pairs
    if not inference:
        profiling.count("probe.views", views)
        profiling.count("probe.pairs", pairs_sum)
    if mt_need == 0:
        return settings
    mt = int(
        min(
            2 ** int(np.ceil(np.log2(max(mt_need, 1)))),
            2 ** int(np.ceil(np.log2(tiles_x * tiles_y))),
        )
    )
    # densification adds (small) gaussians, so never shrink the pair budget
    # below the heuristic; grow it if the probe already exceeds it
    max_pairs = settings.max_pairs
    while max_pairs < pairs_need * 2 and max_pairs < 1 << 24:
        max_pairs *= 2
    if inference:
        # no densification at render time: footprints are fixed and the
        # probe saw the real view-dependent max, so 1.5x headroom suffices
        # (64k-aligned). Inference never reacts to overflow, so a scene
        # needing more than 1<<26 pairs is refused rather than darkened.
        max_pairs = max(1 << 18, -(-int(pairs_need * 1.5) // 65536) * 65536)
        if max_pairs > 1 << 26:
            raise ValueError(
                f"inference pair budget: probe needs {pairs_need} pairs "
                f"({max_pairs} with headroom), above the 1<<26 bound — the "
                "scene cannot render drop-free at this resolution"
            )
    # A/B knob: scale the probed pair budget, e.g. GSJAX_PAIR_BUDGET_MULT=2
    # re-runs the tail of a training run with a doubled budget from the
    # same checkpoint (gsjax reads the same variable)
    mult = float(os.environ.get("GSJAX_PAIR_BUDGET_MULT", "1") or 1)
    if mult != 1.0:
        max_pairs = min(1 << 26, -(-int(max_pairs * mult) // 65536) * 65536)
    # tier_frac safety: the small tier holds the tier_frac*N smallest
    # footprints at mt/4 slots each; start at the measured fraction of
    # gaussians that fit it (3% margin, min over probe cameras)
    mt_final = max(mt, settings.max_tiles_per_gauss)
    tier_frac = settings.tier_frac
    if tier_frac > 0:
        mt_small = max(2, mt_final // 4)
        if mt_small <= _TIER_KS[-1]:
            ki = min(i for i, k in enumerate(_TIER_KS) if k >= mt_small)
            safe = max(0.0, float(frac_le_min[ki]) - 0.03)
            tier_frac = min(tier_frac, np.floor(safe * 16) / 16)
            if tier_frac < 0.25:  # too small a tier saves no sort time
                tier_frac = 0.0
        else:
            tier_frac = 0.0
    # the dense grid pays ~capacity * mt_mix sort slots; when footprint
    # variance forces a big mt that explodes past the real pair count —
    # switch to the budget-sized compact expansion
    expansion = settings.expansion
    cap = state.capacity
    ca = min(int(cap * tier_frac) // 8 * 8, cap)
    grid_slots = ca * max(2, mt_final // 4) + (cap - ca) * mt_final
    if grid_slots > 4 * max_pairs:
        expansion = "compact"
    if not inference and expansion == "compact":
        mt_final = max(mt_final, frame_tile_cap(width, height))
    if (mt_final > settings.max_tiles_per_gauss or max_pairs > settings.max_pairs
            or tier_frac != settings.tier_frac
            or expansion != settings.expansion):
        print(
            f"budget probe ({views} views): max tiles/gauss {mt_need} (cap "
            f"{settings.max_tiles_per_gauss} -> {mt_final}), pairs {pairs_need} "
            f"(budget {settings.max_pairs} -> {max_pairs}), tier_frac "
            f"{settings.tier_frac} -> {tier_frac}, expansion {expansion}"
        )
    return dataclasses.replace(
        settings,
        max_tiles_per_gauss=mt_final,
        max_pairs=max_pairs,
        tier_frac=float(tier_frac),
        expansion=expansion,
    )


def probe_rasterize_settings(state, cams, width, height, base=None, every_view=False):
    """Inference-time budget sizing: ``base`` (the heuristics when None)
    and an on-model footprint probe — what render.py and the viewers call
    before rendering a trained model, whose largest gaussians can span
    hundreds of tiles. The probe measures four of ``cams``, as gsjax's,
    or all of them with ``every_view``."""
    s = base or default_rasterize_settings(width, height, state.capacity)
    return _probe_initial_budgets(s, state, cams, width, height, inference=True,
                                  every_view=every_view)


@dataclasses.dataclass
class TrainerLogs:
    """jsonl always; TensorBoard when available (the reference guards the
    import the same way, train.py:25-29)."""

    jsonl_path: Optional[str] = None
    tb_dir: Optional[str] = None
    _tb: object = None

    def __post_init__(self):
        if self.tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(self.tb_dir)
            except Exception:
                print("Tensorboard not available: not logging progress")

    def write(self, record: dict):
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self._tb is not None and "iter" in record:
            it = record["iter"]
            for k, v in record.items():
                if isinstance(v, (int, float)) and k != "iter":
                    self._tb.add_scalar(f"train/{k}", v, it)
                elif isinstance(v, dict):
                    for split, m in v.items():
                        if isinstance(m, dict):
                            for mk, mv in m.items():
                                if isinstance(mv, (int, float)):
                                    self._tb.add_scalar(f"{split}/{mk}", mv, it)

    def write_eval_media(self, iteration, images, opacities):
        """Rendered views (first 5), the opacity histogram and the point
        count at test iterations (reference training_report,
        train.py:163-190). TensorBoard only; a no-op without it."""
        if self._tb is None:
            return
        for name, img in images[:5]:
            self._tb.add_image(f"renders/{name}", np.asarray(img), iteration,
                               dataformats="HWC")
        self._tb.add_histogram("scene/opacity", np.asarray(opacities), iteration)
        self._tb.add_scalar("scene/total_points", len(opacities), iteration)

    def close(self):
        if self._tb is not None:
            self._tb.close()


def _read_metrics(metrics) -> dict:
    """A step's metrics (0-d device tensors) as Python numbers, in one
    transfer: the host waits for the device once per dispatch."""
    names = list(metrics)
    vals = torch.stack([metrics[k].detach().to(torch.float64) for k in names]).tolist()
    return {k: (v if metrics[k].is_floating_point() else int(v)) for k, v in zip(names, vals)}


def training(
    model: ModelParams,
    opt: OptimizationParams,
    pipe: PipelineParams,
    testing_iterations: Sequence[int] = (7_000, 30_000),
    saving_iterations: Sequence[int] = (7_000, 30_000),
    checkpoint_iterations: Sequence[int] = (),
    start_checkpoint: Optional[str] = None,
    quiet: bool = False,
    settings: Optional[RasterizeSettings] = None,
    capacity: Optional[int] = None,
    gui_callback: Optional[Callable] = None,
    passive_callback: Optional[Callable] = None,
    seed: int = 0,
    steps_per_dispatch: int = 25,
    data_shards: int = 1,
    gauss_shards: int = 1,
    debug_from: int = -1,
    densify_iter_grad: str = "apply",
    wall_budget: float = 0.0,
    device="cuda",
):
    """Train a scene end to end on ``device``. Returns ``(scene, final
    GaussianState)``. The arguments are gsjax's ``training``'s:

    ``wall_budget`` > 0 stops once that many seconds have elapsed, as a
    ``STOP`` file in the model directory does: a checkpoint
    (``chkpnt<iter>.npz``) and a PLY snapshot are saved; resume with
    ``start_checkpoint``. ``densify_iter_grad="discard"`` drops the Adam
    update of densification iterations as the reference does (its tensor
    surgery leaves ``.grad=None``, reference train.py:118-128); "apply"
    (the default) applies every step. ``debug_from`` >= 0 turns on
    ``torch.autograd.set_detect_anomaly`` from that iteration.

    ``data_shards`` x ``gauss_shards`` > 1 (or an initialized world of more
    than one rank) trains sharded: every rank calls ``training`` with the
    same arguments, on the device ``parallel.multihost`` gives it; the
    returned state is the whole one, on every rank."""
    dev = resolve_device(device)
    if densify_iter_grad not in ("apply", "discard"):
        raise ValueError(f"unknown densify_iter_grad {densify_iter_grad!r}")
    discard_densify_grad = densify_iter_grad == "discard"
    mesh = None
    if data_shards * gauss_shards > 1 or process_count() > 1:
        if discard_densify_grad:
            raise ValueError("densify_iter_grad='discard' is single-device only (the "
                             "sharded step does not thread the apply_update flag)")
        if gui_callback is not None:
            raise ValueError("the viewer bridge steps one rank alone: sharded runs take "
                             "no gui_callback")
        from gsjax_torch.parallel import make_mesh

        mesh = make_mesh(data=data_shards, gauss=gauss_shards, device=dev.type)
        dev = mesh.device
    main = is_main_process()
    random.seed(seed)
    np.random.seed(seed)

    if not model.model_path:
        unique = os.getenv("OAR_JOB_ID", str(int(time.time())))[-10:]
        model.model_path = os.path.join("./output", unique)
    os.makedirs(model.model_path, exist_ok=True)
    if main:
        save_cfg_args(model.model_path, model)
    logs = TrainerLogs(os.path.join(model.model_path, "train_log.jsonl") if main else None,
                       tb_dir=model.model_path if main else None)

    scene = Scene(model, capacity=capacity, device=dev, write_model_dir=main)
    state = scene.gaussians
    extent = float(scene.cameras_extent)

    train_cams = scene.get_train_cameras()
    # mixed per-camera resolutions bucket by size: the largest bucket keeps
    # the chained path; the others get their own step, built on first use
    size_buckets: dict = {}
    for i, c in enumerate(train_cams):
        size_buckets.setdefault((c.width, c.height), []).append(i)
    bucket_sizes = sorted(size_buckets, key=lambda s: (-len(size_buckets[s]), s))
    bucket_of = {}  # global camera index -> (bucket id, local index)
    bucket_cams = []
    for b, size in enumerate(bucket_sizes):
        idxs = size_buckets[size]
        bucket_cams.append([train_cams[i] for i in idxs])
        for j, i in enumerate(idxs):
            bucket_of[i] = (b, j)
    multi_res = len(bucket_sizes) > 1
    width, height = bucket_sizes[0]
    if mesh is not None and multi_res:
        raise ValueError("sharded training requires a single training resolution; "
                         "pass --resolution to resize")

    if settings is None:
        settings = default_rasterize_settings(width, height, state.capacity)
        settings = _probe_initial_budgets(settings, state, train_cams, width, height)
    cfg = TrainConfig(
        settings=settings,
        lambda_dssim=opt.lambda_dssim,
        white_background=model.white_background,
        random_background=opt.random_background,
        extent=extent,
        compute_cov3d_python=pipe.compute_cov3D_python,
        convert_shs_python=pipe.convert_SHs_python,
    )

    def bucket_data(b):
        """A bucket's cameras and its uint8 GT images, on the device once."""
        return (stack_render_cameras(bucket_cams[b], dev),
                torch.from_numpy(stack_images(bucket_cams[b])).to(dev))

    cam_batch, images = bucket_data(0)

    tx = make_optimizer(opt, state.spatial_lr_scale)
    opt_state = tx.init(state.params)
    first_iter = 0
    if start_checkpoint:
        def make_template(cap, max_sh, lr_scale):
            s = create_empty(cap, max_sh, lr_scale, device=dev)
            return s, tx.init(s.params)

        if start_checkpoint.endswith((".pth", ".pt")):
            # a reference torch checkpoint (train.py:130-132)
            state, opt_state, first_iter = load_reference_checkpoint(
                start_checkpoint, make_template)
        else:
            state, opt_state, first_iter = load_checkpoint(start_checkpoint, make_template)
        print(f"Restored checkpoint at iteration {first_iter}")

    def to_ranks(whole, whole_opt):
        """This rank's rows of a whole state and of its optimizer."""
        local = shard_gaussian_state(whole, mesh)
        return local, shard_opt_state(tx, local, whole_opt, mesh)

    def to_whole(local, local_opt):
        """The whole state (every rank) and an optimizer bound to it."""
        whole = gather_gaussian_state(local, mesh)
        mu, nu = gather_moments(local_opt, mesh)
        whole_opt = tx.init(whole.params)
        whole_opt.count = local_opt.count
        if local_opt.state:
            with_adam_moments(whole_opt, mu, nu, count=adam_count(local_opt))
        return whole, whole_opt

    if mesh is not None:
        from gsjax_torch.parallel.shard import (
            gather_gaussian_state,
            gather_moments,
            make_sharded_train_step,
            make_sharded_train_step_chained,
            shard_gaussian_state,
            shard_opt_state,
        )

        state, opt_state = to_ranks(state, opt_state)
        scene.gaussians = None  # the whole state lives on as the ranks' blocks
        print(f"Sharded training on mesh {mesh.shape} (rank {mesh.rank}: data row {mesh.d}, "
              f"gauss block {mesh.g}, {state.capacity} rows)", flush=True)

    n_chain = max(1, int(steps_per_dispatch))
    if multi_res:
        n_chain = 1  # chaining assumes one camera-batch shape

    # the steps run eager from debug_from on: anomaly mode cannot be captured
    eager = False
    if mesh is not None and dev.type == "cuda":
        print("Sharded training: the steps run eager (their gloo collectives cannot be "
              "captured in a CUDA graph)", flush=True)
    elif settings.backend == "scan" and dev.type == "cuda":
        print("Scan backend: the steps run eager (the backward of its cumprod reads the "
              "device, which a CUDA graph cannot capture)", flush=True)

    def build_steps(cfg_now):
        if mesh is not None:
            return (make_sharded_train_step(tx, mesh, cam_batch, images, cfg_now),
                    make_sharded_train_step_chained(tx, mesh, cam_batch, images, cfg_now,
                                                    n_chain) if n_chain > 1 else None)
        return (make_train_step(tx, cam_batch, images, cfg_now, eager=eager),
                make_train_step_chained(tx, cam_batch, images, cfg_now, n_chain, eager=eager)
                if n_chain > 1 else None)

    step, chained = build_steps(cfg)
    # steps of the other resolution buckets, built on first use; cleared
    # whenever the settings change
    extra_bucket_steps: dict = {}

    def bucket_step(b: int):
        fn = extra_bucket_steps.get(b)
        if fn is None:
            fn = make_train_step(tx, *bucket_data(b), cfg, eager=eager)
            extra_bucket_steps[b] = fn
        return fn

    densify_step, reset_step = make_densify_step(opt, cfg)
    render_fn = make_render_fn(cfg)
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, dtype=torch.float32,
                    device=dev)

    # iterations after which post-step work happens (densify / reset /
    # eval / save / checkpoint); a chained dispatch may end on one but
    # not cross one
    def is_densify_iter(i: int) -> bool:
        return (i < opt.densify_until_iter and i > opt.densify_from_iter
                and i % opt.densification_interval == 0)

    def is_event(i: int) -> bool:
        if i in testing_iterations or i in saving_iterations:
            return True
        if i in checkpoint_iterations or i == opt.iterations:
            return True
        if i < opt.densify_until_iter:
            if is_densify_iter(i):
                return True
            if i % opt.opacity_reset_interval == 0:
                return True
            if model.white_background and i == opt.densify_from_iter:
                return True
        return False

    def chain_len(i: int) -> int:
        """How many steps starting at iteration i can run in one dispatch."""
        if discard_densify_grad and is_densify_iter(i):
            return 1  # must run via the single step carrying apply_update
        k = 1
        while k < n_chain:
            nxt = i + k
            if nxt % 1000 == 0:  # the SH ramp happens before the step at nxt
                break
            if discard_densify_grad and is_densify_iter(nxt):
                break  # the next iteration needs the single-step path
            if is_event(nxt - 1):  # post-step work after iteration nxt - 1
                break
            k += 1
        return k

    def pop_camera() -> int:
        if not viewpoint_stack:
            viewpoint_stack.extend(range(len(train_cams)))
        return viewpoint_stack.pop(random.randint(0, len(viewpoint_stack) - 1))

    key = prng.PRNGKey(seed)
    viewpoint_stack: List[int] = []
    ema_loss = 0.0
    t_start = time.time()
    it_times = []
    last_progress = time.time()  # slow runs print at least every ~30 s

    iteration = first_iter
    while iteration < opt.iterations:
        iteration += 1

        if gui_callback is not None:
            gui_callback(iteration, state, render_fn)
        if passive_callback is not None:
            passive_callback(iteration, state, render_fn)

        # --debug_from: from this iteration on, autograd traps the op that
        # produced a non-finite gradient (the reference turns its
        # rasterizer's debug dumps on at the same point, train.py:102-103)
        if debug_from >= 0 and iteration - 1 == debug_from:
            torch.autograd.set_detect_anomaly(True)
            print(f"[ITER {iteration}] debug mode on (torch.autograd.set_detect_anomaly)",
                  flush=True)
            if mesh is None and dev.type == "cuda":
                eager = True
                step, chained = build_steps(cfg)
                extra_bucket_steps.clear()
                print(f"[ITER {iteration}] the steps run eager from here on (anomaly mode "
                      "cannot be captured in a CUDA graph)", flush=True)

        # SH-degree ramp (reference train.py:72-73)
        if iteration % 1000 == 0:
            state = dataclasses.replace(
                state, active_sh_degree=min(state.active_sh_degree + 1, state.max_sh_degree))

        k_len = chain_len(iteration) if gui_callback is None else 1
        key, k = prng.split(key)
        t0 = time.time()
        if chained is not None and k_len == n_chain:
            if mesh is not None:  # one camera per data row
                cam_idxs = [[bucket_of[pop_camera()][1] for _ in range(data_shards)]
                            for _ in range(n_chain)]
            else:
                cam_idxs = [bucket_of[pop_camera()][1] for _ in range(n_chain)]
            state, opt_state, metrics = chained(state, opt_state, cam_idxs, k)
            metrics = _read_metrics(metrics)
            loss = metrics["loss_mean"]
            n_stepped = n_chain
        elif mesh is not None:
            cam_idx = [bucket_of[pop_camera()][1] for _ in range(data_shards)]
            state, opt_state, metrics = step(state, opt_state, cam_idx, k)
            metrics = _read_metrics(metrics)
            loss = metrics["loss"]
            n_stepped = 1
        else:
            b, cam_idx = bucket_of[pop_camera()]
            fn = step if b == 0 else bucket_step(b)
            # reference-exact: densify iterations render and collect stats
            # but drop the Adam update (train.py:118-128)
            apply = not is_densify_iter(iteration) if discard_densify_grad else None
            state, opt_state, metrics = fn(state, opt_state, cam_idx, k, apply)
            metrics = _read_metrics(metrics)
            loss = metrics["loss"]
            n_stepped = 1
        if mesh is not None:
            profiling.count("train.eager", n_stepped)
        dt = time.time() - t0
        it_times.extend([dt / n_stepped] * n_stepped)
        iteration += n_stepped - 1

        if not np.isfinite(loss):
            # crash forensics (the reference's rasterizer debug dump,
            # reference README.md:143-146): with --debug, snapshot the
            # training state for offline repro before aborting
            if pipe.debug:
                dump = os.path.join(model.model_path or ".", f"snapshot_{iteration}.npz")
                np.savez(
                    dump, iteration=iteration,
                    cam_idx=np.asarray(cam_idx if n_stepped == 1 else cam_idxs),
                    active=state.active.cpu().numpy(),
                    **{f"param_{kk}": v.detach().cpu().numpy()
                       for kk, v in state.params.items()},
                )
                print(f"[ITER {iteration}] non-finite loss; dumped {dump}", flush=True)
            raise FloatingPointError(
                f"non-finite loss {loss} at iteration {iteration}"
                + ("" if pipe.debug else " (re-run with --debug for a dump)"))

        ema_loss = 0.4 * loss + 0.6 * ema_loss

        # pair overflow: grow the exhausted budget (the reference never
        # drops; its CUDA rasterizer allocates the key buffer per frame).
        # Two causes, each with its own knob: the global pair budget, and
        # the per-gaussian tile cap (whose drops a bigger max_pairs alone
        # can never clear).
        mt_capped = metrics["num_mt_capped_pairs"]
        if "num_budget_dropped" in metrics:  # chained: per-step difference
            budget_dropped = metrics["num_budget_dropped"]
        else:
            budget_dropped = metrics["num_dropped_pairs"] - mt_capped
        tile_capped = metrics["num_tile_capped"]
        # tier-capped pairs are the mt-capped ones whose loss is the small
        # tier's slot width: shrinking tier_frac recovers them
        tier_capped = metrics["num_tier_capped_pairs"]
        # chained runs pre-difference mt - tier per inner step
        mt_only = metrics.get("num_mt_only_capped", mt_capped - tier_capped)
        grow_budget = budget_dropped > 0 and settings.max_pairs < (1 << 26)
        # the tile cap may grow until one gaussian can cover the whole
        # frame, or until the dense expansion grid passes ~64M slots
        mt_frame_cap = frame_tile_cap(width, height)

        def _expansion_slots(mt):
            tf = settings.tier_frac
            ca = min(int(state.capacity * tf) // 8 * 8, state.capacity)
            return ca * max(2, mt // 4) + (state.capacity - ca) * mt

        new_expansion = settings.expansion
        if settings.expansion == "compact":
            # the compact expansion sorts max_pairs entries whatever mt is
            mt_cap = mt_frame_cap
        else:
            mt_cap = 16
            while mt_cap < mt_frame_cap and _expansion_slots(mt_cap * 2) <= (1 << 26):
                mt_cap *= 2
            if mt_only > 0 and settings.max_tiles_per_gauss >= mt_cap and mt_frame_cap > mt_cap:
                # the grid hit its slot bound with pairs still capped: the
                # compact expansion affords a bigger mt at max_pairs sort cost
                new_expansion = "compact"
                mt_cap = mt_frame_cap
        grow_mt = mt_only > 0 and settings.max_tiles_per_gauss < mt_cap
        # the a2a splat exchange's send budget overflowed: splats vanish
        # from strips they overlap (sharded runs only)
        exch_dropped = metrics.get("num_exchange_dropped", 0)
        grow_a2a = exch_dropped > 0 and settings.splat_exchange == "a2a"
        back_off_tier = tier_capped > 0 and settings.tier_frac > 0
        # the scan's fixed depth truncated a live tile (the kernel never
        # caps; this fires on scan-backend runs only)
        grow_mspt = tile_capped > 0 and settings.max_splats_per_tile < (1 << 16)
        if (grow_budget or grow_mt or grow_mspt or back_off_tier or grow_a2a
                or new_expansion != settings.expansion):
            new_budget = settings.max_pairs * (2 if grow_budget else 1)
            new_mt = settings.max_tiles_per_gauss * (2 if grow_mt else 1)
            new_mspt = settings.max_splats_per_tile * (2 if grow_mspt else 1)
            new_tier = settings.tier_frac
            if back_off_tier:
                new_tier = settings.tier_frac / 2
                if new_tier < 0.25:  # too small a tier saves no sort time
                    new_tier = 0.0
            new_a2a = settings.a2a_rows
            if grow_a2a:  # state.capacity: this rank's rows
                from gsjax_torch.parallel.shard import _a2a_rows_auto

                new_a2a = 2 * _a2a_rows_auto(state.capacity, gauss_shards, settings.a2a_rows)
            print(
                f"[ITER {iteration}] pair overflow "
                f"(budget dropped {budget_dropped}, tile-capped {mt_capped}, "
                f"tier-capped {tier_capped}, tile-truncated {tile_capped}, "
                f"exchange-dropped {exch_dropped}): "
                f"max_pairs {settings.max_pairs} -> {new_budget}, "
                f"tile cap {settings.max_tiles_per_gauss} -> {new_mt}, "
                f"splats/tile {settings.max_splats_per_tile} -> {new_mspt}, "
                f"tier_frac {settings.tier_frac} -> {new_tier}, "
                f"a2a rows {settings.a2a_rows} -> {new_a2a}, "
                f"expansion {new_expansion}",
                flush=True,
            )
            # --quiet swallows stdout, so budget reactions also land in
            # the jsonl
            logs.write({
                "iter": iteration, "event": "pair_overflow",
                "budget_dropped": budget_dropped, "mt_capped": mt_capped,
                "tier_capped": tier_capped, "tile_truncated": tile_capped,
                "exchange_dropped": exch_dropped,
                "max_pairs": new_budget, "max_tiles_per_gauss": new_mt,
                "max_splats_per_tile": new_mspt, "tier_frac": new_tier,
                "a2a_rows": new_a2a, "expansion": new_expansion,
            })
            settings = dataclasses.replace(
                settings, max_pairs=new_budget, max_tiles_per_gauss=new_mt,
                max_splats_per_tile=new_mspt, tier_frac=new_tier,
                a2a_rows=new_a2a, expansion=new_expansion,
            )
            cfg = dataclasses.replace(cfg, settings=settings)
            step, chained = build_steps(cfg)
            extra_bucket_steps.clear()
            densify_step, reset_step = make_densify_step(opt, cfg)
            render_fn = make_render_fn(cfg)
        elif (budget_dropped > 0 or mt_only > 0 or tier_capped > 0
              or tile_capped > 0) and iteration % 100 == 0:
            # residual drops with no reaction left: every relevant knob is
            # at its ceiling; say which, at the logging cadence
            pinned = []
            if budget_dropped > 0 and settings.max_pairs >= (1 << 26):
                pinned.append("max_pairs@1<<26")
            if mt_only > 0 and settings.max_tiles_per_gauss >= mt_cap:
                pinned.append(f"max_tiles_per_gauss@{settings.max_tiles_per_gauss}"
                              f"(cap {mt_cap}, expansion {settings.expansion})")
            if tier_capped > 0 and settings.tier_frac == 0:
                pinned.append("tier_frac@0")
            if tile_capped > 0 and settings.max_splats_per_tile >= (1 << 16):
                pinned.append("max_splats_per_tile@1<<16")
            logs.write({
                "iter": iteration, "event": "pair_overflow_pinned",
                "budget_dropped": budget_dropped, "mt_capped": mt_capped,
                "tier_capped": tier_capped, "tile_truncated": tile_capped,
                "ceiling_pinned": pinned,
            })
            if not quiet:
                print(f"[ITER {iteration}] residual pair drops (budget {budget_dropped}, "
                      f"mt {mt_only}, tier {tier_capped}) with ceilings pinned: "
                      f"{', '.join(pinned) or 'unknown'}", flush=True)

        if iteration % 100 == 0 or (not quiet and time.time() - last_progress > 30):
            n_act = metrics["num_active"]
            k = min(len(it_times), 100)
            rate = k / max(sum(it_times[-k:]), 1e-9)
            last_progress = time.time()
            if not quiet:
                print(f"[ITER {iteration}] loss {ema_loss:.5f} | gaussians {n_act} | "
                      f"{rate:.2f} it/s", flush=True)
            logs.write({
                "iter": iteration, "loss": loss, "ema_loss": ema_loss,
                "num_active": n_act, "dropped_pairs": metrics["num_dropped_pairs"],
                "it_per_s": rate,
            })

        # the whole state, on every rank of a sharded run (a collective)
        whole = state
        if mesh is not None and (iteration in testing_iterations
                                 or iteration in saving_iterations):
            whole = gather_gaussian_state(state, mesh)

        if iteration in testing_iterations and main:
            media = []
            report = evaluate_state(whole, scene, render_fn, bg, num_train_views=5,
                                    media=media)
            print(f"[ITER {iteration}] eval: {report}", flush=True)
            logs.write({"iter": iteration, "eval": report})
            opacities = torch.sigmoid(whole.params["opacity"].detach()[whole.active, 0])
            logs.write_eval_media(iteration, media, opacities.cpu().numpy())

        if iteration in saving_iterations and main:
            print(f"[ITER {iteration}] Saving Gaussians", flush=True)
            scene.save(iteration, whole)
        del whole

        # densification (reference train.py:112-123)
        if iteration < opt.densify_until_iter:
            if iteration > opt.densify_from_iter and iteration % opt.densification_interval == 0:
                key, k = prng.split(key)
                use_screen = iteration > opt.opacity_reset_interval
                if mesh is not None:
                    # every rank densifies the gathered state alike (the
                    # same key draws the same split noise)
                    state, opt_state = to_whole(state, opt_state)
                state, opt_state, dstats = densify_step(state, opt_state, k,
                                                        use_screen_size=use_screen)
                d = _read_metrics({**dstats._asdict(), "num_active": state.num_active})
                n_act = d["num_active"]
                logs.write({
                    "iter": iteration, "event": "densify",
                    "cloned": d["num_cloned"], "split": d["num_split"],
                    "pruned": d["num_pruned"], "pruned_opacity": d["num_pruned_opacity"],
                    "pruned_screen": d["num_pruned_screen"],
                    "pruned_world": d["num_pruned_world"],
                    "add_dropped": d["num_dropped"], "num_active": n_act,
                })
                if d["num_dropped"] > 0 or n_act > GROW_WATERMARK * state.capacity:
                    t_grow = time.time()
                    old_c, new_c = state.capacity, state.capacity * 2
                    print(f"[ITER {iteration}] growing capacity {old_c} -> {new_c}",
                          flush=True)
                    state = grow_capacity(state, new_c)
                    opt_state = grow_optimizer(opt_state, state.params)
                    step, chained = build_steps(cfg)
                    extra_bucket_steps.clear()
                    densify_step, reset_step = make_densify_step(opt, cfg)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    pause = time.time() - t_grow
                    print(f"[ITER {iteration}] growth pause {pause:.2f}s", flush=True)
                    logs.write({"iter": iteration, "event": "capacity_growth",
                                "capacity": new_c, "precompiled": [],
                                "pause_s": round(pause, 2)})
                if mesh is not None:  # back to this rank's rows
                    state, opt_state = to_ranks(state, opt_state)

            if iteration % opt.opacity_reset_interval == 0 or (
                model.white_background and iteration == opt.densify_from_iter
            ):
                state, opt_state = reset_step(state, opt_state)

        if iteration in checkpoint_iterations:
            print(f"[ITER {iteration}] Saving Checkpoint", flush=True)
            whole, whole_opt = (state, opt_state) if mesh is None else to_whole(state, opt_state)
            if main:
                save_checkpoint(os.path.join(model.model_path, f"chkpnt{iteration}.npz"),
                                whole, whole_opt, iteration)
            del whole, whole_opt

        stop_req = False
        if main:  # the main rank reads the STOP file; the others follow it
            stop_file = os.path.join(model.model_path, "STOP")
            stop_req = os.path.exists(stop_file)
            if stop_req:
                os.remove(stop_file)
        stop = (wall_budget > 0 and time.time() - t_start > wall_budget) or stop_req
        if mesh is not None:  # every rank stops at the same iteration
            flags = comm.pmax(torch.tensor([int(stop), int(stop_req)], device=dev),
                              None).tolist()
            stop, stop_req = bool(flags[0]), bool(flags[1])
        if stop:
            print(f"[ITER {iteration}] "
                  + ("STOP file" if stop_req else f"wall budget ({wall_budget:.0f}s)")
                  + " — saving checkpoint + snapshot and stopping", flush=True)
            whole, whole_opt = (state, opt_state) if mesh is None else to_whole(state, opt_state)
            if main:
                save_checkpoint(os.path.join(model.model_path, f"chkpnt{iteration}.npz"),
                                whole, whole_opt, iteration)
                scene.save(iteration, whole)
            logs.write({"iter": iteration, "event": "wall_budget_stop",
                        "budget_s": wall_budget})
            break

    wall = time.time() - t_start
    logs.close()
    if not quiet:
        print(f"Training complete in {wall:.1f}s", flush=True)
    if mesh is not None:
        state = gather_gaussian_state(state, mesh)
    scene.gaussians = state
    return scene, state


@torch.no_grad()
def evaluate_state(state, scene, render_fn, bg, num_train_views=5, media=None):
    """Test-split and first-k-train-view L1 / PSNR (reference
    training_report, train.py:156-191). When ``media`` is a list, up to 5
    (name, HWC image) pairs are appended for TensorBoard."""
    report = {}
    configs = [
        ("test", scene.get_test_cameras()),
        ("train", scene.get_train_cameras()[:num_train_views]),
    ]
    for name, cams in configs:
        if not cams:
            continue
        l1s, psnrs = [], []
        for i, cam in enumerate(cams):
            img = torch.clamp(render_fn(state, cam.to_render_camera(state.device), bg), 0.0, 1.0)
            gt = torch.clamp(torch.as_tensor(np.asarray(cam.image), device=img.device), 0.0, 1.0)
            l1s.append(l1_loss(img, gt))
            psnrs.append(psnr(img, gt))
            if media is not None and i < 5 and len(media) < 5:
                media.append((f"{name}_{cam.image_name}", img.cpu().numpy()))
        l1s, psnrs = torch.stack(l1s).tolist(), torch.stack(psnrs).tolist()
        report[name] = {
            "l1": float(np.mean(l1s)),
            "psnr": float(np.mean(psnrs)),
            "n_views": len(cams),
        }
    return report
