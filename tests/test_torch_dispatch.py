"""The port's sync-free training step and chained dispatch, on the CPU:
the pieces a captured CUDA graph needs, each held against what it
replaces (the host-synchronising reduction, the list camera, Adam with
host scalars, the functional statistics) bit for bit, and the chained
dispatch built from static per-step rows against single steps and gsjax's
scanned dispatch. The graphs themselves need a card
(``tests/test_torch_cuda.py``)."""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from gsjax.configs import OptimizationParams as JOpt
from gsjax.ops import RasterizeSettings as JSettings
from gsjax_torch.configs import OptimizationParams as TOpt
from gsjax_torch.ops import RasterizeSettings as TSettings
from gsjax_torch.ops.cuda_composite import (
    GRAD_W, pack_bf16_pairs, reduce_pair_grads, unpack_bf16_pairs,
)
from gsjax_torch.utils import graphs, prng
from test_torch_render import _carry, _gsjax_state, one_torch_thread  # noqa: F401
from test_torch_train import STEP_KW, _train_setup
from test_torch_train_composite import _norm_close


def _reduce_with_host_reads(pair_grads, pair_gauss, tile_start, n_gauss):
    """The reduction as it was before it was made sync-free: the valid
    count and the segment lengths (``bincount``) read on the host."""
    num_valid = int(tile_start[-1])
    if num_valid == 0:
        return torch.zeros((n_gauss, GRAD_W), dtype=torch.float32)
    g, order = torch.sort(pair_gauss[:num_valid].to(torch.int64), stable=True)
    lengths = torch.bincount(g, minlength=n_gauss)
    rows = pair_grads[:num_valid][order]
    if rows.dtype == torch.int32:
        rows = unpack_bf16_pairs(rows)
    return torch.segment_reduce(rows, "sum", lengths=lengths, axis=0, unsafe=True)


@pytest.mark.parametrize("num_valid", ["none", "partial", "all"])
@pytest.mark.parametrize("table", ["float32", "bfloat16"])
def test_reduction_without_host_reads_is_bit_for_bit(table, num_valid):
    gen = torch.Generator().manual_seed(3)
    p, n = 6000, 400
    grads = torch.randn(p, GRAD_W, generator=gen) * torch.exp(
        4 * torch.randn(p, 1, generator=gen))
    pair_gauss = torch.randint(0, n - 7, (p,), generator=gen, dtype=torch.int32)
    valid = {"none": 0, "partial": 4321, "all": p}[num_valid]
    tile_start = torch.tensor([0, valid // 3, valid], dtype=torch.int32)
    if table == "bfloat16":
        grads = pack_bf16_pairs(grads)
    got = reduce_pair_grads(grads, pair_gauss, tile_start, n)
    want = _reduce_with_host_reads(grads, pair_gauss, tile_start, n)
    assert got.shape == (n, GRAD_W) and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if valid == 0:
        assert not got.any()


def test_stacked_camera_indexed_on_the_device_is_the_list_camera():
    from gsjax_torch.data.cameras import index_render_camera, stack_render_cameras
    from gsjax_torch.models.gaussians import activated
    from gsjax_torch.ops.rasterize import render

    _, _, tcams, _ = _train_setup()
    rcams = [c.to_render_camera("cpu") for c in tcams]
    batch = stack_render_cameras(tcams, "cpu")
    assert len(batch) == 2 and batch.world_view.shape == (2, 4, 4)
    state = _carry(_gsjax_state(n=300, capacity=512, seed=1))
    args = dict(settings=TSettings(**STEP_KW))
    for i, rc in enumerate(rcams):
        for idx in (i, torch.tensor(i)):
            cam = index_render_camera(batch, idx)
            assert (cam.width, cam.height) == (rc.width, rc.height)
            for k in ("world_view", "full_proj", "camera_center", "tan_fov_x", "tan_fov_y"):
                assert torch.equal(getattr(cam, k), getattr(rc, k)), k
        a = render(batch[torch.tensor(i)], *activated(state), 3, torch.zeros(3), **args)
        b = render(rc, *activated(state), 3, torch.zeros(3), **args)
        assert torch.equal(a["render"], b["render"])


def _adam_step_with_host_scalars(opt):
    """``GaussianAdam.step`` as it was: the lrs and bias corrections as
    Python floats handed to the foreach ops."""
    from gsjax_torch.train.optim import BETAS, EPS, _sqrt_

    opt.set_lrs()
    b1, b2 = BETAS
    ps, grads, mus, nus, bc1, bc2, lrs = [], [], [], [], [], [], []
    for group in opt.param_groups:
        p = group["params"][0]
        if p.grad is None:
            continue
        st = opt.state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.float32)
            st["exp_avg"] = torch.zeros_like(p)
            st["exp_avg_sq"] = torch.zeros_like(p)
        st["step"] += 1
        count = st["step"].float()
        bc1.append(float(1 - torch.tensor(b1, dtype=torch.float32) ** count))
        bc2.append(float(1 - torch.tensor(b2, dtype=torch.float32) ** count))
        ps.append(p)
        grads.append(p.grad)
        mus.append(st["exp_avg"])
        nus.append(st["exp_avg_sq"])
        lrs.append(group["lr"])
    with torch.no_grad():
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, sq)
        den = torch._foreach_div(nus, bc2)
        _sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, lrs)
        torch._foreach_sub_(ps, upd)
    opt.count += 1


def _params(rng, n=64):
    from gsjax_torch.models.gaussians import PARAM_KEYS

    shapes = {"xyz": (n, 3), "features_dc": (n, 1, 3), "features_rest": (n, 15, 3),
              "scaling": (n, 3), "rotation": (n, 4), "opacity": (n, 1)}
    return {k: rng.normal(0, 1, shapes[k]).astype(np.float32) for k in PARAM_KEYS}


@pytest.mark.parametrize("partial", [False, True], ids=["every_group", "some_groups"])
def test_adam_rows_equal_host_scalars_and_optax(partial):
    """Adam reading its lrs and bias corrections from a row tensor (the
    graph's static buffer) equals the host-scalar update bit for bit, and,
    every group stepping, optax's update."""
    from gsjax.train.optim import make_optimizer as j_make_opt
    from gsjax_torch.train.optim import ROW_W, adam_moments, make_optimizer

    rng = np.random.default_rng(5)
    p0 = _params(rng)
    tx = make_optimizer(TOpt(), 2.5)
    new = tx.init({k: torch.from_numpy(v.copy()) for k, v in p0.items()})
    old = tx.init({k: torch.from_numpy(v.copy()) for k, v in p0.items()})
    jtx = j_make_opt(JOpt(), 2.5)
    jp = {k: jax.numpy.asarray(v) for k, v in p0.items()}
    jst = jtx.init(jp)
    skip = {"features_rest", "opacity"} if partial else set()
    for i in range(6):
        g = {k: rng.normal(0, 10.0 ** rng.integers(-6, 2), v.shape).astype(np.float32)
             for k, v in p0.items()}
        for opt in (new, old):
            for k in p0:
                opt.param(k).grad = None if k in skip else torch.from_numpy(g[k])
        new.step()
        _adam_step_with_host_scalars(old)
        assert new.count == old.count == i + 1
        for k in p0:
            assert torch.equal(new.param(k).detach(), old.param(k).detach()), (i, k)
        for a, b in zip(adam_moments(new), adam_moments(old)):
            for k in p0:
                assert torch.equal(a[k], b[k]), (i, k)
        if not partial:
            upd, jst = jtx.update(g, jst, jp)
            jp = optax.apply_updates(jp, upd)
            for k in p0:
                np.testing.assert_array_equal(new.param(k).detach().numpy(),
                                              np.asarray(jp[k]), err_msg=f"{i} {k}")
    # the two halves apart: one row of ROW_W values on the parameters' device
    for k in p0:
        new.param(k).grad = torch.zeros_like(new.param(k))
    row = new.advance()
    assert len(row) == ROW_W and new.count == 7
    new.update(torch.tensor(row))


def test_in_place_densification_stats_equal_the_functional_ones():
    from gsjax_torch.models.densify import add_densification_stats, add_densification_stats_
    state = _carry(_gsjax_state(n=300, capacity=512, seed=2))
    rng = np.random.default_rng(2)
    state = dataclasses.replace(
        state, max_radii2d=torch.from_numpy(rng.uniform(0, 4, 512).astype(np.float32)),
        xyz_grad_accum=torch.from_numpy(rng.uniform(0, 1e-3, 512).astype(np.float32)),
        denom=torch.from_numpy(rng.integers(0, 5, 512).astype(np.float32)))
    ptrs = [t.data_ptr() for t in (state.max_radii2d, state.xyz_grad_accum, state.denom)]
    for _ in range(3):
        grad = torch.from_numpy(rng.normal(0, 1e-4, (512, 2)).astype(np.float32))
        radii = torch.from_numpy(rng.integers(-2, 9, 512).clip(0).astype(np.int32))
        want = add_densification_stats(state, grad, radii, 64, 48)
        got = add_densification_stats_(state, grad, radii, 64, 48)
        assert got is state
        for name in ("max_radii2d", "xyz_grad_accum", "denom"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert ptrs == [t.data_ptr() for t in (state.max_radii2d, state.xyz_grad_accum,
                                           state.denom)]


def test_band_mask_is_the_band_table():
    from gsjax_torch.utils.sh import band_mask

    bands = (0,) + (1,) * 3 + (2,) * 5 + (3,) * 7
    for k in (1, 4, 9, 16):
        for degree in range(4):
            want = torch.tensor([float(b <= degree) for b in bands[:k]])
            assert torch.equal(band_mask(k, degree, torch.float32, "cpu"), want)


@pytest.mark.parametrize("random_background", [False, True], ids=["black", "random_bg"])
def test_chained_dispatch_equals_single_steps_and_gsjax_scan(random_background):
    """n iterations of the chained dispatch (static rows: camera indices,
    backgrounds and Adam rows, one per step) against n single steps with
    gsjax's per-step keys ``fold_in(key, i)``, bit for bit; and against
    gsjax's ``make_train_step_chained`` (a ``lax.scan``) within the
    tolerances ``test_torch_train.py::test_train_step_matches_gsjax``
    states for a step."""
    from gsjax.data.cameras import stack_render_cameras as j_stack
    from gsjax.train.optim import make_optimizer as j_make_opt
    from gsjax.train.step import TrainConfig as JCfg
    from gsjax.train.step import make_train_step_chained as j_chained
    from gsjax_torch.data.cameras import stack_render_cameras
    from gsjax_torch.train.optim import make_optimizer
    from gsjax_torch.train.step import TrainConfig as TCfg
    from gsjax_torch.train.step import make_train_step, make_train_step_chained
    from gsjax_torch.train.step import snapshot, snapshot_differences

    n = 3
    jstate, jcams, tcams, images = _train_setup()
    cams = stack_render_cameras(tcams, "cpu")
    cfg = TCfg(settings=TSettings(backend="scan", **STEP_KW), extent=3.0,
               random_background=random_background)
    tx = make_optimizer(TOpt(), 3.0)
    key = prng.PRNGKey(7)
    idxs = [1, 0, 1]

    a = _carry(jstate)
    opt_a = tx.init(a.params)
    a, opt_a, m = make_train_step_chained(tx, cams, images, cfg, n)(a, opt_a, idxs, key)
    b = _carry(jstate)
    opt_b = tx.init(b.params)
    step = make_train_step(tx, cams, images, cfg)
    losses = []
    for i in range(n):
        b, opt_b, mb = step(b, opt_b, idxs[i], prng.fold_in(key, i))
        losses.append(mb["loss"])
    assert snapshot_differences(snapshot(a, opt_a), snapshot(b, opt_b)) == []
    assert opt_a.count == opt_b.count == n
    assert torch.equal(m["loss"], losses[-1])
    assert torch.equal(m["loss_mean"], torch.stack(losses).mean())

    jtx = j_make_opt(JOpt(), 3.0)
    jcfg = JCfg(settings=JSettings(backend="xla", **STEP_KW), extent=3.0,
                random_background=random_background)
    js, _, jm = j_chained(jtx, j_stack(jcams), images, jcfg, n)(
        jstate, jtx.init(jstate.params), jax.numpy.asarray(idxs, jax.numpy.int32),
        jax.numpy.asarray(key))
    assert float(m["loss_mean"]) == pytest.approx(float(jm["loss_mean"]), rel=2e-4)
    for k in ("num_dropped_pairs", "num_budget_dropped", "num_mt_only_capped", "num_active"):
        assert int(m[k]) == int(jm[k]), k
    for k, v in js.params.items():
        # each parameter's update over the steps, against its largest (the
        # rule the step test applies to Adam's first moment)
        p0 = np.asarray(jstate.params[k])
        _norm_close(a.params[k].detach().numpy() - p0, np.asarray(v) - p0, k, 2e-3)
        if not random_background:  # and the step test's own bound
            np.testing.assert_allclose(a.params[k].detach().numpy(), np.asarray(v),
                                       rtol=1e-5, atol=2e-5, err_msg=k)
    np.testing.assert_array_equal(a.max_radii2d.numpy(), np.asarray(js.max_radii2d))
    np.testing.assert_array_equal(a.denom.numpy(), np.asarray(js.denom))
    _norm_close(a.xyz_grad_accum.numpy(), js.xyz_grad_accum, "grad accum", 2e-3)


def test_densify_writes_the_state_and_moments_in_place():
    """The densify and reset steps keep every tensor a captured step is
    bound to at its address."""
    from gsjax_torch.data.cameras import stack_render_cameras
    from gsjax_torch.train.optim import adam_moments, make_optimizer
    from gsjax_torch.train.step import TrainConfig as TCfg
    from gsjax_torch.train.step import make_densify_step, make_train_step

    jstate, _, tcams, images = _train_setup()
    state = _carry(jstate)
    tx = make_optimizer(TOpt(), 3.0)
    opt = tx.init(state.params)
    cfg = TCfg(settings=TSettings(backend="scan", **STEP_KW), extent=3.0)
    step = make_train_step(tx, stack_render_cameras(tcams, "cpu"), images, cfg)
    for i in range(2):
        state, opt, _ = step(state, opt, i)

    def bound(s, o):
        mu, nu = adam_moments(o)
        return graphs.addresses(*s.params.values(), s.active, s.max_radii2d,
                                s.xyz_grad_accum, s.denom, *mu.values(), *nu.values())

    before = bound(state, opt)
    densify, reset = make_densify_step(TOpt(densify_grad_threshold=0.0), cfg)
    state2, opt, stats = densify(state, opt, prng.PRNGKey(1), False)
    assert int(stats.num_cloned) + int(stats.num_split) > 0
    assert bound(state2, opt) == before and not state2.denom.any()
    state3, opt = reset(state2, opt)
    assert bound(state3, opt) == before
    state3, opt, m = step(state3, opt, 0)
    assert np.isfinite(float(m["loss"]))


def test_graph_cache_binds_keys_to_addresses():
    cache = graphs.GraphCache()
    made = []

    def make():
        made.append(object())
        return made[-1]

    a = cache.get(("k", 1), (1, 2), make)
    assert cache.get(("k", 1), (1, 2), make) is a and cache.captures == 1
    b = cache.get(("k", 1), (1, 3), make)  # the same key, tensors moved
    assert b is not a and cache.captures == 2 and len(cache.entries) == 1
    cache.get(("k", 2), (1, 3), make)
    cache.get(("k", 3), (1, 3), make)
    assert list(cache.entries) == [("k", 2), ("k", 3)]  # the oldest went


def test_pin_copy_and_clone_outputs_on_the_cpu():
    buf = torch.zeros(2, 3)
    graphs.pin_copy_(buf, [[1, 2, 3], [4, 5, 6]])
    assert buf.tolist() == [[1, 2, 3], [4, 5, 6]]
    out = {"a": buf, "b": (buf[0], buf[1])}
    got = graphs.clone_outputs(out)
    buf.zero_()
    assert got["a"].tolist() == [[1, 2, 3], [4, 5, 6]] and got["b"][1].tolist() == [4, 5, 6]
