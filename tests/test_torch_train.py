"""gsjax_torch's training slice against gsjax, on the CPU: losses and
metrics, the learning-rate schedule, per-group Adam (with the optimizer
state carried over mid-training), model creation and growth, and the train
step itself on both backend pairs (scan against gsjax's XLA scan, the
kernel backend's plain versions against gsjax's Pallas kernels in
interpret mode). Same numpy inputs from seeds on both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import make_test_camera
from gsjax.configs import OptimizationParams as JOpt
from gsjax.ops import RasterizeSettings as JSettings
from gsjax_torch.configs import OptimizationParams as TOpt
from gsjax_torch.data.cameras import Camera as TCamera
from gsjax_torch.ops import RasterizeSettings as TSettings
from gsjax_torch.utils import prng
from gsjax_torch.utils.profiling import launches
from test_torch_render import BACKENDS, _carry, _gsjax_state, one_torch_thread  # noqa: F401
from test_torch_train_composite import _norm_close


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# (e) losses, metrics, schedule, optimizer
# --------------------------------------------------------------------------


def test_losses_and_metrics_match_gsjax():
    from gsjax.eval import metrics as jm
    from gsjax.train import loss as jl
    from gsjax_torch.eval import metrics as tm
    from gsjax_torch.train import loss as tl

    rng = np.random.default_rng(0)
    for h, w in ((48, 64), (37, 50)):
        a = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
        for name, tf, jf in (("l1", tl.l1_loss, jl.l1_loss), ("l2", tl.l2_loss, jl.l2_loss),
                             ("ssim", tl.ssim, jl.ssim), ("mse", tm.mse, jm.mse),
                             ("psnr", tm.psnr, jm.psnr)):
            got, want = float(tf(_t(a), _t(b))), float(jf(jnp.asarray(a), jnp.asarray(b)))
            # float32 means over a few thousand values: summation order
            assert got == pytest.approx(want, rel=1e-5, abs=1e-7), name
        assert float(tl.ssim(_t(a), _t(a))) == pytest.approx(1.0, abs=1e-6)
        for lam in (0.2, 0.5):
            ta = _t(a).requires_grad_(True)
            loss = tl.photometric_loss(ta, _t(b), lam)
            loss.backward()
            jloss, jg = jax.value_and_grad(lambda x: jl.photometric_loss(x, b, lam))(
                jnp.asarray(a))
            assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
            np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg), rtol=1e-4,
                                       atol=1e-5 * float(np.abs(jg).max()))


def test_lr_schedule_matches_gsjax():
    """float32 throughout, in gsjax's order; the argument of exp is the same
    bit for bit, and XLA's CPU exp and torch's differ by at most one ulp."""
    from gsjax.utils.schedules import expon_lr_schedule as j_sched
    from gsjax_torch.utils.schedules import expon_lr_schedule as t_sched

    steps = np.concatenate([[-3, 0, 1, 2], np.arange(7, 31_000, 997)])
    for args in ((4.8e-4, 4.8e-6, 0, 0.01, 30_000), (1e-3, 1e-5, 500, 0.01, 30_000),
                 (0.0, 0.0)):
        j, t = j_sched(*args), t_sched(*args)
        want = np.array([np.float32(j(int(s))) for s in steps])
        got = np.array([t(int(s)).item() for s in steps], np.float32)
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
        assert (got[steps < 0] == 0).all()


def _params(rng, n=64):
    return {
        "xyz": rng.normal(0, 1, (n, 3)), "features_dc": rng.normal(0, 0.5, (n, 1, 3)),
        "features_rest": rng.normal(0, 0.1, (n, 15, 3)), "scaling": rng.normal(-2, 0.3, (n, 3)),
        "rotation": rng.normal(0, 1, (n, 4)), "opacity": rng.normal(0, 1, (n, 1)),
    }


def test_adam_matches_optax_and_carries_state_over():
    """The port's Adam applies optax's update in optax's float32 order
    (bias corrections ``1 - b**count`` in float32, ``(mu / bc1) / (sqrt(nu /
    bc2) + eps)``, then ``* lr``): parameters and moments equal gsjax's bit
    for bit after every step, also after a mid-training state is carried
    over and after Adam's count is set apart from the lr count (as a
    reference checkpoint's is)."""
    from gsjax.train import optim as jo
    from gsjax_torch.train import optim as to

    rng = np.random.default_rng(0)
    p0 = {k: v.astype(np.float32) for k, v in _params(rng).items()}
    grads = [{k: rng.normal(0, 1e-3, v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(6)]
    grads[2]["opacity"][:] = 0.0  # a zero gradient still decays the moments

    jtx = jo.make_optimizer(JOpt(), 3.0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jtx.init(jp)
    ttx = to.make_optimizer(TOpt(), 3.0)
    tp = {k: _t(v) for k, v in p0.items()}
    opt = ttx.init(tp)
    assert all(v.requires_grad and v.is_leaf for v in tp.values())
    for i, g in enumerate(grads):
        upd, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = _t(g[k])
        opt.step()
        assert opt.count == i + 1
        for k in p0:
            np.testing.assert_array_equal(tp[k].detach().numpy(), np.asarray(jp[k]),
                                          err_msg=f"step {i} {k}")
        if i == 2:  # carry the mid-training state over into a fresh optimizer
            mu, nu = jo.adam_moments(jstate)
            tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
            opt = to.opt_state_from_numpy(
                {k: np.asarray(v) for k, v in mu.items()},
                {k: np.asarray(v) for k, v in nu.items()},
                int(jstate[1].count), ttx.init(tp))
            back_mu, back_nu, count = to.opt_state_to_numpy(opt)
            assert count == 3
            for k in p0:
                np.testing.assert_array_equal(back_mu[k], np.asarray(mu[k]))
                np.testing.assert_array_equal(back_nu[k], np.asarray(nu[k]))
        if i == 3:  # Adam's own count set apart from the lr count
            jstate = (jstate[0]._replace(count=jnp.int32(17)),) + tuple(jstate[1:])
            opt = to.with_adam_moments(opt, *to.adam_moments(opt), count=17)
            assert to.adam_count(opt) == 17 and opt.count == 4
    assert to.adam_count(opt) == int(jstate[0].count) == 19
    tmu, tnu = to.adam_moments(opt)
    jmu, jnu = jo.adam_moments(jstate)
    for k in p0:
        np.testing.assert_array_equal(tmu[k].numpy(), np.asarray(jmu[k]))
        np.testing.assert_array_equal(tnu[k].numpy(), np.asarray(jnu[k]))
    # the lr each group used at the last step
    lrs = {g["name"]: g["lr"] for g in opt.param_groups}
    assert lrs["features_rest"] == pytest.approx(JOpt().feature_lr / 20)
    o = JOpt()
    want = jo.expon_lr_schedule(o.position_lr_init * 3.0, o.position_lr_final * 3.0,
                                lr_delay_mult=o.position_lr_delay_mult,
                                max_steps=o.position_lr_max_steps)(6)
    assert lrs["xyz"] == pytest.approx(float(want), rel=2.4e-7)


# --------------------------------------------------------------------------
# (g) model creation and growth
# --------------------------------------------------------------------------


def test_create_from_pcd_and_grow_match_gsjax():
    from gsjax.models.gaussians import create_from_pcd as j_create
    from gsjax.models.gaussians import grow_capacity as j_grow
    from gsjax.train.loop import grow_opt_state
    from gsjax.train.optim import make_optimizer as j_make_opt
    from gsjax_torch.models.gaussians import create_from_pcd as t_create
    from gsjax_torch.models.gaussians import grow_capacity as t_grow
    from gsjax_torch.models.gaussians import knn_mean_sq_dist
    from gsjax_torch.train.optim import adam_moments, grow_optimizer, make_optimizer

    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    j = j_create(pts, cols, 2.5)
    t = t_create(pts, cols, 2.5, device="cpu")
    assert t.capacity == j.capacity == 4096 and t.spatial_lr_scale == 2.5
    np.testing.assert_array_equal(t.active.numpy(), np.asarray(j.active))
    assert int(t.num_active) == int(j.num_active) == 500
    for k, v in j.params.items():
        np.testing.assert_allclose(t.params[k].numpy(), np.asarray(v), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    d = knn_mean_sq_dist(pts)
    brute = np.sort(((pts[:, None] - pts[None]) ** 2).sum(-1), axis=1)[:, 1:4].mean(1)
    np.testing.assert_allclose(d, brute, rtol=1e-5)
    # gsjax's native KD-tree, bit for bit (the same tree, heap and float32 sum)
    from gsjax.native import knn_mean_sq_dist as j_knn
    np.testing.assert_array_equal(d, j_knn(pts))
    with pytest.raises(ValueError):
        t_create(pts, cols, 1.0, capacity=100, device="cpu")

    # grow the state and the optimizer after one step
    opt = make_optimizer(TOpt(), 2.5).init(t.params)
    for v in t.params.values():
        v.grad = torch.full_like(v, 1e-3)
    opt.step()
    g = t_grow(t, 8192)
    jg = j_grow(j, 8192)
    assert g.capacity == jg.capacity == 8192
    for k, v in jg.params.items():
        np.testing.assert_allclose(g.params[k].detach().numpy()[4096:], np.asarray(v)[4096:])
    np.testing.assert_array_equal(g.active.numpy(), np.asarray(jg.active))
    grown = grow_optimizer(opt, g.params)
    assert grown.count == 1 and grown.param("xyz") is g.params["xyz"]
    mu, nu = adam_moments(grown)
    jtx = j_make_opt(JOpt(), 2.5)
    jo_state = grow_opt_state(jtx.init(j.params), 4096, 8192)
    for k in g.params:
        assert mu[k].shape == g.params[k].shape == np.asarray(jo_state[0].mu[k]).shape
        assert not mu[k][4096:].any() and not nu[k][4096:].any()
        assert torch.equal(mu[k][:4096], adam_moments(opt)[0][k])
    with pytest.raises(ValueError):
        t_grow(g, 100)


# --------------------------------------------------------------------------
# (f) the train step
# --------------------------------------------------------------------------

W, H = 64, 48
STEP_KW = dict(max_pairs=1 << 14, max_tiles_per_gauss=16, expansion="compact")


def _train_setup():
    """A gsjax state, two cameras, and uint8 targets rendered from the state
    with features_dc shifted by +0.3 (as numpy, for both packages)."""
    from gsjax.train.step import TrainConfig as JCfg
    from gsjax.train.step import make_render_fn

    jstate = _gsjax_state(n=300, capacity=512, seed=1)
    jcams = [make_test_camera(W, H, seed=s) for s in (1, 2)]
    p = dict(jstate.params)
    p["features_dc"] = p["features_dc"] + 0.3
    shifted = dataclasses.replace(jstate, params=p)
    rf = make_render_fn(JCfg(settings=JSettings(**STEP_KW)), as_uint8=True)
    images = np.stack([np.asarray(rf(shifted, c.to_render_camera(), jnp.zeros(3)))
                       for c in jcams])
    tcams = [TCamera(uid=c.uid, image_name=c.image_name, R=c.R, T=c.T, fov_x=c.fov_x,
                     fov_y=c.fov_y, width=c.width, height=c.height) for c in jcams]
    return jstate, jcams, tcams, images


@pytest.mark.parametrize("t_backend", list(BACKENDS))
def test_train_step_matches_gsjax(t_backend):
    from gsjax.data.cameras import stack_render_cameras as j_stack
    from gsjax.train.optim import adam_moments as j_moments
    from gsjax.train.optim import make_optimizer as j_make_opt
    from gsjax.train.step import TrainConfig as JCfg
    from gsjax.train.step import make_train_step as j_make_step
    from gsjax_torch.data.cameras import stack_render_cameras as t_stack
    from gsjax_torch.train.optim import adam_moments as t_moments
    from gsjax_torch.train.optim import make_optimizer as t_make_opt
    from gsjax_torch.train.step import TrainConfig as TCfg
    from gsjax_torch.train.step import make_train_step as t_make_step

    jstate, jcams, tcams, images = _train_setup()
    jtx = j_make_opt(JOpt(), 3.0)
    jopt = jtx.init(jstate.params)
    jstep = j_make_step(jtx, j_stack(jcams), images, JCfg(
        settings=JSettings(backend=BACKENDS[t_backend], **STEP_KW), extent=3.0))
    tstate = _carry(jstate)
    ttx = t_make_opt(TOpt(), 3.0)
    topt = ttx.init(tstate.params)
    tstep = t_make_step(ttx, t_stack(tcams, "cpu"), images, TCfg(
        settings=TSettings(backend=t_backend, **STEP_KW), extent=3.0))
    key = jax.random.PRNGKey(0)
    launched = launches()
    losses = []
    for i in range(5):
        jstate, jopt, jm = jstep(jstate, jopt, i % 2, key)
        tstate, topt, tm = tstep(tstate, topt, i % 2)
        losses.append(float(tm["loss"]))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-4), i
        assert float(tm["l1"]) == pytest.approx(float(jm["l1"]), rel=2e-4), i
        for k in ("num_dropped_pairs", "num_mt_capped_pairs", "num_tier_capped_pairs",
                  "num_active"):
            assert int(tm[k]) == int(jm[k]), (i, k)
        for k, v in jstate.params.items():
            # Adam moves a parameter by about its lr per step whatever the
            # gradient's size, so the bound is a fraction of one step
            np.testing.assert_allclose(tstate.params[k].detach().numpy(), np.asarray(v),
                                       rtol=1e-5, atol=2e-5, err_msg=f"step {i} {k}")
        np.testing.assert_array_equal(tstate.max_radii2d.numpy(), np.asarray(jstate.max_radii2d))
        np.testing.assert_array_equal(tstate.denom.numpy(), np.asarray(jstate.denom))
        _norm_close(tstate.xyz_grad_accum.numpy(), jstate.xyz_grad_accum, "grad accum", 2e-3)
    assert topt.count == 5 and losses[-1] < losses[0]
    assert launches() == launched  # CPU tensors: the plain versions
    tmu, _ = t_moments(topt)
    jmu, _ = j_moments(jopt)
    for k in tmu:
        _norm_close(tmu[k].numpy(), jmu[k], f"first moment {k}", 2e-3)


def test_apply_update_false_and_chained_step():
    from gsjax_torch.data.cameras import stack_render_cameras as t_stack
    from gsjax_torch.train.optim import adam_moments, make_optimizer
    from gsjax_torch.train.step import TrainConfig as TCfg
    from gsjax_torch.train.step import make_train_step, make_train_step_chained

    jstate, _, tcams, images = _train_setup()
    tstate = _carry(jstate)
    tx = make_optimizer(TOpt(), 3.0)
    opt = tx.init(tstate.params)
    cfg = TCfg(settings=TSettings(backend="scan", **STEP_KW), extent=3.0,
               random_background=True)
    cams = t_stack(tcams, "cpu")
    step = make_train_step(tx, cams, images, cfg)
    gen = prng.PRNGKey(0)
    tstate, opt, _ = step(tstate, opt, 0, gen)  # one real step: moments non-zero
    before = {k: v.detach().clone() for k, v in tstate.params.items()}
    mu0, nu0 = (dict((k, v.clone()) for k, v in d.items()) for d in adam_moments(opt))
    denom0 = tstate.denom.clone()
    tstate, opt, m = step(tstate, opt, 1, gen, apply_update=False)
    assert opt.count == 1
    mu1, nu1 = adam_moments(opt)
    for k, v in tstate.params.items():
        assert torch.equal(v.detach(), before[k]), k
        assert torch.equal(mu1[k], mu0[k]) and torch.equal(nu1[k], nu0[k]), k
    assert float((tstate.denom - denom0).sum()) > 0  # statistics still accumulate
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="needs a key"):
        step(tstate, opt, 0)

    # chained: n steps in one call, the counters reduced as gsjax does
    chained = make_train_step_chained(tx, cams, images, cfg, 3)
    tstate, opt, cm = chained(tstate, opt, [0, 1, 0], gen)
    assert opt.count == 4
    assert {"loss_mean", "num_budget_dropped", "num_mt_only_capped"} <= set(cm)
    assert np.isfinite(float(cm["loss_mean"])) and int(cm["num_dropped_pairs"]) == 0
