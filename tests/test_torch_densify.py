"""gsjax_torch's density control against gsjax, on the CPU: clone / split /
prune slot for slot (gsjax's split noise injected, and drawn by the port
from gsjax's key), the capacity-exhausted
case, the opacity reset, the densify step's edits of the optimizer, and the
stacking of GT images with alpha masks. Same numpy inputs from seeds on
both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsjax.configs import OptimizationParams as JOpt
from gsjax_torch.configs import OptimizationParams as TOpt
from gsjax_torch.utils import prng
from test_torch_render import _carry

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work here is many small tensor ops: one intra-op
    thread each, so that the test workers running side by side do not
    oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STAT_NAMES = ("num_cloned", "num_split", "num_pruned", "num_dropped",
              "num_pruned_opacity", "num_pruned_screen", "num_pruned_world")


def _dense_state(n, capacity, seed, split_frac=0.5, world_frac=0.05):
    """A gsjax state with ``n`` active gaussians whose densification
    statistics, scales and opacities give every decision some members:
    gradients on both sides of 2e-4, scales on both sides of
    percent_dense * extent (0.08 at extent 8), opacities below 0.005, screen
    radii above 20 px and world scales above 0.1 * extent."""
    from gsjax.models.gaussians import create_empty

    rng = np.random.default_rng(seed)
    st = create_empty(capacity)
    p = {k: np.asarray(v).copy() for k, v in st.params.items()}
    p["xyz"][:n] = rng.normal(0, 1, (n, 3))
    big = rng.uniform(0, 1, n) < split_frac
    p["scaling"][:n] = np.where(big[:, None], rng.normal(-1.8, 0.2, (n, 3)),
                                rng.normal(-3.5, 0.3, (n, 3)))
    p["scaling"][:n][rng.uniform(0, 1, n) < world_frac] = 0.0  # world-size prune
    p["rotation"][:n] = rng.normal(0, 1, (n, 4))
    p["features_dc"][:n] = rng.normal(0, 0.5, (n, 1, 3))
    p["features_rest"][:n] = rng.normal(0, 0.1, (n, 15, 3))
    p["opacity"][:n] = rng.normal(0, 1.5, (n, 1))
    p["opacity"][:n][rng.uniform(0, 1, n) < 0.1] = -6.0  # opacity prune
    denom = np.zeros(capacity, np.float32)
    denom[:n] = rng.integers(0, 6, n)
    accum = (rng.uniform(0, 4e-4, capacity) * denom).astype(np.float32)
    radii = np.zeros(capacity, np.float32)
    radii[:n] = rng.uniform(0, 30, n)
    active = np.zeros(capacity, bool)
    active[:n] = True
    return dataclasses.replace(
        st, params={k: jnp.asarray(v, jnp.float32) for k, v in p.items()},
        active=jnp.asarray(active), max_radii2d=jnp.asarray(radii),
        xyz_grad_accum=jnp.asarray(accum), denom=jnp.asarray(denom),
        active_sh_degree=jnp.int32(3))


def _carry_stats(jstate):
    t = _carry(jstate)
    return dataclasses.replace(
        t, max_radii2d=torch.from_numpy(np.array(jstate.max_radii2d)),
        xyz_grad_accum=torch.from_numpy(np.array(jstate.xyz_grad_accum)),
        denom=torch.from_numpy(np.array(jstate.denom)))


def _moments(jstate, seed):
    rng = np.random.default_rng(seed)
    mu = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32) for k, v in jstate.params.items()}
    nu = {k: rng.uniform(0, 1e-6, v.shape).astype(np.float32) for k, v in jstate.params.items()}
    return mu, nu


def _assert_state_equal(t, j, xyz_atol):
    np.testing.assert_array_equal(t.active.numpy(), np.asarray(j.active))
    for k, v in j.params.items():
        got, want = t.params[k].detach().numpy(), np.asarray(v)
        if k == "xyz":
            # the split children: xyz + R @ (eps * scale), the rotation and
            # the product rounded in two orders
            np.testing.assert_allclose(got, want, rtol=0, atol=xyz_atol, err_msg=k)
        elif k == "scaling":
            # log of exp(scaling) / 1.6 for the children: one ulp of exp and log
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    for k in ("max_radii2d", "xyz_grad_accum", "denom"):
        assert not getattr(t, k).any()


@pytest.mark.parametrize("use_screen_size", [False, True], ids=["world", "screen"])
@pytest.mark.parametrize("n,capacity", [(300, 1024), (300, 305)], ids=["room", "full"])
def test_densify_and_prune_matches_gsjax(use_screen_size, n, capacity):
    """Slot for slot, with gsjax's split noise injected; all 7 counters
    equal. The "full" state has 5 free slots for far more children: the
    excess is dropped (``num_dropped`` > 0) and no surviving gaussian's slot
    is written."""
    from gsjax.models.densify import DensifyConfig as JCfg
    from gsjax.models.densify import densify_and_prune as j_densify
    from gsjax_torch.models.densify import DensifyConfig, densify_and_prune

    extent = 8.0
    jstate = _dense_state(n, capacity, seed=3)
    mu, nu = _moments(jstate, 4)
    key = jax.random.PRNGKey(5)
    cfg = JCfg()
    jnew, jmu, jnu, jstats = j_densify(
        jstate, {k: jnp.asarray(v) for k, v in mu.items()},
        {k: jnp.asarray(v) for k, v in nu.items()}, key, extent, cfg,
        use_screen_size=use_screen_size)
    eps = np.asarray(jax.random.normal(key, (cfg.n_split, capacity, 3)))

    tstate = _carry_stats(jstate)
    before = {k: v.detach().clone() for k, v in tstate.params.items()}
    tnew, tmu, tnu, tstats = densify_and_prune(
        tstate, {k: torch.from_numpy(v) for k, v in mu.items()},
        {k: torch.from_numpy(v) for k, v in nu.items()}, None, extent, DensifyConfig(),
        use_screen_size=use_screen_size, eps=torch.from_numpy(eps.copy()))

    for name in STAT_NAMES:
        assert int(getattr(tstats, name)) == int(getattr(jstats, name)), name
    assert int(tstats.num_cloned) > 0 and int(tstats.num_split) > 0
    assert int(tstats.num_pruned_opacity) > 0
    if use_screen_size:
        assert int(tstats.num_pruned_screen) > 0 and int(tstats.num_pruned_world) > 0
    _assert_state_equal(tnew, jnew, xyz_atol=2e-6)
    for k in mu:
        np.testing.assert_array_equal(tmu[k].numpy(), np.asarray(jmu[k]), err_msg=k)
        np.testing.assert_array_equal(tnu[k].numpy(), np.asarray(jnu[k]), err_msg=k)
    # the input state is untouched (every write goes to fresh tensors)
    for k, v in tstate.params.items():
        assert torch.equal(v, before[k])

    if capacity - n < 100:
        assert int(tstats.num_dropped) > 0
        # every free slot is filled, and no rank wrapped onto a surviving
        # gaussian: the rows written are at most the slots that were free
        assert int(tnew.num_active) == capacity
        # a split original leaves its slot even when its children are
        # pruned (then num_split does not count it)
        denom, accum = np.asarray(jstate.denom), np.asarray(jstate.xyz_grad_accum)
        grads = np.where(denom > 0, accum / np.maximum(denom, 1), 0.0)
        big = np.exp(np.asarray(jstate.params["scaling"])).max(1) > 0.01 * extent
        split_mask = np.asarray(jstate.active) & (grads >= 2e-4) & big
        survivors = n - int(split_mask.sum()) - int(tstats.num_pruned)
        changed = np.zeros(capacity, bool)
        for k, v in tnew.params.items():
            changed |= (v.numpy() != before[k].numpy()).reshape(capacity, -1).any(1)
        assert 0 < changed.sum() <= capacity - survivors
    else:
        assert int(tstats.num_dropped) == 0


@pytest.mark.parametrize("use_screen_size", [False, True], ids=["world", "screen"])
@pytest.mark.parametrize("seed", [5, 2**31 - 1])
def test_densify_draws_gsjax_split_noise(seed, use_screen_size):
    """No noise injected: the port draws the split noise from the same key
    (``utils.prng``) as gsjax's ``jax.random.normal(key, (n_split, C, 3))``,
    so the children sit where gsjax's do, within the injected test's
    tolerance; the draw itself is gsjax's bit for bit."""
    from gsjax.models.densify import DensifyConfig as JCfg
    from gsjax.models.densify import densify_and_prune as j_densify
    from gsjax_torch.models.densify import DensifyConfig, densify_and_prune

    extent, n, capacity = 8.0, 300, 1024
    jstate = _dense_state(n, capacity, seed=11)
    mu, nu = _moments(jstate, 12)
    cfg = JCfg()
    jnew, _, _, jstats = j_densify(
        jstate, {k: jnp.asarray(v) for k, v in mu.items()},
        {k: jnp.asarray(v) for k, v in nu.items()}, jax.random.PRNGKey(seed), extent, cfg,
        use_screen_size=use_screen_size)
    key = prng.PRNGKey(seed)
    tnew, _, _, tstats = densify_and_prune(
        _carry_stats(jstate), {k: torch.from_numpy(v) for k, v in mu.items()},
        {k: torch.from_numpy(v) for k, v in nu.items()}, key, extent, DensifyConfig(),
        use_screen_size=use_screen_size)

    shape = (cfg.n_split, capacity, 3)
    np.testing.assert_array_equal(
        prng.normal(key, shape, "cpu").numpy().view(np.uint32),
        np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape)).view(np.uint32))
    for name in STAT_NAMES:
        assert int(getattr(tstats, name)) == int(getattr(jstats, name)), name
    assert int(tstats.num_split) > 0
    _assert_state_equal(tnew, jnew, xyz_atol=2e-6)


def test_reset_opacity_matches_gsjax():
    from gsjax.models.densify import reset_opacity as j_reset
    from gsjax_torch.models.densify import reset_opacity

    jstate = _dense_state(200, 256, seed=6)
    mu, nu = _moments(jstate, 7)
    js, jmu, jnu = j_reset(jstate, {k: jnp.asarray(v) for k, v in mu.items()},
                           {k: jnp.asarray(v) for k, v in nu.items()})
    ts, tmu, tnu = reset_opacity(_carry_stats(jstate),
                                 {k: torch.from_numpy(v) for k, v in mu.items()},
                                 {k: torch.from_numpy(v) for k, v in nu.items()})
    # sigmoid, min and logit in float32: one ulp of exp and log each
    np.testing.assert_allclose(ts.params["opacity"].numpy(), np.asarray(js.params["opacity"]),
                               rtol=1e-6, atol=1e-6)
    assert float(torch.sigmoid(ts.params["opacity"][:200]).max()) <= 0.01 + 1e-7
    for k in mu:
        np.testing.assert_array_equal(tmu[k].numpy(), np.asarray(jmu[k]), err_msg=k)
        np.testing.assert_array_equal(tnu[k].numpy(), np.asarray(jnu[k]), err_msg=k)
    for k, v in jstate.params.items():
        if k != "opacity":
            np.testing.assert_array_equal(ts.params[k].numpy(), np.asarray(v))


def test_densify_step_edits_the_bound_optimizer_like_gsjax():
    """make_densify_step on a clone-only state (no split, so no noise): the
    parameters are written in place into the tensors the optimizer holds,
    the moments equal gsjax's (zero at every written slot), the counts stay,
    and a train step runs on after it."""
    from gsjax.train.optim import make_optimizer as j_make_opt
    from gsjax.train.optim import with_adam_moments as j_with
    from gsjax.train.step import TrainConfig as JCfg
    from gsjax.train.step import make_densify_step as j_make
    from gsjax_torch.train.optim import adam_count, adam_moments, make_optimizer
    from gsjax_torch.train.optim import opt_state_from_numpy
    from gsjax_torch.train.step import TrainConfig, make_densify_step

    extent = 8.0
    jstate = _dense_state(200, 512, seed=8, split_frac=0.0, world_frac=0.0)
    mu, nu = _moments(jstate, 9)
    jtx = j_make_opt(JOpt(), 1.0)
    jopt = j_with(jtx.init(jstate.params), {k: jnp.asarray(v) for k, v in mu.items()},
                  {k: jnp.asarray(v) for k, v in nu.items()})
    jd, jr = j_make(JOpt(), JCfg(extent=extent))
    js, jopt, jstats = jd(jstate, jopt, jax.random.PRNGKey(0), use_screen_size=True)
    js, jopt = jr(js, jopt)

    tstate = _carry_stats(jstate)
    opt = opt_state_from_numpy(mu, nu, 7, make_optimizer(TOpt(), 1.0).init(tstate.params))
    bound = {k: opt.param(k) for k in tstate.params}
    td, tr = make_densify_step(TOpt(), TrainConfig(extent=extent))
    ts, opt, tstats = td(tstate, opt, prng.PRNGKey(0), True)
    ts, opt = tr(ts, opt)

    assert int(tstats.num_cloned) > 0 and int(tstats.num_split) == int(jstats.num_split) == 0
    for name in STAT_NAMES:
        assert int(getattr(tstats, name)) == int(getattr(jstats, name)), name
    assert all(ts.params[k] is bound[k] for k in bound)
    assert opt.count == 7 and adam_count(opt) == 7
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    tmu, tnu = adam_moments(opt)
    jmu, jnu = jopt[0].mu, jopt[0].nu
    for k, v in js.params.items():
        np.testing.assert_allclose(ts.params[k].detach().numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(tmu[k].numpy(), np.asarray(jmu[k]), err_msg=k)
        np.testing.assert_array_equal(tnu[k].numpy(), np.asarray(jnu[k]), err_msg=k)

    # the optimizer still steps the state's tensors
    for v in ts.params.values():
        v.grad = torch.full_like(v, 1e-3)
    opt.step()
    assert opt.count == 8 and adam_count(opt) == 8
    moved = ts.params["xyz"].detach() != torch.from_numpy(np.array(js.params["xyz"]))
    assert bool(moved.all()) and bool(torch.isfinite(ts.params["xyz"]).all())


def test_stack_images_applies_alpha_masks_like_gsjax():
    from gsjax.data.cameras import Camera as JCamera
    from gsjax.train.step import stack_images as j_stack
    from gsjax_torch.data.cameras import Camera as TCamera
    from gsjax_torch.train.step import stack_images

    rng = np.random.default_rng(10)
    jc, tc = [], []
    for i in range(3):
        img = rng.uniform(0, 1, (12, 16, 3)).astype(np.float32)
        mask = rng.uniform(0, 1, (12, 16)).astype(np.float32) if i != 1 else None
        kw = dict(uid=i, image_name=f"v{i}", R=np.eye(3), T=np.zeros(3), fov_x=0.9,
                  fov_y=0.7, width=16, height=12, image=img, alpha_mask=mask)
        jc.append(JCamera(**kw))
        tc.append(TCamera(**kw))
    for dtype in (np.uint8, np.float32):
        got, want = stack_images(tc, dtype), j_stack(jc, dtype)
        assert got.dtype == want.dtype and got.shape == (3, 12, 16, 3)
        np.testing.assert_array_equal(got, want)
