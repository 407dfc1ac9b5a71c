"""gsjax_torch.parallel against gsjax.parallel on the CPU.

The port runs one process per rank: each launch starts gloo ranks on the
CPU (``parallel.multihost.spawn_ranks``, one intra-op thread each, a
timeout that kills them all) which run every case of one mesh and write
rank 0's results to an npz; gsjax runs its sharded functions in this
process on the conftest's virtual CPU devices, on the same meshes and the
same inputs (the 300-gaussian, 64x64, 4-camera scene of
tests/test_parallel.py, written to the ranks as numpy). Two launches: mesh
(1, 2) and mesh (2, 2). Tolerances: gsjax's own for sharded against
single-device (tests/test_parallel.py:55, :76-96); the port's image
against gsjax's, the scan's two tiers (tests/test_torch_render.py).

Run as a script, this file is one rank:
``python tests/test_torch_parallel.py WORKDIR DATA GAUSS``.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 64
SETTINGS = dict(max_pairs=1 << 16, max_splats_per_tile=512)
TIMEOUT_S = 300
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=2e-5, rtol=1e-3)
ACCUM_TOL = dict(atol=1e-4, rtol=1e-3)
PARAM_KEYS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


# --------------------------------------------------------------------------
# one rank
# --------------------------------------------------------------------------


def _port_inputs(workdir):
    from gsjax_torch.data.cameras import Camera
    from gsjax_torch.models.gaussians import state_from_numpy

    z = np.load(os.path.join(workdir, "inputs.npz"))
    state = state_from_numpy({k: z[f"p_{k}"] for k in PARAM_KEYS}, z["active"],
                             int(z["sh_degree"]),
                             max_sh_degree=3, spatial_lr_scale=float(z["lr_scale"]),
                             device="cpu")
    cams = [Camera(uid=i, image_name=f"c{i}", R=z["R"][i], T=z["T"][i], fov_x=float(z["fov"][i, 0]),
                   fov_y=float(z["fov"][i, 1]), width=W, height=H) for i in range(len(z["R"]))]
    return state, cams, z["images"]


def _whole(state):
    out = {f"p_{k}": v.detach().numpy() for k, v in state.params.items()}
    out.update(accum=state.xyz_grad_accum.numpy(), denom=state.denom.numpy(),
               radii=state.max_radii2d.numpy())
    return out


def _comm_cases(mesh):
    """Each differentiable collective on a case with a known gradient."""
    from gsjax_torch.parallel import comm

    r, G, grp = mesh.g, mesh.gauss, mesh.gauss_group
    out = {}
    # all_gather: every rank's loss sum_i (i + 1) g_i; the summed loss's
    # gradient on rank r is G (r + 1)
    x = torch.ones(1, requires_grad=True)
    (torch.arange(1, G + 1, dtype=torch.float32) * comm.all_gather(x, grp)).sum().backward()
    out["ag_grad"] = x.grad.numpy()
    # all_to_all: rank r weighs what it receives by r + 1, so the gradient
    # of the block rank r sent to rank j is j + 1
    x = torch.zeros(2 * G, requires_grad=True)
    y = comm.all_to_all(x + r, grp)
    ((r + 1) * y).sum().backward()
    out["a2a_fwd"] = y.detach().numpy()
    out["a2a_grad"] = x.grad.numpy()
    # halo rows: rank r weighs its extended rows by r + 1
    x = (torch.arange(6, dtype=torch.float32) + 10 * r)[:, None].requires_grad_(True)
    y = comm.halo_rows(x, 2, grp)
    ((r + 1) * y).sum().backward()
    out["halo_fwd"] = y.detach().numpy()[:, 0]
    out["halo_grad"] = x.grad.numpy()[:, 0]
    return {f"{k}_{r}": v for k, v in out.items()}


def _rank_main(workdir, data, gauss):
    torch.set_num_threads(1)
    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.data.cameras import stack_render_cameras
    from gsjax_torch.ops import RasterizeSettings
    from gsjax_torch.parallel import make_mesh, make_sharded_render, make_sharded_train_step
    from gsjax_torch.parallel.comm import gather_rows
    from gsjax_torch.parallel.multihost import maybe_initialize
    from gsjax_torch.parallel.shard import (
        _ssim_partial_sum,
        gather_gaussian_state,
        make_sharded_train_step_chained,
        shard_gaussian_state,
    )
    from gsjax_torch.train.optim import make_optimizer
    from gsjax_torch.train.step import TrainConfig, make_render_fn, make_train_step
    from gsjax_torch.utils import prng

    maybe_initialize(device="cpu")
    mesh = make_mesh(data=data, gauss=gauss, device="cpu")
    state, cams, images = _port_inputs(workdir)
    rcams = stack_render_cameras(cams, "cpu")
    settings = RasterizeSettings(**SETTINGS)
    cfg = TrainConfig(settings=settings, extent=2.0)
    tx = make_optimizer(OptimizationParams(), state.spatial_lr_scale)
    out = {}

    def fresh():
        local = shard_gaussian_state(state, mesh)
        return local, tx.init(local.params)

    img, _ = make_sharded_render(mesh, settings, W, H)(fresh()[0], rcams[1], torch.zeros(3))
    out["render"] = img.numpy()
    out["render_single"] = make_render_fn(cfg)(state, rcams[1], torch.zeros(3)).numpy()

    def stepped(cfg_, cam_idx, key=None):
        local, opt = fresh()
        local, opt, m = make_sharded_train_step(tx, mesh, rcams, images, cfg_)(
            local, opt, cam_idx, key)
        return gather_gaussian_state(local, mesh), m

    cam_idx = [2] if data == 1 else [0, 3]
    whole, m = stepped(cfg, cam_idx)
    out.update({f"step_{k}": v for k, v in _whole(whole).items()})
    out.update(step_loss=float(m["loss"]), step_l1=float(m["l1"]))
    single_losses = []
    for c in cam_idx:
        st = state_from(state)
        _, _, m1 = make_train_step(tx, rcams, images, cfg)(st, tx.init(st.params), c)
        single_losses.append(float(m1["loss"]))
    out["single_losses"] = np.asarray(single_losses)

    if data == 1:
        a2a = dataclasses.replace(cfg, settings=dataclasses.replace(
            settings, splat_exchange="a2a"))
        whole, m = stepped(a2a, cam_idx)
        out.update({f"a2a_{k}": v for k, v in _whole(whole).items()})
        out.update(a2a_loss=float(m["loss"]), a2a_dropped=int(m["num_exchange_dropped"]))
        tiny = dataclasses.replace(cfg, settings=dataclasses.replace(
            settings, splat_exchange="a2a", a2a_rows=32))
        _, m = stepped(tiny, cam_idx)
        out.update(tiny_dropped=int(m["num_exchange_dropped"]), tiny_loss=float(m["loss"]))
        # the SSIM of a 60-row image in 32-row strips (the last strip's
        # rows past 60 masked), summed over the ranks
        rng = np.random.default_rng(3)
        a = torch.from_numpy(rng.uniform(0, 1, (2 * 32, W, 3)).astype(np.float32))
        b = torch.from_numpy(np.clip(a.numpy() + rng.normal(0, 0.1, a.shape), 0, 1)
                             .astype(np.float32))
        rows = slice(32 * mesh.g, 32 * (mesh.g + 1))
        valid = (torch.arange(32 * mesh.g, 32 * (mesh.g + 1)) < 60).to(torch.float32)
        part = _ssim_partial_sum(a[rows], b[rows], valid, mesh)
        out["ssim_parts"] = gather_rows(part.reshape(1), mesh.gauss_group).numpy()
        out["ssim_a"], out["ssim_b"] = a.numpy()[:60], b.numpy()[:60]
        # one data row per rank, both on one camera: the mean of two equal
        # gradients is the single-device step's gradient, so the step
        # equals make_train_step's bit for bit (the strip loss must
        # differentiate the graph of train.loss)
        dmesh = make_mesh(data=mesh.world, gauss=1, device="cpu")
        local = shard_gaussian_state(state, dmesh)
        local, _, _ = make_sharded_train_step(tx, dmesh, rcams, images, cfg)(
            local, tx.init(local.params), [2] * mesh.world)
        st = state_from(state)
        st, _, _ = make_train_step(tx, rcams, images, cfg)(st, tx.init(st.params), 2)
        for k in PARAM_KEYS:
            out[f"same_cam_p_{k}"] = local.params[k].detach().numpy()
            out[f"single_p_{k}"] = st.params[k].detach().numpy()
        gathered = [None] * mesh.world
        torch.distributed.all_gather_object(gathered, _comm_cases(mesh))
        for d in gathered:
            out.update(d)
    else:
        # n chained steps against n single sharded steps
        idxs = [[0, 1], [2, 3], [1, 0]]
        local, opt = fresh()
        step = make_sharded_train_step(tx, mesh, rcams, images, cfg)
        losses = []
        for ci in idxs:
            local, opt, m = step(local, opt, ci)
            losses.append(float(m["loss"]))
        seq = gather_gaussian_state(local, mesh)
        local, opt = fresh()
        local, opt, m = make_sharded_train_step_chained(tx, mesh, rcams, images, cfg, 3)(
            local, opt, idxs)
        ch = gather_gaussian_state(local, mesh)
        out.update({f"seq_{k}": v for k, v in _whole(seq).items()})
        out.update({f"chain_{k}": v for k, v in _whole(ch).items()})
        out.update(seq_losses=np.asarray(losses), chain_loss_mean=float(m["loss_mean"]))
        # random backgrounds: one step (row d draws from split(key, 2)[d]),
        # and the chained steps against single steps on fold_in(key, i)
        rb = dataclasses.replace(cfg, random_background=True)
        whole, m = stepped(rb, [0, 3], prng.PRNGKey(9))
        out.update({f"rb_{k}": v for k, v in _whole(whole).items()})
        out.update(rb_loss=float(m["loss"]), rb_l1=float(m["l1"]))
        local, opt = fresh()
        step = make_sharded_train_step(tx, mesh, rcams, images, rb)
        for i, ci in enumerate(idxs):
            local, opt, _ = step(local, opt, ci, prng.fold_in(prng.PRNGKey(9), i))
        out.update({f"rb_seq_{k}": v for k, v in _whole(gather_gaussian_state(local, mesh)).items()})
        local, opt = fresh()
        local, opt, _ = make_sharded_train_step_chained(tx, mesh, rcams, images, rb, 3)(
            local, opt, idxs, prng.PRNGKey(9))
        out.update({f"rb_chain_{k}": v
                    for k, v in _whole(gather_gaussian_state(local, mesh)).items()})
    if mesh.rank == 0:
        np.savez(os.path.join(workdir, f"out_{data}x{gauss}.npz"), **out)
    torch.distributed.barrier()


def state_from(state):
    """A fresh copy of a whole state (own tensors)."""
    return dataclasses.replace(
        state, params={k: v.detach().clone() for k, v in state.params.items()},
        active=state.active.clone(), max_radii2d=state.max_radii2d.clone(),
        xyz_grad_accum=state.xyz_grad_accum.clone(), denom=state.denom.clone())


# --------------------------------------------------------------------------
# gsjax's side, and the launches
# --------------------------------------------------------------------------


def gsjax_scene():
    """tests/test_parallel.py's scene: gsjax state, cameras, images."""
    from gsjax.models import create_from_pcd

    from conftest import make_test_camera

    rng = np.random.default_rng(0)
    n = 300
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 8, n)], axis=1)
    cols = rng.uniform(0, 1, (n, 3))
    state = create_from_pcd(pts, cols, spatial_lr_scale=2.0, capacity=512)
    cams = [make_test_camera(W, H, seed=i) for i in range(4)]
    images = np.random.default_rng(1).uniform(0, 1, (4, H, W, 3)).astype(np.float32)
    return state, cams, images


@pytest.fixture(scope="module")
def scene():
    return gsjax_scene()


@pytest.fixture(scope="module")
def ranks(scene, tmp_path_factory):
    """Both launches' results, keyed by mesh shape."""
    from gsjax_torch.parallel.multihost import spawn_ranks

    state, cams, images = scene
    workdir = str(tmp_path_factory.mktemp("ranks"))
    np.savez(os.path.join(workdir, "inputs.npz"),
             **{f"p_{k}": np.asarray(v) for k, v in state.params.items()},
             active=np.asarray(state.active), lr_scale=state.spatial_lr_scale,
             sh_degree=int(state.active_sh_degree),
             R=np.stack([c.R for c in cams]), T=np.stack([c.T for c in cams]),
             fov=np.asarray([[c.fov_x, c.fov_y] for c in cams]), images=images)
    env = {"PYTHONPATH": ROOT}
    out = {}
    for data, gauss in ((1, 2), (2, 2)):
        spawn_ranks([sys.executable, os.path.abspath(__file__), workdir, str(data), str(gauss)],
                    data * gauss, TIMEOUT_S, env=env, cwd=ROOT, threads=1)
        out[(data, gauss)] = dict(np.load(os.path.join(workdir, f"out_{data}x{gauss}.npz")))
    return out


def _j_mesh(shape):
    import jax

    from gsjax.parallel import make_mesh

    d, g = shape
    return make_mesh(data=d, gauss=g, devices=jax.devices()[: d * g])


def _j_step(scene, shape, cam_idx, random_background=False, **settings):
    import jax
    import jax.numpy as jnp

    from gsjax.configs import OptimizationParams
    from gsjax.data.cameras import stack_render_cameras
    from gsjax.ops.rasterize import RasterizeSettings
    from gsjax.parallel import make_sharded_train_step, shard_gaussian_state
    from gsjax.train.optim import make_optimizer
    from gsjax.train.step import TrainConfig

    state, cams, images = scene
    mesh = _j_mesh(shape)
    tx = make_optimizer(OptimizationParams(), state.spatial_lr_scale)
    cfg = TrainConfig(settings=RasterizeSettings(**{**SETTINGS, **settings}), extent=2.0,
                      random_background=random_background)
    sstate = shard_gaussian_state(state, mesh)
    step = make_sharded_train_step(tx, mesh, stack_render_cameras(cams), images, cfg)
    s, _, m = step(sstate, tx.init(sstate.params), jnp.asarray(cam_idx), jax.random.PRNGKey(9))
    return s, m


def _assert_state(got, prefix, want):
    """A stepped state against gsjax's: tests/test_parallel.py:76-96."""
    for k in PARAM_KEYS:
        np.testing.assert_allclose(got[f"{prefix}_p_{k}"], np.asarray(want.params[k]),
                                   err_msg=k, **PARAM_TOL)
    np.testing.assert_allclose(got[f"{prefix}_accum"], np.asarray(want.xyz_grad_accum),
                               **ACCUM_TOL)
    np.testing.assert_array_equal(got[f"{prefix}_denom"], np.asarray(want.denom))
    np.testing.assert_array_equal(got[f"{prefix}_radii"], np.asarray(want.max_radii2d))


MESHES = [(1, 2), (2, 2)]


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2"])
def test_sharded_render_matches_gsjax(scene, ranks, shape):
    import jax.numpy as jnp

    from gsjax.ops.rasterize import RasterizeSettings
    from gsjax.parallel import make_sharded_render, shard_gaussian_state
    from test_torch_render import assert_two_tier

    state, cams, _ = scene
    mesh = _j_mesh(shape)
    want, _ = make_sharded_render(mesh, RasterizeSettings(**SETTINGS), W, H)(
        shard_gaussian_state(state, mesh), cams[1].to_render_camera(), jnp.zeros(3))
    assert ranks[shape]["render"].shape == (H, W, 3)
    assert_two_tier(ranks[shape]["render"], np.asarray(want), f"render {shape}")


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2"])
def test_sharded_render_matches_single_device(ranks, shape):
    """tests/test_parallel.py:55's bound, the port against itself."""
    np.testing.assert_allclose(ranks[shape]["render"], ranks[shape]["render_single"], atol=3e-5)


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x2"])
def test_sharded_train_step_matches_gsjax(scene, ranks, shape):
    got = ranks[shape]
    cam_idx = [2] if shape[0] == 1 else [0, 3]
    s, m = _j_step(scene, shape, cam_idx)
    assert got["step_loss"] == pytest.approx(float(m["loss"]), rel=LOSS_RTOL)
    assert got["step_l1"] == pytest.approx(float(m["l1"]), rel=LOSS_RTOL)
    _assert_state(got, "step", s)


def test_random_background_rows_match_gsjax(scene, ranks):
    """Each data row draws its background from gsjax's key,
    ``uniform(split(key, data)[d], (3,))``: the stepped state equals
    gsjax's within the step's tolerances, and the loss is not the black
    background's."""
    got = ranks[(2, 2)]
    s, m = _j_step(scene, (2, 2), [0, 3], random_background=True)
    assert got["rb_loss"] == pytest.approx(float(m["loss"]), rel=LOSS_RTOL)
    assert got["rb_l1"] == pytest.approx(float(m["l1"]), rel=LOSS_RTOL)
    assert abs(got["rb_loss"] - got["step_loss"]) > 1e-3
    _assert_state(got, "rb", s)


def test_random_background_chained_steps_fold_the_key(ranks):
    """The chained sharded step's step i takes ``fold_in(key, i)``, as
    gsjax's scan: it equals single steps on those keys."""
    got = ranks[(2, 2)]
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(got[f"rb_chain_p_{k}"], got[f"rb_seq_p_{k}"], err_msg=k)
    np.testing.assert_array_equal(got["rb_chain_denom"], got["rb_seq_denom"])
    # and the keys mattered: the steps on other keys land elsewhere
    assert not np.array_equal(got["rb_chain_p_features_dc"], got["seq_p_features_dc"])


def test_data_parallel_loss_is_the_mean_of_the_cameras(ranks):
    """tests/test_parallel.py:284-301: two cameras on two data rows."""
    got = ranks[(2, 2)]
    assert got["step_loss"] == pytest.approx(float(np.mean(got["single_losses"])),
                                             rel=LOSS_RTOL)
    assert ranks[(1, 2)]["step_loss"] == pytest.approx(
        float(ranks[(1, 2)]["single_losses"][0]), rel=LOSS_RTOL)


def test_data_rows_on_one_camera_equal_the_single_step_bit_for_bit(ranks):
    r = ranks[(1, 2)]
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(r[f"same_cam_p_{k}"], r[f"single_p_{k}"], err_msg=k)


def test_a2a_exchange_matches_all_gather(ranks):
    got = ranks[(1, 2)]
    assert got["a2a_dropped"] == 0
    assert got["a2a_loss"] == pytest.approx(float(got["step_loss"]), rel=LOSS_RTOL)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(got[f"a2a_p_{k}"], got[f"step_p_{k}"], err_msg=k,
                                   **PARAM_TOL)
    np.testing.assert_allclose(got["a2a_accum"], got["step_accum"], **ACCUM_TOL)


def test_a2a_overflow_is_counted(ranks):
    """tests/test_parallel.py:255-282: 300 live splats on 2 ranks with a
    send budget of 32 rows per destination."""
    got = ranks[(1, 2)]
    assert got["tiny_dropped"] > 0 and np.isfinite(got["tiny_loss"])


def test_chained_step_matches_sequential(ranks):
    """tests/test_parallel.py:152-191's case, the port against itself."""
    got = ranks[(2, 2)]
    assert got["chain_loss_mean"] == pytest.approx(float(got["seq_losses"].mean()), rel=1e-5)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(got[f"chain_p_{k}"], got[f"seq_p_{k}"], atol=2e-3,
                                   rtol=1e-3, err_msg=k)
    np.testing.assert_array_equal(got["chain_denom"], got["seq_denom"])


def test_ssim_partial_sums_match_gsjax_and_the_whole_image(ranks):
    import jax
    import jax.numpy as jnp
    from jax import lax, shard_map
    from jax.sharding import PartitionSpec as P

    from gsjax.parallel.shard import _ssim_partial_sum
    from gsjax.train.loss import ssim

    got = ranks[(1, 2)]
    a, b = got["ssim_a"], got["ssim_b"]
    port = float(got["ssim_parts"].sum())
    pad = ((0, 4), (0, 0), (0, 0))
    valid = (np.arange(64) < 60).astype(np.float32)
    f = shard_map(lambda x, y, v: lax.psum(_ssim_partial_sum(x, y, v, "gauss"), "gauss"),
                  mesh=_j_mesh((1, 2)), in_specs=(P("gauss"), P("gauss"), P("gauss")),
                  out_specs=P(), check_vma=False)
    want = float(jax.jit(f)(jnp.asarray(np.pad(a, pad)), jnp.asarray(np.pad(b, pad)),
                            jnp.asarray(valid)))
    assert port == pytest.approx(want, rel=1e-5)
    whole = float(ssim(jnp.asarray(a), jnp.asarray(b))) * a.size
    assert port == pytest.approx(whole, rel=1e-5)


def test_comm_all_gather_gradient(ranks):
    got = ranks[(1, 2)]
    for r in range(2):  # the summed loss's gradient: 2 (r + 1)
        np.testing.assert_array_equal(got[f"ag_grad_{r}"], [2.0 * (r + 1)])


def test_comm_all_to_all_gradient(ranks):
    got = ranks[(1, 2)]
    for r in range(2):
        np.testing.assert_array_equal(got[f"a2a_fwd_{r}"], [0, 0, 1, 1])  # block i from rank i
        np.testing.assert_array_equal(got[f"a2a_grad_{r}"], [1, 1, 2, 2])  # sent to rank j: j + 1


def test_comm_halo_rows_gradient(ranks):
    got = ranks[(1, 2)]
    # rank 0: zeros on top, rank 1's first 2 rows below; rank 1: rank 0's
    # last 2 rows on top, zeros below
    np.testing.assert_array_equal(got["halo_fwd_0"], [0, 0, 0, 1, 2, 3, 4, 5, 10, 11])
    np.testing.assert_array_equal(got["halo_fwd_1"], [4, 5, 10, 11, 12, 13, 14, 15, 0, 0])
    # weight r + 1 on rank r's rows; rank 0's last rows also feed rank 1's
    # halo (weight 2), rank 1's first rows rank 0's (weight 1)
    np.testing.assert_array_equal(got["halo_grad_0"], [1, 1, 1, 1, 3, 3])
    np.testing.assert_array_equal(got["halo_grad_1"], [3, 3, 2, 2, 2, 2])


def test_composite_tiles_pixel_origin_matches_gsjax():
    """The scan's pixel grid offset, on a strip of tile rows [2, 4) of a
    64x64 frame, against gsjax's ``composite_tiles(pixel_origin=...)``; the
    default origin leaves the result bit for bit."""
    import jax
    import jax.numpy as jnp

    from conftest import make_test_camera, make_test_gaussians
    from gsjax.ops.composite import composite_tiles as j_tiles
    from gsjax_torch.ops.binning import build_tile_bins
    from gsjax_torch.ops.composite import composite_tiles as t_tiles
    from gsjax_torch.ops.projection import preprocess
    from test_torch_render import assert_two_tier, t_camera

    gs = make_test_gaussians(120, np.random.default_rng(4))
    with torch.no_grad():  # the inputs: the port's splats and bins, as numpy
        sp = preprocess(*map(torch.from_numpy, gs), t_camera(make_test_camera(64, 64)), 3)
        bins = build_tile_bins(sp, 4, 2, 1 << 13)
    args = [a.numpy().copy() for a in (bins.pair_gauss, bins.tile_start, sp.means2d,
                                       sp.conics, sp.colors, sp.opacities)]
    j_fn = jax.jit(lambda origin, *a: j_tiles(*a, 4, 2, 256, 32, pixel_origin=origin))
    for origin in ((0.0, 32.0), (0.0, 0.0)):
        jc, jT, jcap = j_fn(jnp.asarray(origin), *map(jnp.asarray, args))
        tc, tT, tcap = t_tiles(*map(torch.from_numpy, args), 4, 2, 256, 32, pixel_origin=origin)
        assert_two_tier(tc.numpy(), np.asarray(jc), f"colors {origin}")
        assert_two_tier(tT.numpy(), np.asarray(jT), f"T {origin}")
        assert int(tcap) == int(jcap)
    plain = t_tiles(*map(torch.from_numpy, args), 4, 2, 256, 32)
    assert all(torch.equal(a, b) for a, b in zip(plain, (tc, tT, tcap)))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))


@pytest.mark.parametrize("budget", [(1 << 16, 16), (2048, 4)], ids=["roomy", "capped"])
def test_strip_bins_match_gsjax_strip_binning(scene, budget):
    """``shard.bin_strip``, the sharded path's binning of a rank's strip,
    against gsjax's ``_render_strip`` binning (gsjax/parallel/shard.py:
    228-244: the rects clipped to the strip, ``build_tile_bins`` with the
    depth keyed by the strip's own tile count) on the same splats, compact
    expansion, both strips of a 64x64 frame (16 tiles: 27 depth bits; a
    strip of 8: 28). The depths take 7 values, each split in two that tie
    at the frame's 27 bits but not at the strip's 28: the keys (tile_start,
    pair_tile), the pair order, the slots and every drop counter are
    equal, and the frame's key width would order the pairs otherwise."""
    import jax.numpy as jnp

    from gsjax.models.gaussians import activated_params
    from gsjax.ops.binning import build_tile_bins as j_bins
    from gsjax.ops.projection import num_tiles, preprocess
    from gsjax_torch.ops import RasterizeSettings
    from gsjax_torch.ops.binning import build_tile_bins, key_depth_bits
    from gsjax_torch.ops.projection import Splats
    from gsjax_torch.parallel.shard import bin_strip, strip_splats

    from conftest import make_test_camera

    state, _, _ = scene
    max_pairs, mt = budget
    w = h = 64
    tiles_x, tiles_y = num_tiles(w, h)
    gauss, strips_y = 2, 2
    cam = make_test_camera(w, h, seed=1).to_render_camera()
    sp = preprocess(*activated_params(state.params), cam, int(state.active_sh_degree),
                    active_mask=state.active)
    frame_bits = key_depth_bits(tiles_x * tiles_y)
    assert key_depth_bits(tiles_x * strips_y) == frame_bits + 1 == 28
    i = np.arange(sp.depths.shape[0])
    bits = (np.float32(5.0) + (i % 7).astype(np.float32) * np.float32(0.25)).view(np.int32)
    bits = (bits >> (31 - frame_bits) << (31 - frame_bits)) + (i % 2) * (1 << (30 - frame_bits))
    sp = sp._replace(depths=jnp.asarray(bits.astype(np.int32).view(np.float32)))
    ts = Splats(*(torch.from_numpy(np.array(a)) for a in sp))
    settings = RasterizeSettings(max_pairs=max_pairs, expansion="compact",
                                 max_tiles_per_gauss=mt)
    fields = ("pair_gauss", "pair_tile", "pair_slot", "tile_start", "num_pairs", "num_dropped",
              "num_mt_capped", "num_tier_capped", "gauss_count")
    for g in range(gauss):
        y0 = g * strips_y
        got = bin_strip(ts, y0, strips_y, tiles_x, settings, gauss)
        # gsjax's _render_strip, lines 228-244
        rmin_y = jnp.clip(sp.rect_min[:, 1] - y0, 0, strips_y)
        rmax_y = jnp.clip(sp.rect_max[:, 1] - y0, 0, strips_y)
        wx = sp.rect_max[:, 0] - sp.rect_min[:, 0]
        local = sp._replace(
            rect_min=jnp.stack([sp.rect_min[:, 0], rmin_y], axis=1),
            rect_max=jnp.stack([sp.rect_max[:, 0], rmax_y], axis=1),
            tiles_touched=jnp.where(sp.tiles_touched > 0, wx * (rmax_y - rmin_y), 0))
        want = j_bins(local, tiles_x, strips_y, max(max_pairs // gauss, 1024),
                      max_tiles_per_gauss=mt, expansion="compact")
        for f in fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f"strip {g} {f}")
        if mt == 4:
            assert int(got.num_mt_capped) > 0
        framed = build_tile_bins(strip_splats(ts, y0, strips_y), tiles_x, strips_y,
                                 max(max_pairs // gauss, 1024), max_tiles_per_gauss=mt,
                                 expansion="compact", depth_bits=frame_bits)
        assert not torch.equal(framed.pair_gauss, got.pair_gauss)
