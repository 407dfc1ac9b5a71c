"""gsjax_torch.parallel.multi_scene against gsjax's on the CPU, and the
multi-scene CLI.

One launch of two gloo ranks (``parallel.multihost.spawn_ranks``), one
scene each — tests/test_parallel.py:307-372's pair: its scene, and the
same with the gaussians moved by 0.05 and the images dimmed. Each rank
writes its scene's results; gsjax's ``make_multi_scene_train_step`` steps
both scenes in this process on two virtual CPU devices. Then
``python -m gsjax_torch.train_multiscene --device cpu`` trains the fixture
scene under two model paths on two ranks.

Run as a script, this file is one rank:
``python tests/test_torch_multiscene.py WORKDIR``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 64
SETTINGS = dict(max_pairs=1 << 14, max_splats_per_tile=256)
EXTENT = 2.0
TIMEOUT_S = 300
PARAM_TOL = dict(atol=2e-5, rtol=1e-3)  # tests/test_parallel.py:76-96
PARAM_KEYS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


def _rank_main(workdir):
    torch.set_num_threads(1)
    from gsjax_torch.configs import OptimizationParams
    from gsjax_torch.data.cameras import Camera, stack_render_cameras
    from gsjax_torch.models.gaussians import state_from_numpy
    from gsjax_torch.ops import RasterizeSettings
    from gsjax_torch.parallel.multi_scene import (
        local_scene_ids,
        local_scene_state,
        make_multi_scene_densify_step,
        make_multi_scene_train_step,
        make_multi_scene_train_step_chained,
        make_scene_mesh,
        scene_values,
        stack_scene_states,
        unstack_scene_state,
    )
    from gsjax_torch.parallel.multihost import maybe_initialize
    from gsjax_torch.train.optim import make_optimizer
    from gsjax_torch.train.step import TrainConfig, make_densify_step, make_train_step
    from test_torch_parallel import state_from

    maybe_initialize(device="cpu")
    mesh = make_scene_mesh(2)
    (sid,) = local_scene_ids(mesh, 2)
    z = np.load(os.path.join(workdir, "inputs.npz"))
    state = state_from_numpy({k: z[f"p{sid}_{k}"] for k in PARAM_KEYS}, z["active"],
                             int(z["sh_degree"]), max_sh_degree=3, spatial_lr_scale=EXTENT,
                             device="cpu")
    cams = stack_render_cameras(
        [Camera(uid=i, image_name=f"c{i}", R=z["R"][i], T=z["T"][i], fov_x=float(z["fov"][i, 0]),
                fov_y=float(z["fov"][i, 1]), width=W, height=H) for i in range(len(z["R"]))],
        "cpu")
    images = z[f"images{sid}"]
    cfg = TrainConfig(settings=RasterizeSettings(**SETTINGS), extent=EXTENT)
    opt = OptimizationParams(percent_dense=1.0)  # clone-only: no split noise
    tx = make_optimizer(opt, EXTENT)
    out = {}

    # one multi-scene step (camera 1 for both scenes) against the scene alone
    st = state_from(state)
    st, o, m = make_multi_scene_train_step(tx, cams, images, cfg, mesh)(
        st, tx.init(st.params), np.array([1, 1]))
    alone = state_from(state)
    alone, _, m1 = make_train_step(tx, cams, images, cfg)(alone, tx.init(alone.params), 1)
    st = local_scene_state(st, sid, mesh, 2)
    # gsjax's stacked form and back
    back = unstack_scene_state(stack_scene_states([alone, st]), 1)
    out["stack_roundtrip"] = all(torch.equal(back.params[k], st.params[k].detach())
                                 for k in PARAM_KEYS) and torch.equal(back.active, st.active)
    out.update({f"p_{k}": v.detach().numpy() for k, v in st.params.items()})
    out.update({f"alone_p_{k}": v.detach().numpy() for k, v in alone.params.items()})
    out.update(loss=float(m["loss"]), alone_loss=float(m1["loss"]),
               losses=scene_values(m["loss"], mesh))

    # the densify step of this scene against make_densify_step on a copy
    gen = torch.Generator().manual_seed(5)
    d_st, d_o, stats = make_multi_scene_densify_step(opt, cfg, mesh)[0](
        state_from(st), tx.init(state_from(st).params), [gen, gen], False)
    ref = state_from(st)
    r_st, _, r_stats = make_densify_step(opt, cfg)[0](ref, tx.init(ref.params),
                                                      torch.Generator().manual_seed(5), False)
    out.update(d_active=d_st.active.numpy(), ref_active=r_st.active.numpy(),
               d_xyz=d_st.params["xyz"].detach().numpy(),
               ref_xyz=r_st.params["xyz"].detach().numpy(),
               d_cloned=int(stats.num_cloned), ref_cloned=int(r_stats.num_cloned))

    # three chained steps against three single steps
    idxs = np.array([[0, 2, 3], [1, 1, 0]])
    ch = state_from(state)
    ch, _, cm = make_multi_scene_train_step_chained(tx, cams, images, cfg, mesh, 3)(
        ch, tx.init(ch.params), idxs)
    seq = state_from(state)
    so = tx.init(seq.params)
    step = make_train_step(tx, cams, images, cfg)
    seq_losses = []
    for c in idxs[sid]:
        seq, so, sm = step(seq, so, int(c))
        seq_losses.append(float(sm["loss"]))
    out.update(chain_loss_mean=float(cm["loss_mean"]), seq_losses=np.asarray(seq_losses),
               chain_xyz=ch.params["xyz"].detach().numpy(),
               seq_xyz=seq.params["xyz"].detach().numpy())
    np.savez(os.path.join(workdir, f"out_{sid}.npz"), **out)
    torch.distributed.barrier()


@pytest.fixture(scope="module")
def scenes():
    """tests/test_parallel.py:307-372's two scenes (gsjax states)."""
    import dataclasses

    from test_torch_parallel import gsjax_scene

    state, cams, images = gsjax_scene()
    p2 = dict(state.params)
    p2["xyz"] = p2["xyz"] + 0.05
    state2 = dataclasses.replace(state, params=p2)
    images2 = np.clip(images.astype(np.float32) * 0.7, 0, 255).astype(images.dtype)
    return [state, state2], cams, [images, images2]


@pytest.fixture(scope="module")
def ranks(scenes, tmp_path_factory):
    from gsjax_torch.parallel.multihost import spawn_ranks

    states, cams, images = scenes
    workdir = str(tmp_path_factory.mktemp("scenes"))
    arrays = {f"p{i}_{k}": np.asarray(v) for i, s in enumerate(states)
              for k, v in s.params.items()}
    np.savez(os.path.join(workdir, "inputs.npz"), **arrays,
             active=np.asarray(states[0].active), sh_degree=int(states[0].active_sh_degree),
             R=np.stack([c.R for c in cams]), T=np.stack([c.T for c in cams]),
             fov=np.asarray([[c.fov_x, c.fov_y] for c in cams]),
             images0=images[0], images1=images[1])
    spawn_ranks([sys.executable, os.path.abspath(__file__), workdir], 2, TIMEOUT_S,
                env={"PYTHONPATH": os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])},
                cwd=ROOT, threads=1)
    return [dict(np.load(os.path.join(workdir, f"out_{i}.npz"))) for i in range(2)]


def test_multi_scene_step_matches_gsjax(scenes, ranks):
    import jax
    import jax.numpy as jnp

    from gsjax.configs import OptimizationParams
    from gsjax.data.cameras import stack_render_cameras
    from gsjax.ops.rasterize import RasterizeSettings
    from gsjax.parallel.multi_scene import (
        make_multi_scene_train_step,
        make_scene_mesh,
        stack_scene_states,
        unstack_scene_state,
    )
    from gsjax.train.optim import make_optimizer
    from gsjax.train.step import TrainConfig

    states, cams, images = scenes
    cfg = TrainConfig(settings=RasterizeSettings(**SETTINGS), extent=EXTENT)
    tx = make_optimizer(OptimizationParams(), EXTENT)
    batch = stack_render_cameras(cams)
    step = make_multi_scene_train_step(
        tx, jax.tree.map(lambda x: jnp.stack([x, x]), batch), np.stack(images), cfg,
        make_scene_mesh(2, devices=jax.devices()[:2]))
    opt_states = jax.tree.map(lambda *xs: jnp.stack(xs), *[tx.init(s.params) for s in states])
    new, _, metrics = step(stack_scene_states(states), opt_states,
                           jnp.array([1, 1], jnp.int32), jnp.stack([jax.random.PRNGKey(7)] * 2))
    for i, got in enumerate(ranks):
        assert got["loss"] == pytest.approx(float(metrics["loss"][i]), rel=1e-5)
        want = unstack_scene_state(new, i)
        for k in PARAM_KEYS:
            np.testing.assert_allclose(got[f"p_{k}"], np.asarray(want.params[k]), err_msg=k,
                                       **PARAM_TOL)


def test_multi_scene_step_matches_each_scene_alone(ranks):
    """gsjax's own test's check (tests/test_parallel.py:365-372), the port
    against itself: the same arithmetic, bit for bit."""
    for got in ranks:
        assert got["loss"] == got["alone_loss"]
        for k in PARAM_KEYS:
            np.testing.assert_array_equal(got[f"p_{k}"], got[f"alone_p_{k}"], err_msg=k)
    # every rank logs both scenes' losses, in scene order
    for got in ranks:
        np.testing.assert_array_equal(got["losses"], [ranks[0]["loss"], ranks[1]["loss"]])


def test_multi_scene_densify_step_matches_make_densify_step(ranks):
    assert any(got["d_cloned"] > 0 for got in ranks)
    for got in ranks:
        assert got["stack_roundtrip"]
        assert got["d_cloned"] == got["ref_cloned"]
        np.testing.assert_array_equal(got["d_active"], got["ref_active"])
        np.testing.assert_array_equal(got["d_xyz"], got["ref_xyz"])


def test_multi_scene_chained_step_matches_sequential(ranks):
    for got in ranks:
        assert got["chain_loss_mean"] == pytest.approx(float(got["seq_losses"].mean()), rel=1e-6)
        np.testing.assert_array_equal(got["chain_xyz"], got["seq_xyz"])


def test_train_multiscene_cli(tmp_path):
    """Two ranks, the fixture scene under two model paths: both exit 0 with
    finite losses, each writes only its scene, and the two snapshots are
    equal bit for bit (each scene draws from its own generator)."""
    from fixtures import make_blender_scene
    from gsjax_torch.parallel.multihost import spawn_ranks

    scene = str(tmp_path / "scene")
    make_blender_scene(scene, n_train=6, n_test=2, width=48, height=48)
    models = [str(tmp_path / f"m{i}") for i in range(2)]
    res = spawn_ranks([sys.executable, "-m", "gsjax_torch.train_multiscene", "-s", scene, scene,
                       "-m", *models, "--device", "cpu", "--iterations", "6",
                       "--steps_per_dispatch", "3", "--capacity", "64"],
                      2, TIMEOUT_S, cwd=ROOT, threads=1)
    done = [json.loads(r.stdout.strip().splitlines()[-1]) for r in res]
    assert [d["scene"] for d in done] == [0, 1]
    assert all(np.isfinite(d["losses"]).all() and len(d["losses"]) == 2 for d in done)
    plys = [os.path.join(m, "point_cloud", "iteration_6", "point_cloud.ply") for m in models]
    with open(plys[0], "rb") as a, open(plys[1], "rb") as b:
        assert a.read() == b.read()
    assert all(os.path.exists(os.path.join(m, "cameras.json")) for m in models)


if __name__ == "__main__":
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    _rank_main(sys.argv[1])
