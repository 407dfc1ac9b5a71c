"""The preprocess's backward where no card is: ``preprocess_vjp_plain``
(the closed form ``csrc/preprocess_bwd.cu`` computes) against autograd over
``preprocess_plain`` and against gsjax's ``jax.vjp``; ``preprocess_train``'s
autograd.Function wired to it; the route rule; the kernel's C entry. The
kernel against both on the card: ``tests/test_torch_cuda.py``.

    python -m pytest -q -p no:cacheprovider tests/test_torch_preprocess_bwd.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsjax_torch.data.cameras import CAMERA_TENSORS
from gsjax_torch.ops import kernels, projection
from gsjax_torch.utils import profiling

from test_torch_cuda import GRAD_GROUPS as GROUPS
from test_torch_cuda import PREP_CASES, _prep_inputs, assert_grads_close
from test_torch_kernels import assert_replays_count, fake_card  # noqa: F401
from test_torch_preprocess import _c_signature, _C_TYPES

VJP_CASES = ("deg3", "deg0", "deg1", "deg2", "deg3_k9", "deg2_k4", "deg0_k1", "deg1_k5",
             "scale_modifier", "no_mask")
# (slot, group, norm) tolerances of the closed form against autograd: every
# element within slot x its slot's largest |want| in the group plus group x
# the group's largest, and the group's norm of the difference within norm x
# its norm. In float64 both are exact to a few roundings. In float32 each
# sums in its own order, and the two cancel in other places: a quaternion's
# gradient loses its component along q (safe_normalize's backward), and
# autograd's conic step subtracts two terms of adj(C) / det that the closed
# form's -K G K never forms. Slots held at view z 0 have scale and rotation
# gradients near 1e-18 of that rounding only.
TOL = {torch.float64: (1e-9, 1e-14, 1e-12), torch.float32: (5e-3, 1e-6, 1e-4)}


def _double(cam):
    return dataclasses.replace(cam, **{k: getattr(cam, k).double() for k in CAMERA_TENSORS})


def _case(case, n=3000, dtype=torch.float32, seed=11):
    """``_prep_inputs``' inputs (inactive and culled slots, slots behind the
    near plane and beyond the tan-fov clamp), with slots held at view z 0
    (|tz| < 1e-6), opacities and colors at the f16 flush and colors clamped
    at 0, and the incoming
    gradients of (means2d, conics, colors, opacities): seeded normals, the
    colors' and opacities' with values f16 rounds (1.0001237 -> 1.0), and
    all four zero on every fifth slot."""
    args, cam, deg, kw = _prep_inputs(case, "cpu", n=n, seed=seed)
    means, scales, quats, opac, shs = args
    means[:8, 2] = 0.0  # the identity camera: view z 0
    means[8:12, 2] = 5e-7
    opac[12:20] = torch.tensor([3e-5, 6.09e-5, 6.11e-5, 1e-7, 0.5, 0.9, 1e-3, 6.2e-5])
    # colors at 0, flushed (3e-5), kept (6.2e-5, 0.3) and clamped (-1e-3): DC only
    col = torch.tensor([0.0, 3e-5, 6.2e-5, -1e-3, 0.3]).repeat(4)
    shs[20:40] = 0.0
    shs[20:40, 0] = ((col - 0.5) / 0.28209479177387814)[:, None]
    if dtype == torch.float64:
        args = [a.double() for a in args]
        cam = _double(cam)
    g = torch.Generator().manual_seed(seed)
    grads = [torch.randn((n, 2), generator=g, dtype=dtype),
             1e-3 * torch.randn((n, 3), generator=g, dtype=dtype),
             torch.randn((n, 3), generator=g),
             torch.randn(n, generator=g)]
    grads[2][:50] = 1.0001237
    grads[3][:50] = torch.tensor([1.0001237, -3e-8, 6e4, 2.0 ** -25]).repeat(13)[:50]
    for x in grads:
        x[::5] = 0.0
    kw.pop("cov3d_precomp", None), kw.pop("colors_precomp", None)
    return args, cam, deg, kw, grads


def _autograd(args, cam, deg, kw, grads):
    leaves = [a.clone().requires_grad_(True) for a in args]
    off = torch.zeros((args[0].shape[0], 2), dtype=args[0].dtype, requires_grad=True)
    kw = {k: v for k, v in kw.items() if k != "means2d_offset"}
    sp = projection.preprocess_plain(*leaves, cam, deg, means2d_offset=off, **kw)
    return torch.autograd.grad([sp.means2d, sp.conics, sp.colors, sp.opacities],
                               leaves + [off], grads)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", VJP_CASES)
def test_vjp_plain_matches_autograd(case, dtype):
    args, cam, deg, kw, grads = _case(case, dtype=dtype)
    want = _autograd(args, cam, deg, kw, grads)
    got = projection.preprocess_vjp_plain(*args, cam, deg, grads,
                                          scale_modifier=kw.get("scale_modifier", 1.0))
    assert_grads_close(got, want, *TOL[dtype])
    # the offset's gradient is means2d's; the opacities' is f16-rounded and
    # zero where the forward flushed; a slot with no incoming gradient gets zeros
    assert torch.equal(got[5], grads[0]) and torch.equal(want[5], grads[0])
    assert torch.equal(got[3], want[3])
    assert float(want[3][16]) == 1.0 and float(want[3][12]) == 0.0  # 1.0001237; 3e-5 flushed
    for g in got:
        assert bool((g[::5] == 0).all())


def test_vjp_cases_reach_every_mask():
    """The inputs hold slots at |tz| < 1e-6, beyond the tan-fov clamp, behind
    the near plane, with det <= 0 nowhere (no precomputed covariance), with
    colors flushed and clamped at 0, and the higher bands masked at degree 0."""
    args, cam, deg, kw, _ = _case("deg3")
    with torch.no_grad():
        sp = projection.preprocess_plain(*args, cam, deg, **kw)
        e = projection._ewa_terms(args[0], projection.covariance6(args[1], args[2]), cam)
    assert bool(e.z_held.any())
    assert bool((e.ux.abs() > e.lim_x).any()) and bool((e.uy.abs() > e.lim_y).any())
    assert bool((sp.depths < projection.NEAR_CULL_Z).any()) and bool((sp.radii == 0).any())
    assert bool((sp.opacities == 0).any()) and bool((sp.colors == 0).any())


@pytest.mark.parametrize("case", ["deg3", "deg2", "deg1", "deg0_k1", "scale_modifier"])
def test_vjp_plain_matches_gsjax(case):
    """Against gsjax's ``jax.vjp`` of its preprocess, from the same inputs and
    cotangents (zero where the slot is culled: the slots a training step
    sends gradients to), at tests/test_torch_train.py's tolerance. Both run
    in float64 (gsjax under ``jax.enable_x64``; colors and opacities stay
    float32, as quantize_f16 returns them): in float32 the two forwards
    round the nearly singular 2D covariances of these inputs' thin
    gaussians differently (det loses ~4 digits), and the gradients with
    them, gsjax's against the port's autograd as much as against this."""
    import jax
    import jax.numpy as jnp
    from gsjax.data.cameras import Camera as JCamera
    from gsjax.ops.projection import preprocess as j_preprocess

    args, cam, deg, kw, grads = _case(case, dtype=torch.float64)
    with torch.no_grad():
        sp = projection.preprocess_plain(*args, cam, deg, **kw)
    used = sp.radii > 0
    grads = [torch.where(used[:, None] if g.dim() == 2 else used, g, 0.0) for g in grads]
    got = projection.preprocess_vjp_plain(*args, cam, deg, grads,
                                          scale_modifier=kw.get("scale_modifier", 1.0))
    with jax.enable_x64(True):
        jcam = JCamera(uid=0, image_name="t", R=np.eye(3), T=np.zeros(3), fov_x=0.8,
                       fov_y=0.8 * cam.height / cam.width, width=cam.width,
                       height=cam.height).to_render_camera()
        act = jnp.asarray(kw["active_mask"].numpy())

        def f(m, s, q, o, sh, off):
            out = j_preprocess(m, s, q, o, sh, jcam, deg,
                               scale_modifier=kw.get("scale_modifier", 1.0),
                               active_mask=act, means2d_offset=off)
            return out.means2d, out.conics, out.colors, out.opacities

        primals = [jnp.asarray(a.numpy()) for a in args]
        outs, vjp = jax.vjp(f, *primals, jnp.zeros((args[0].shape[0], 2)))
        assert [o.dtype for o in outs] == [jnp.float64, jnp.float64, jnp.float32, jnp.float32]
        want = [np.asarray(x) for x in vjp(tuple(jnp.asarray(g.numpy()) for g in grads))]
    for name, a, b in zip(GROUPS, got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()), err_msg=name)


def _mirror_bwd(monkeypatch):
    """``preprocess_bwd`` replaced by the closed form, for the CPU: returns
    the list of each call's ``with_offset``."""
    calls = []

    def bwd(means3d, scales, quats, opacities, shs, camera, sh_degree, grads, *,
            scale_modifier=1.0, with_offset=True):
        calls.append(with_offset)
        return projection.preprocess_vjp_plain(means3d, scales, quats, opacities, shs, camera,
                                               sh_degree, grads, scale_modifier=scale_modifier,
                                               with_offset=with_offset)

    monkeypatch.setattr(projection, "preprocess_bwd", bwd)
    return calls


@pytest.mark.parametrize("offset", [True, False], ids=["offset", "no_offset"])
def test_preprocess_train_function(offset, monkeypatch):
    """``preprocess_train`` (the card's path under autograd) with its
    backward on the closed form: the forward is the plain version bit for
    bit, the integer fields and depths carry no gradient, and autograd
    through it gives the closed form's gradients, for a loss that reaches
    only some outputs too (the others' gradients count as zero)."""
    calls = _mirror_bwd(monkeypatch)
    args, cam, deg, kw, grads = _case("deg2", n=600)
    leaves = [a.clone().requires_grad_(i != 4) for i, a in enumerate(args)]  # shs frozen
    off = torch.zeros((600, 2), requires_grad=True) if offset else None
    sp = projection.preprocess_train(*leaves, cam, deg, means2d_offset=off, **kw)
    with torch.no_grad():
        plain = projection.preprocess_plain(*args, cam, deg, means2d_offset=off, **kw)
    for f, a, b in zip(plain._fields, sp, plain):
        assert torch.equal(a, b), f
        assert a.requires_grad == (f in ("means2d", "conics", "colors", "opacities")), f
    loss = (sp.means2d * grads[0]).sum() + (sp.colors * grads[2]).sum()
    got = torch.autograd.grad(loss, leaves[:4] + ([off] if offset else []))
    want = projection.preprocess_vjp_plain(*args, cam, deg, (grads[0], None, grads[2], None))
    for name, a, b in zip(GROUPS[:4] + GROUPS[5:], got, want[:4] + want[5:]):
        assert torch.equal(a, b), name
    assert calls == [offset]


def test_preprocess_path_rule():
    plain, infer, train = (projection.preprocess_plain, projection.preprocess_infer,
                           projection.preprocess_train)
    for wants_grad in (False, True):
        for kernel_grads in (False, True):
            assert projection.preprocess_path(False, wants_grad, kernel_grads) is plain
            assert projection.preprocess_path(True, False, kernel_grads) is infer
    assert projection.preprocess_path(True, True, True) is train
    assert projection.preprocess_path(True, True, False) is plain
    with pytest.raises(ValueError, match="precomputed"):
        args, cam, deg, kw = _prep_inputs("cov3d", "cpu", n=64)
        projection.preprocess_train(*args, cam, deg, **kw)


@pytest.mark.parametrize("case", ["deg3", "cov3d", "colors"])
def test_cpu_tensors_under_autograd_run_the_plain_version(case):
    """CPU tensors, the toggles' cases among them, run the plain version
    under autograd: its graph, not the Function's, and no kernel count."""
    args, cam, deg, kw = _prep_inputs(case, "cpu", n=500)
    for t in args[:4]:
        t.requires_grad_(True)
    before = profiling.launches()
    sp = projection.preprocess(*args, cam, deg, **kw)
    assert "PreprocessTrain" not in type(sp.means2d.grad_fn).__name__
    (sp.means2d.sum() + sp.colors.sum()).backward()
    assert profiling.launches() == before and args[0].grad is not None


def test_preprocess_bwd_refuses_cpu_tensors():
    args, cam, deg, kw, grads = _case("deg3", n=64)
    before = profiling.launches()
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        projection.preprocess_bwd(*args, cam, deg, grads)
    assert profiling.launches() == before


def test_graph_replays_count_preprocess_bwd_launches(fake_card):
    """A graphed step's preprocess backward launch counts at its warm-up and
    at each replay, not at the capture."""
    assert_replays_count("preprocess_bwd", open_call=True)


def test_preprocess_bwd_ctypes_signature_matches_its_c_entry():
    assert "-fmad=false" not in kernels.SOURCE_FLAGS.get("preprocess_bwd.cu", ())
    want = kernels.SOURCES["preprocess_bwd.cu"]["gsjax_preprocess_bwd"]
    got = [_C_TYPES[t] for t in _c_signature("preprocess_bwd.cu", "gsjax_preprocess_bwd")]
    assert got == want


def test_prep_cases_are_known():
    assert set(VJP_CASES) <= set(PREP_CASES)
