"""The needed-work counts and the roofline and mfu arithmetic, on
hand-made bins and frames."""


import pytest
import torch

from gsbench import harness, work
from gsbench.reference import render as R


def direct_blend(pair_gauss, tile_start, m, c, col, op, w, h):
    """The per-pixel sequential loop of the reference rasterizer."""
    tiles_x, tiles_y = R.num_tiles(w, h)
    img = torch.zeros((h, w, 3), dtype=torch.float64)
    blended = 0
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            t = ty * tiles_x + tx
            for py in range(ty * 16, min(ty * 16 + 16, h)):
                for px in range(tx * 16, min(tx * 16 + 16, w)):
                    T = 1.0
                    for p in range(int(tile_start[t]), int(tile_start[t + 1])):
                        g = int(pair_gauss[p])
                        dx, dy = px - float(m[g, 0]), py - float(m[g, 1])
                        power = -0.5 * (float(c[g, 0]) * dx * dx + float(c[g, 2]) * dy * dy) \
                            - float(c[g, 1]) * dx * dy
                        if power > 0:
                            continue
                        a = min(0.99, float(op[g]) * float(torch.exp(torch.tensor(power))))
                        if a < 1 / 255:
                            continue
                        if T * (1 - a) < 1e-4:
                            break
                        img[py, px] += torch.tensor(col[g].tolist(), dtype=torch.float64) * a * T
                        T *= 1 - a
                        blended += 1
    return img, blended


def hand_frame():
    """Three gaussians over a 32x16 frame (two tiles), the last one large
    and opaque behind the others."""
    m = torch.tensor([[5.0, 6.0], [20.0, 8.0], [16.0, 8.0]])
    c = torch.tensor([[0.05, 0.0, 0.05], [0.1, 0.02, 0.08], [0.004, 0.0, 0.004]])
    col = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.2, 0.3, 0.9]])
    op = torch.tensor([0.9, 0.7, 0.99])
    pair_gauss = torch.tensor([0, 2, 1, 2])  # tile 0: 0 then 2; tile 1: 1 then 2
    tile_start = torch.tensor([0, 2, 4])
    return pair_gauss, tile_start, m, c, col, op


def test_blend_counts_the_blended_steps_and_matches_a_direct_loop():
    pg, ts, m, c, col, op = hand_frame()
    blend = R.Blend(pg, ts, m, c, col, op, 32, 16)
    tc, tT = blend.forward()
    img = R.assemble(tc, tT, torch.zeros(3), 32, 16)
    want, blended = direct_blend(pg, ts, m, c, col, op, 32, 16)
    assert blend.blended == blended > 0
    assert torch.allclose(img.double(), want, atol=1e-6)


def test_blend_backward_is_autograd_of_the_forward():
    pg, ts, m, c, col, op = hand_frame()
    leaves = [x.clone().double().requires_grad_(True) for x in (m, c, col, op)]
    blend = R.Blend(pg, ts, *leaves, 32, 16)
    tc, tT = blend.forward()
    g_c = torch.rand_like(tc)
    g_T = torch.rand_like(tT)
    got = blend.backward(g_c, g_T)
    # the same blend, differentiated end to end in one graph
    b2 = R.Blend(pg, ts, *leaves, 32, 16)
    b2.attrs = tuple(leaves)
    with torch.enable_grad():
        px, py = R._tile_pixels(b2.order, 2, torch.float64)
        g, live = b2._gather(torch.arange(2), 0, 2)
        alpha, power = R._chunk_alpha(px, py, leaves[0][g], leaves[1][g], leaves[3][g])
        a, t_ex, t_out, _, _ = R._chunk_blend(alpha, power, live,
                                              torch.ones(2, 256, dtype=torch.float64),
                                              torch.zeros(2, 256, dtype=torch.bool))
        add = torch.einsum("bkp,bkc->bpc", a * t_ex, leaves[2][g])
        want = torch.autograd.grad([add, t_out], leaves, [g_c, g_T], allow_unused=True)
    for x, y in zip(got, want):
        assert torch.allclose(x, torch.zeros_like(x) if y is None else y, atol=1e-9)


def test_kernel_work_counts_inputs_once_and_the_blended_steps():
    f = {"pairs": 10, "gauss_with_pairs": 4, "tiles": 2, "blended": 100,
         "width": 32, "height": 16}
    common = 4 * 32 + 10 * 4 + 3 * 4
    assert work.kernel_work("composite_infer", f) == (common + 4 * 512 * 4, 2500, 100)
    assert work.kernel_work("composite_fwd", f) == (common + 5 * 512 * 4, 2500, 100)
    assert work.kernel_work("composite_bwd", f) == (common + 6 * 512 * 4 + 10 * 5 * 4, 5300,
                                                   100)
    b, o, e = 3.35e9, 67e9, 0
    assert work.least_seconds(b, 0, 0) == pytest.approx(1e-3)
    assert work.least_seconds(0, o, e) == pytest.approx(1e-3)
    assert work.least_seconds(b, 2 * o, 0) == pytest.approx(2e-3)


def test_roofline_and_mfu_readers():
    read = harness.metric_reader("composite_bwd_roofline")
    ctx = {"kind": "train", "kernel_time": {"composite_bwd": [2e-3, 25]},
           "kernel_need": {"composite_bwd": 1e-4}}
    assert read(ctx) == pytest.approx(5.0)
    assert read({"kind": "train"}) is None
    mfu = harness.metric_reader("train_mfu")
    assert mfu({"kind": "train", "needed_ops": 67e9, "mfu_seconds": 0.1}) == pytest.approx(1.0)
    assert mfu({"kind": "view", "needed_ops": 1.0, "mfu_seconds": 1.0}) is None
    idle = harness.metric_reader("device_idle.view")
    assert idle({"kind": "view", "busy_s": 0.75, "window_s": 1.0}) == pytest.approx(25.0)


def test_step_ops_are_a_floor_of_the_parts():
    f = {"blended": 1000, "width": 10, "height": 10}
    assert work.train_step_ops(f, 0) == 100 * (3 * work.OPS_LOSS + work.OPS_ASSEMBLE) \
        + 1000 * 78
    assert work.view_frame_ops(f, 2) == 2 * 400 + 100 * 15 + 1000 * 25


def test_kernel_names_are_the_ports_kernels():
    from gsbench import trace

    names = {"void gsjax::composite_blend_kernel<true, true>(int const*, float4 const*)":
             "composite_fwd",
             "void gsjax::composite_blend_kernel<false, true>(int const*)": "composite_infer",
             "void (anonymous namespace)::composite_bwd_kernel<2, true>(int const*)":
             "composite_bwd",
             "void at::native::(anonymous namespace)::f<4>(float*)": None}
    for full, want in names.items():
        assert trace.kernel_of(trace.short_name(full)) == want
    assert trace.short_name("void at::native::(anonymous namespace)::f<4>(float*)") == \
        "at::native::(anonymous namespace)::f<4>"
