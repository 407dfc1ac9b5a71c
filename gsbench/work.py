"""The yardstick's arithmetic: the card's peaks, the operations and bytes
the inputs need, and the least time those take.

Copied from the port's ``utils/profiling.py`` (peaks and the per-item
counts of the compositing kernels) and kept here, where a change to the
program cannot move them. Every count is of the work the inputs need,
whatever implements it: the compositing kernels' operations are counted
only at the (pair, pixel) steps that change the result, as the reference
counts them on the same inputs (blended in the forward; the same set
contributes in the backward), never by the kernels' own cull or walk
counters. Each count is a floor, so a share of a peak cannot pass 100%
by construction.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the 700 W power limit: HBM3 bandwidth and
# the float32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# exps a second on the special-function units: 16 results a clock an SM
# (CUDA C++ programming guide, arithmetic instruction throughput, compute
# capability 9.0) x 132 SMs x 1.98 GHz (the clock at which 132 SMs x 128
# lanes x 2 operations give the 67 TFLOP/s above)
PEAK_EXP_PER_S = 132 * 16 * 1.98e9

# Forward, a blended (pair, pixel): dx, dy (2), the quadratic form (11),
# the exp (1), op * exp (1), the 0.99 clamp (1); the blend: 1 - alpha,
# T (1 - alpha), alpha T (3) and three color multiply-adds (6). Compares
# not counted.
OPS_FWD_TEST = 16
OPS_FWD_BLEND = 9
# Backward, a contributing (pair, pixel): dx, dy and the quadratic form
# (13); the exp, alpha, T rebuilt by a division, w, c.V (5), dL/dalpha (5),
# S (2), g_pow (2), the nine pixel-sum terms and their nine adds (~40).
OPS_BWD_WALK = 13
OPS_BWD_CONTRIB = 40
OPS_FWD = OPS_FWD_TEST + OPS_FWD_BLEND  # 25
OPS_BWD = OPS_BWD_WALK + OPS_BWD_CONTRIB  # 53

# Preprocess forward, an active gaussian: activations (exp x3, quaternion
# normalize ~12, sigmoid 3: 18); view and clip transforms (4x4 products,
# 56) and the pixel position (12); the covariance from scale and rotation
# (~81); EWA (J W Sigma W^T J^T with the clamps, ~83); determinant, conic,
# eigenvalue, radius and rectangles (~36); degree-3 SH (basis ~35, 48
# multiply-adds 96, offset and clamp 6, direction 15); f16 rounding (4).
# Floor: 400. Its backward: at least as many again for each of the two
# passes autograd makes over most terms, floor 800.
OPS_PREP_FWD = 400
OPS_PREP_BWD = 800
# Loss, a pixel channel: L1 (3); SSIM's products (3) and the three
# separable 11-tap blurs that depend on the render (x, x^2, xy: 3 x 2 x 22
# = 132; the target's two are constant), the map (~14); its backward:
# the three blurs transposed (132) and the elementwise terms (~30).
# Floor: 300.
OPS_LOSS = 300
# Adam, a parameter: two moments (3 + 4), the bias corrections, root,
# epsilon, division, learning rate and the step (7).
OPS_ADAM = 14
PARAMS_PER_GAUSS = 59  # xyz 3, DC 3, rest 45, scale 3, rotation 4, opacity 1
# Assemble (C + T bg) a pixel: 6; the uint8 quantize a channel: 3.
OPS_ASSEMBLE = 6
OPS_QUANTIZE = 3

BYTES_ATTR_ROW = 32  # one gaussian's packed row: 8 words
BWD_ROW_WORDS_BF16 = 5  # the bf16 gradient table, a pair


def kernel_work(kernel: str, frame: dict) -> tuple:
    """``(bytes, operations, exps)`` one launch of ``kernel`` needs on a
    frame, from the reference's counts: ``frame`` has ``pairs``,
    ``gauss_with_pairs``, ``tiles`` and ``blended``. Each input is read
    once and each output written once; a pixel is a float32 word."""
    px = frame["tiles"] * 256
    common = (frame["gauss_with_pairs"] * BYTES_ATTR_ROW + frame["pairs"] * 4
              + (frame["tiles"] + 1) * 4)
    if kernel == "composite_infer":
        return common + 4 * px * 4, frame["blended"] * OPS_FWD, frame["blended"]
    if kernel == "composite_fwd":
        return common + 5 * px * 4, frame["blended"] * OPS_FWD, frame["blended"]
    if kernel == "composite_bwd":
        return (common + 6 * px * 4 + frame["pairs"] * BWD_ROW_WORDS_BF16 * 4,
                frame["blended"] * OPS_BWD, frame["blended"])
    raise ValueError(f"unknown kernel {kernel!r}")


def least_seconds(bytes_: float, ops: float, exps: float) -> float:
    """The least time the card could take: the largest of bytes over the
    memory rate, operations over the float32 rate and exps over the
    special-function rate."""
    return max(bytes_ / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S, exps / PEAK_EXP_PER_S)


def train_step_ops(frame: dict, n_active: int) -> float:
    """Float32 operations one training iteration needs."""
    pixels = frame["width"] * frame["height"]
    return (n_active * (OPS_PREP_FWD + OPS_PREP_BWD + PARAMS_PER_GAUSS * OPS_ADAM)
            + pixels * (3 * OPS_LOSS + OPS_ASSEMBLE)
            + frame["blended"] * (OPS_FWD + OPS_BWD))


def view_frame_ops(frame: dict, n_active: int) -> float:
    """Float32 operations one served frame needs."""
    pixels = frame["width"] * frame["height"]
    return (n_active * OPS_PREP_FWD + pixels * (OPS_ASSEMBLE + 3 * OPS_QUANTIZE)
            + frame["blended"] * OPS_FWD)
