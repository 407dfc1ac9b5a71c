"""LPIPS perceptual metric (torch): the counterpart of ``gsjax.eval.lpips``.

Re-implements the reference's vendored ``lpipsPyTorch`` (reference:
lpipsPyTorch/modules/lpips.py:8-36, networks.py:66-96): a frozen VGG16
feature extractor, unit-normalized activations at the 5 ReLU stages, fixed
1x1 linear heads, and spatial averaging. The convolutions are library
calls (``F.conv2d``); TF32 stays off (``gsjax_torch/__init__.py``), since
it would move the distance in its third decimal.

The weights are **gated** as gsjax's are: nothing is downloaded. They load
from an ``.npz`` found via (in order)

1. the ``weights`` argument,
2. ``$GSJAX_LPIPS_WEIGHTS``,
3. ``~/.cache/gsjax/lpips_vgg.npz``

and :func:`load_weights` raises a clear error when it is absent. The npz
layout is gsjax's, so either package loads the same file: ``conv{i}_w``
(HWIO) / ``conv{i}_b`` for the 13 VGG16 convs and ``lin{j}`` (C_j,) for
the 5 heads; :func:`params_from_numpy` turns it into this module's
parameters (OIHW tensors on a device), and :func:`convert_torch_state`
builds it from the upstream torch state dicts.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gsjax_torch.utils.system import resolve_device

# VGG16 conv channel plan; features are tapped after the ReLU preceding
# each pool (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3).
_VGG16 = [64, 64, "P", 128, 128, "P", 256, 256, 256, "P", 512, 512, 512, "P",
          512, 512, 512]
_TAPS = (1, 3, 6, 9, 12)  # conv indices (0-based) whose relu output is tapped
N_CONVS = 13

# z-score constants (reference lpipsPyTorch networks.py BaseNet buffers),
# applied straight to the [0, 1] input as the reference evaluates
# (metrics.py:31-32 -> networks.py z_score): it never rescales to [-1, 1]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision's vgg16().features indices of the 13 convs
_TORCH_CONV_LAYERS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def default_weight_path() -> str:
    return os.environ.get(
        "GSJAX_LPIPS_WEIGHTS",
        os.path.expanduser("~/.cache/gsjax/lpips_vgg.npz"),
    )


def available(path: Optional[str] = None) -> bool:
    return os.path.exists(path or default_weight_path())


def params_from_numpy(arrays, device="cuda") -> Dict[str, torch.Tensor]:
    """gsjax's npz arrays (``conv{i}_w`` HWIO, ``conv{i}_b``, ``lin{j}``) as
    this module's float32 parameters on ``device``: conv weights OIHW."""
    dev = resolve_device(device)
    out = {}
    for k, v in arrays.items():
        a = np.array(v, np.float32)  # a copy, cast on load: f16 artifacts compute in f32
        if k.endswith("_w"):
            a = np.ascontiguousarray(np.transpose(a, (3, 2, 0, 1)))  # HWIO -> OIHW
        out[k] = torch.as_tensor(a, device=dev)
    return out


def load_weights(path: Optional[str] = None, device="cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    path = path or default_weight_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"LPIPS weights not found at {path}. This environment cannot "
            "download them (no egress); place the converted VGG16+linear "
            "npz there, set $GSJAX_LPIPS_WEIGHTS, or use "
            "gsjax_torch.eval.lpips.convert_torch_state() on the upstream "
            "torch checkpoints."
        )
    with np.load(path) as z:
        return params_from_numpy({k: z[k] for k in z.files}, dev)


class VGG16Features(nn.Module):
    """The frozen VGG16 feature extractor up to relu5_3: ``forward(x)`` on
    (N, 3, H, W) images in [0, 1] returns the 5 tapped (N, C, h, w) maps."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        for i in range(N_CONVS):
            self.register_buffer(f"conv{i}_w", params[f"conv{i}_w"])
            self.register_buffer(f"conv{i}_b", params[f"conv{i}_b"])
        dev = params["conv0_w"].device
        self.register_buffer("shift", torch.tensor(_SHIFT, device=dev).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE, device=dev).view(1, 3, 1, 1))
        self.requires_grad_(False)

    def forward(self, x):
        x = (x - self.shift) / self.scale
        feats = []
        ci = 0
        for spec in _VGG16:
            if spec == "P":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(F.conv2d(x, getattr(self, f"conv{ci}_w"),
                                getattr(self, f"conv{ci}_b"), padding=1))
            if ci in _TAPS:
                feats.append(x)
            ci += 1
        return feats


def _unit_normalize(x, eps=1e-10):
    # x / (||x|| + eps) over channels, matching reference utils.py
    # normalize_activation (NOT x / sqrt(ss + eps))
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


@torch.no_grad()
def lpips(img0, img1, params: Optional[Dict[str, torch.Tensor]] = None, weights_path=None):
    """LPIPS distance between (H, W, 3) or (N, H, W, 3) images in [0, 1]
    (tensors on the parameters' device). Returns (N,) distances, or a 0-d
    tensor for one image pair. Matches reference lpipsPyTorch/__init__.py:
    6-21 with net_type='vgg'."""
    if params is None:
        params = load_weights(weights_path, img0.device)
    if img0.dim() == 3:
        img0, img1 = img0[None], img1[None]
    vgg = VGG16Features(params)
    f0 = vgg(img0.to(torch.float32).permute(0, 3, 1, 2))
    f1 = vgg(img1.to(torch.float32).permute(0, 3, 1, 2))
    total = 0.0
    for j, (a, b) in enumerate(zip(f0, f1)):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2  # (N, C, h, w)
        lin = params[f"lin{j}"].view(1, -1, 1, 1)  # (C,) nonneg 1x1 head
        total = total + torch.sum(d * lin, dim=1).mean(dim=(1, 2))
    return total if total.shape[0] > 1 else total[0]


def convert_torch_state(vgg_features_state: dict, lin_state: dict,
                        out_path: Optional[str] = None) -> str:
    """Build gsjax's npz from upstream torch state dicts (tensors or numpy).

    ``vgg_features_state``: torchvision ``vgg16().features.state_dict()``
    (keys like ``0.weight`` OIHW); ``lin_state``: richzhang LPIPS linear
    checkpoint (keys like ``lin0.model.1.weight`` (C,1,1,1) or the
    lpipsPyTorch variant). Returns the written path."""

    def arr(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    out_path = out_path or default_weight_path()
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    arrs = {}
    for ci, li in enumerate(_TORCH_CONV_LAYERS):
        arrs[f"conv{ci}_w"] = np.transpose(arr(vgg_features_state[f"{li}.weight"]),
                                           (2, 3, 1, 0))  # OIHW -> HWIO
        arrs[f"conv{ci}_b"] = arr(vgg_features_state[f"{li}.bias"])
    for j in range(5):
        for k in (f"lin{j}.model.1.weight", f"lin.{j}.model.1.weight",
                  f"{j}.model.1.weight"):
            if k in lin_state:
                arrs[f"lin{j}"] = arr(lin_state[k]).reshape(-1)
                break
        else:
            raise KeyError(f"no linear head for stage {j} in lin_state")
    np.savez(out_path, **arrs)
    return out_path
