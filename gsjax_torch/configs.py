"""Config system: dataclass param groups with reference-compatible flags.

A copy of ``gsjax.configs`` (host-side; no torch).

Mirrors the reference's reflection-based argparse groups
(reference: arguments/__init__.py:19-112) — same group names, same flag
names, same defaults, same short-flag behavior (fields listed in
``_SHORT_FLAGS`` also get a one-letter alias) — but built on dataclasses and
without the reference's ``eval()`` of the saved config (cfg_args is parsed
safely here).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional, Type

# fields that get short aliases (reference marks them with a leading "_")
_SHORT_FLAGS = {
    "source_path": "s",
    "model_path": "m",
    "images": "i",
    "resolution": "r",
    "white_background": "w",
}


@dataclasses.dataclass
class ModelParams:
    """reference arguments/__init__.py:47-62."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    data_device: str = "cuda"  # accepted for CLI parity; --device picks the device
    eval: bool = False

    def __post_init__(self):
        self.source_path = os.path.abspath(self.source_path) if self.source_path else ""


@dataclasses.dataclass
class PipelineParams:
    """reference arguments/__init__.py:64-69. The python-path toggles
    compute SH->RGB and the 3D covariance outside the rasterizer."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclasses.dataclass
class OptimizationParams:
    """reference arguments/__init__.py:71-90."""

    iterations: int = 30_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 2e-4
    random_background: bool = False


def add_group(parser: argparse.ArgumentParser, cls: Type, title: str):
    group = parser.add_argument_group(title)
    for f in dataclasses.fields(cls):
        names = [f"--{f.name}"]
        if f.name in _SHORT_FLAGS:
            names.append(f"-{_SHORT_FLAGS[f.name]}")
        if f.type in ("bool", bool):
            group.add_argument(*names, action="store_true", default=f.default)
        else:
            typ = {int: int, float: float, str: str}.get(
                f.type if isinstance(f.type, type) else {"int": int, "float": float, "str": str}[f.type]
            )
            group.add_argument(*names, type=typ, default=f.default)
    return group


def extract(cls: Type, args: argparse.Namespace):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items() if k in names})


def save_cfg_args(model_path: str, model: ModelParams):
    """Persist the model namespace like the reference does
    (train.py:145-146) so downstream tools can recover it."""
    os.makedirs(model_path, exist_ok=True)
    ns = argparse.Namespace(**dataclasses.asdict(model))
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(ns))


def load_cfg_args(model_path: str) -> dict:
    """Parse a saved cfg_args without eval() (unlike the reference,
    arguments/__init__.py:97-106)."""
    import ast

    with open(os.path.join(model_path, "cfg_args")) as f:
        text = f.read().strip()
    assert text.startswith("Namespace(") and text.endswith(")")
    out = {}
    node = ast.parse("dict(" + text[len("Namespace(") : -1] + ")", mode="eval")
    for kw in node.body.keywords:
        out[kw.arg] = ast.literal_eval(kw.value)
    return out


def get_combined_args(parser: argparse.ArgumentParser, argv: Optional[List[str]] = None):
    """CLI over saved cfg_args (reference arguments/__init__.py:92-112)."""
    args = parser.parse_args(argv)
    try:
        saved = load_cfg_args(args.model_path)
    except (OSError, AssertionError):
        saved = {}
    merged = dict(saved)
    defaults = {a.dest: parser.get_default(a.dest) for a in parser._actions}
    for k, v in vars(args).items():
        if k not in merged or v != defaults.get(k):
            merged[k] = v
    return argparse.Namespace(**merged)
