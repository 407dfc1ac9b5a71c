"""CUDA inference compositing kernel, its plain version, and their inputs.

Counterpart of ``gsjax.ops.pallas_composite`` for the render-only path.
It holds:

- :func:`pack_f16_pair` and :func:`pack_gauss_attrs`, the per-gaussian
  half of gsjax's ``pack_pair_attrs``: an (N, 8) float32 table with colors
  and opacity as packed f16 words. The kernel gathers its rows through
  ``pair_gauss`` itself, so the (P, 8) pair table gsjax builds is never
  materialised.
- :func:`composite_infer`, the wrapper of the hand-written CUDA kernel in
  ``gsjax_torch/csrc/composite_infer.cu`` (which replaces gsjax's Pallas
  ``_composite_infer_kernel``), with its launch counter
  ``composite_infer.launches``.
- :func:`composite_infer_plain`, the plain PyTorch version with the same
  inputs, outputs and semantics: gsjax's chunked scan
  (:func:`gsjax_torch.ops.composite.scan_tiles`) with no
  ``max_splats_per_tile`` cap — its number of rounds comes from the
  longest tile in the data, as the kernel walks every pair.
- :func:`load_library`, which builds the kernel with ``nvcc`` for
  ``sm_90a`` at first use into ``build/gsjax_torch/`` and loads it with
  ``ctypes``.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

from gsjax_torch.ops.composite import scan_tiles
from gsjax_torch.ops.projection import TILE

PIX = TILE * TILE
ATTR_W = 8  # float32 words per gaussian row
PLAIN_CHUNK = 32  # pairs per round of the plain version's scan

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_REPO_ROOT, "gsjax_torch", "csrc")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "gsjax_torch")
LIB_NAME = "libgsjax_torch_kernels.so"
SOURCES = ("composite_infer.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_library(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into ``build/gsjax_torch/libgsjax_torch_kernels.so``
    unless an up-to-date library is there. Returns the library path."""
    out = os.path.join(BUILD_DIR, LIB_NAME)
    srcs = [os.path.join(CSRC_DIR, s) for s in SOURCES]
    if os.path.exists(out) and os.path.getmtime(out) >= max(
        os.path.getmtime(s) for s in srcs
    ):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *srcs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}{res.stderr}"
        )
    if verbose:
        print(res.stdout + res.stderr, flush=True)
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library(verbose))
            fn = lib.gsjax_composite_infer
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def pack_f16_pair(hi, lo):
    """Two float32 (N,) tensors -> one float32 tensor whose bits hold
    (f16(hi) << 16) | f16(lo), as gsjax's ``pack_f16_pair``: f16 denormals
    flush to signed zero, values above 65504 become f16 inf."""

    def h16(x):
        h = x.to(torch.float16)
        return torch.where(h.abs() < 2.0 ** -14, torch.copysign(torch.zeros_like(h), h), h)

    # little-endian: the low half of each 32-bit word comes first in memory
    return torch.stack([h16(lo), h16(hi)], dim=-1).view(torch.float32)[..., 0]


def pack_gauss_attrs(means2d, conics, colors, opacities):
    """Per-gaussian (N, 8) float32 rows: mean x/y, conic a/b/c,
    f16(r)<<16|f16(g), f16(b)<<16|f16(opacity), 0 — the per-gaussian half
    of gsjax's ``pack_pair_attrs`` (its last row carries the pair slot,
    which the inference kernel never reads)."""
    return torch.cat(
        [
            means2d.to(torch.float32),
            conics.to(torch.float32),
            pack_f16_pair(colors[:, 0], colors[:, 1])[:, None],
            pack_f16_pair(colors[:, 2], opacities)[:, None],
            torch.zeros_like(means2d[:, :1], dtype=torch.float32),
        ],
        dim=1,
    ).contiguous()


def unpack_gauss_attrs(gauss_attrs):
    """(N, 8) table -> (means2d, conics, colors, opacities) in float32; the
    f16 halves decode like ``__half2float`` (an f16 inf reads as inf)."""
    halves = gauss_attrs[:, 5:7].contiguous().view(torch.float16).to(torch.float32)
    # per word: low half first — columns are g, r, opacity, b
    colors = torch.stack([halves[:, 1], halves[:, 0], halves[:, 3]], dim=1)
    return gauss_attrs[:, 0:2], gauss_attrs[:, 2:5], colors, halves[:, 2]


def _check_inputs(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y):
    num_tiles = tiles_x * tiles_y
    if tile_start.dtype != torch.int32 or tile_start.shape != (num_tiles + 1,):
        raise ValueError(f"tile_start must be int32 ({num_tiles + 1},), got "
                         f"{tile_start.dtype} {tuple(tile_start.shape)}")
    if pair_gauss.dtype != torch.int32 or pair_gauss.dim() != 1:
        raise ValueError("pair_gauss must be a 1-d int32 tensor")
    if (gauss_attrs.dtype != torch.float32 or gauss_attrs.dim() != 2
            or gauss_attrs.shape[1] != ATTR_W):
        raise ValueError(f"gauss_attrs must be float32 (N, {ATTR_W})")
    devs = {tile_start.device, pair_gauss.device, gauss_attrs.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def composite_infer_plain(tile_start, pair_gauss, gauss_attrs, tiles_x: int,
                          tiles_y: int, return_evals: bool = False):
    """Plain PyTorch version of the kernel: same inputs, same outputs
    ``(tile_colors (T, 256, 3), tile_T (T, 256))``, same semantics, up to
    float reassociation (the scan's cumulative product against the
    kernel's sequential one). With ``return_evals`` it also returns the
    (T, 256) count of (pair, pixel) evaluations the kernel's walk needs."""
    _check_inputs(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    num_tiles = tiles_x * tiles_y
    longest = int((tile_start[1:] - tile_start[:num_tiles]).max()) if num_tiles else 0
    means2d, conics, colors, opacities = unpack_gauss_attrs(gauss_attrs)
    tile_colors, tile_T, _, n_eval = scan_tiles(
        pair_gauss, tile_start, means2d, conics, colors, opacities,
        tiles_x, tiles_y, -(-longest // PLAIN_CHUNK), PLAIN_CHUNK,
    )
    if return_evals:
        return tile_colors, tile_T, n_eval
    return tile_colors, tile_T


def composite_infer(tile_start, pair_gauss, gauss_attrs, tiles_x: int, tiles_y: int):
    """Composite every tile's depth-sorted pairs front to back.

    ``tile_start`` (T + 1,) int32 ranges into ``pair_gauss`` (P,) int32,
    which indexes rows of ``gauss_attrs`` (N, 8) float32
    (:func:`pack_gauss_attrs`). Returns ``(tile_colors (T, 256, 3),
    tile_T (T, 256))``. CUDA tensors launch the kernel (and count the
    launch in ``composite_infer.launches``); CPU tensors take
    :func:`composite_infer_plain`; anything else raises."""
    _check_inputs(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    dev = gauss_attrs.device
    if dev.type == "cpu":
        return composite_infer_plain(tile_start, pair_gauss, gauss_attrs, tiles_x, tiles_y)
    if dev.type != "cuda":
        raise RuntimeError(f"composite_infer runs on CUDA or CPU tensors, not {dev}")
    num_tiles = tiles_x * tiles_y
    tile_start = tile_start.contiguous()
    pair_gauss = pair_gauss.contiguous()
    gauss_attrs = gauss_attrs.contiguous()
    tile_colors = torch.empty((num_tiles, PIX, 3), dtype=torch.float32, device=dev)
    tile_T = torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gsjax_composite_infer(
            tile_start.data_ptr(), pair_gauss.data_ptr(), gauss_attrs.data_ptr(),
            tile_colors.data_ptr(), tile_T.data_ptr(), num_tiles, tiles_x, stream,
        )
    if err != 0:
        raise RuntimeError(f"composite_infer launch failed: CUDA error {err}")
    composite_infer.launches += 1
    return tile_colors, tile_T


composite_infer.launches = 0
