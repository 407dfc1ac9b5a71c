"""The port's CUDA kernel library: every source in ``gsjax_torch/csrc/``,
its build, its loading and every launch.

- :data:`SOURCES` names each source's exported C entries with their
  ``ctypes`` argument types; one shared library per source.
- :func:`build_library` compiles each source with ``nvcc`` for ``sm_90a``
  at first use into ``build/gsjax_torch/libgsjax_torch_<name>.so`` (one
  ``nvcc`` per source, all started together); :func:`load_library` loads
  them with ``ctypes``.
- :func:`launch` calls a kernel's C entry ``gsjax_<name>`` on the current
  stream and counts the launch in ``utils.profiling``'s registry under
  ``name`` (its ``launches()``). A launch made while a CUDA graph is
  captured is recorded into that capture and counts at each of its replays
  (``utils.graphs``), so the counts are the kernels that ran.

Adding a kernel is one :data:`SOURCES` entry and its wrapper's call of
:func:`launch`. The wrappers:

==========================  ===========================================
source                      wrappers (each launch counted under its name)
==========================  ===========================================
``composite_infer.cu``      ``cuda_composite.composite_infer``
``composite_fwd.cu``        ``cuda_composite.composite_fwd``,
                            ``cuda_composite.composite_fwd_check``
``composite_bwd.cu``        ``cuda_composite.composite_bwd`` (its bf16
                            instances also as ``composite_bwd_bf16``),
                            ``cuda_composite.composite_bwd_counts``
``sol_probe.cu``            ``cuda_probe.sol_probe``
``preprocess_infer.cu``     ``projection.preprocess_infer``
``preprocess_bwd.cu``       ``projection.preprocess_bwd``
==========================  ===========================================
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import types

import torch

from gsjax_torch.utils import profiling

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_REPO_ROOT, "gsjax_torch", "csrc")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "gsjax_torch")
# source -> {exported function: its ctypes argument types}; one shared
# library per source
_P, _I = ctypes.c_void_p, ctypes.c_int
SOURCES = {
    "composite_infer.cu": {"gsjax_composite_infer": [_P] * 5 + [_I] * 2 + [_P]},
    "composite_fwd.cu": {"gsjax_composite_fwd": [_P] * 6 + [_I] * 2 + [_P],
                         "gsjax_composite_fwd_check": [_P] * 6 + [_I] * 2 + [_P]},
    "composite_bwd.cu": {"gsjax_composite_bwd": [_P] * 8 + [_I] * 3 + [_P],
                         "gsjax_composite_bwd_counts": [_P] * 9 + [_I] * 4 + [_P]},
    # the speed-of-light probe (ops/cuda_probe.py)
    "sol_probe.cu": {"gsjax_sol_probe":
                     [_P] * 3 + [_I] * 5 + [ctypes.POINTER(ctypes.c_float), _P],
                     "gsjax_sol_probe_info": [_I] * 4 + [ctypes.POINTER(ctypes.c_int)]},
    # the primal preprocess (ops/projection.py:preprocess_infer)
    "preprocess_infer.cu": {"gsjax_preprocess_infer":
                            [_P] * 23 + [_I] * 5 + [ctypes.c_float, _I, _P]},
    # its backward (ops/projection.py:preprocess_bwd)
    "preprocess_bwd.cu": {"gsjax_preprocess_bwd":
                          [_P] * 14 + [_I] * 4 + [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P]},
}
HEADERS = ("composite_blend.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# flags of one source only: the preprocess contracts no multiply-add that the
# plain version rounds twice (see its header)
SOURCE_FLAGS = {"preprocess_infer.cu": ("-fmad=false",)}

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


def _lib_path(source: str) -> str:
    return os.path.join(BUILD_DIR, f"libgsjax_torch_{source[:-3]}.so")


def build_library(verbose: bool = False) -> dict:
    """Compile each ``csrc/*.cu`` into ``build/gsjax_torch/libgsjax_torch_<name>.so``
    unless an up-to-date library is there; the ``nvcc`` processes run side
    by side. Returns ``{source: library path}``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    newest_header = max(os.path.getmtime(os.path.join(CSRC_DIR, h)) for h in HEADERS)
    jobs = {}
    for src in SOURCES:
        out = _lib_path(src)
        path = os.path.join(CSRC_DIR, src)
        if os.path.exists(out) and os.path.getmtime(out) >= max(
                os.path.getmtime(path), newest_header):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(src, ()),
               *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, path]
        jobs[src] = (cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (cmd, tmp, out, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            continue
        if verbose:
            print(f"{src}:\n{log}", flush=True)
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return {src: _lib_path(src) for src in SOURCES}


def load_library(verbose: bool = False) -> types.SimpleNamespace:
    """Build (at first use) and load the kernels; returns a namespace of
    their ctypes functions, by exported name."""
    global _lib
    with _lib_lock:
        if _lib is None:
            fns = {}
            for src, path in build_library(verbose).items():
                lib = ctypes.CDLL(path)
                for name, argtypes in SOURCES[src].items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib


def launch(name: str, *args):
    """Launch the C entry ``gsjax_<name>`` with ``args`` on the current
    stream of its tensors' device, and count the launch under ``name``.

    ``args`` are the entry's arguments before the stream: a tensor passes
    its data pointer and must be on CUDA, ``None`` passes a null pointer,
    anything else passes as it is. Raises on a tensor that is not on CUDA
    and on a nonzero return (a launch error)."""
    dev = None
    c_args = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.device.type != "cuda":
                raise RuntimeError(f"{name} runs on CUDA or CPU tensors, not {a.device}")
            if dev is None:
                dev = a.device
            a = a.data_ptr()
        c_args.append(a)
    fn = getattr(load_library(), f"gsjax_{name}")
    with torch.cuda.device(dev):
        err = fn(*c_args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    profiling.launched(name)
