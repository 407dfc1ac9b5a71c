"""Native (C++) host-side components, loaded through ctypes.

Counterpart of ``gsjax.native``: the exact multithreaded KD-tree that
replaces the reference's ``simple-knn`` CUDA extension
(``simple_knn._C.distCUDA2``) for the initial Gaussian scales. The port
keeps its own copy of the source (``simple_knn.cpp``: the same tree, search
order and float32 sum as gsjax's, so the results are equal bit for bit).

It is compiled at first use by the host's C++ compiler (``$CXX``, else
``g++``) into ``build/gsjax_torch/libsimple_knn-<hash>.so``, the hash
covering the source, the compiler and the flags, so a stale binary never
shadows a changed source. A compiler that is missing or a build that fails
raises with the compiler's output: there is no fallback, since another
search (scipy's, which gsjax falls back to) differs on clouds of k points
or fewer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "simple_knn.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "gsjax_torch")
# gsjax builds with "-O3 -shared -fPIC -std=c++17" and no -march, so no
# multiply-add is contracted into an FMA on x86-64; -ffp-contract=off keeps
# the float32 sums so with a compiler or host that would contract
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_lock = threading.Lock()
_libs: dict = {}


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def library_path(cxx: str) -> str:
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join((cxx,) + CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libsimple_knn-{h.hexdigest()[:16]}.so")


def build_library(cxx: str) -> str:
    """Compile ``simple_knn.cpp`` with ``cxx`` unless its library is there;
    returns the library's path. Raises ``RuntimeError`` with the compiler's
    output when the compiler is missing or the build fails."""
    out = library_path(cxx)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE, "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"C++ compiler not found: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"building {SOURCE} failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out


def load():
    """Build (at first use) and load the library with :func:`compiler`."""
    cxx = compiler()
    with _lock:
        lib = _libs.get(cxx)
        if lib is None:
            lib = ctypes.CDLL(build_library(cxx))
            lib.knn_mean_sq_dist.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                                             ctypes.c_int32, ctypes.POINTER(ctypes.c_float)]
            lib.knn_mean_sq_dist.restype = None
            _libs[cxx] = lib
        return lib


def knn_mean_sq_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean squared distance of each point to its ``min(k, n - 1)`` nearest
    neighbours, exact (0 for a single point). (N, 3) -> (N,) float32."""
    lib = load()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {pts.shape}")
    if k < 1:  # the tree's heap holds k distances and reads the first
        raise ValueError(f"k must be at least 1, got {k}")
    n = pts.shape[0]
    out = np.empty(n, dtype=np.float32)
    lib.knn_mean_sq_dist(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), np.int32(n),
                         np.int32(k), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
