"""The speed-of-light probe of the compositing kernels: its CUDA kernel,
plain version and inputs.

Counterpart of the two Pallas probes named ``sol_kernel`` in gsjax's
measurement sessions (``scripts/_r4_session.py`` stage ``vpu``,
``scripts/_r5_session.py`` stage ``vpux``). The probe runs the compositing
kernels' skeleton — 256-thread blocks over tiles, the tile's 128-pair
window staged chunk by chunk — with ``k_ops`` full-width multiply-add
passes and ``k_exp`` exp passes per chunk over a (256 pixels, 128 lanes)
carry, at 8, 24 or 48 resident warps per SM (:data:`OCCUPANCIES`: the
first port's design, ``composite_bwd``'s and the forward kernels').
Sweeping ``k_ops`` gives the skeleton's floor (the intercept) and the time
of one pass (the slope); sweeping ``k_exp`` the time of one exp pass; at
each occupancy, the card's measured float32 and exp ceilings there. See
``csrc/sol_probe.cu`` for the exact semantics and the design.

An exp pass is ``x = exp(a * x - b[j])``. The sessions' coefficients
(:data:`PROBE_EXP`, the default) make it contract to exp's fixed point:
after one pass the output no longer depends on what went in, so comparing
the kernel with its plain version under them cannot tell a wrong pass
count or a wrong chunk. :func:`check_exp_coefs` gives coefficients under
which every pass, every multiply-add pass and every chunk moves the output
by far more than the tolerance. Both run the same kernel template: the
probes' coefficients as an immediate and constant memory, any others read
from the kernel's parameter, in an instance of their own.

- :func:`sol_probe` launches the kernel (through
  :func:`gsjax_torch.ops.kernels.launch`, counted as ``sol_probe``) for CUDA
  tensors and takes :func:`sol_probe_plain` for CPU tensors.
  It takes only the swept pairs :data:`SWEPT` at :data:`OCCUPANCIES`, each
  a compiled instance; :func:`sol_probe_info` reads an instance's
  registers, spills and resident warps on the card.
- :func:`sol_probe_plain`, plain torch, takes any pair.
- Both take ``exp_coefs``, ``(a, (b_0, ..., b_9))``: :data:`PROBE_EXP` or
  :func:`check_exp_coefs`.
- :func:`sol_probe_inputs` builds the (n_chunks, 8, 128) table from a
  ``tile_start``, padded as the sessions pad it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gsjax_torch.ops import kernels
from gsjax_torch.ops.cuda_composite import ATTR_W, PIX

LANES = 128  # pairs per chunk
MAX_EXP = 10  # exp offsets the kernel takes (csrc/sol_probe.cu)
# (k_ops, k_exp) of the sessions' sweeps: vpu k4 / k40, vpux f20e0 / f20e5 /
# f20e10 (vpux's w20e0, a while_loop A/B of the TPU kernel, is (20, 0))
SWEPT = ((4, 0), (40, 0), (20, 0), (20, 5), (20, 10))
# resident warps per SM of the instances: the first port's one block of 8
# warps, composite_bwd's 3 blocks and the forward kernels' 6
OCCUPANCIES = (8, 24, 48)

# float32 constants of the chains, rounded from the Python floats as JAX
# rounds them against a float32 array
_FMA_A = float(np.float32(1.0000001))


def _fma_b(j: int) -> float:
    return float(np.float32(0.3 + j * 1e-7))


def _f32(v) -> float:
    return float(np.float32(v))


# the sessions' exp coefficients: x = exp(f32(-1e-6) * x - f32(0.1 + j * 1e-7))
PROBE_EXP = (_f32(-1e-6), tuple(_f32(0.1 + j * 1e-7) for j in range(MAX_EXP)))


def check_exp_coefs(k_ops: int):
    """Exp coefficients under which the probe's output depends on every
    pass: ``a = -1``, so that a pass scales a change of its input by about
    the value it returns; ``b_0`` brings a chunk's first pass (input about
    1.5 + 0.3 ``k_ops``: the carry, the row and the multiply-add passes)
    to about 1, and ``b_j = -1 + 0.02 j`` keeps the later passes near
    exp(1 - x)'s fixed point 1, where that scale is 1, each with its own
    offset. A pass too few, a multiply-add pass too few or another chunk's
    row moves every non-empty tile's sum by more than 100 x the card
    tolerance's 2e-5 (``tests/test_torch_probes.py``); the values stay
    near 1 a lane, so float32 rounding stays as small as under the
    sessions' coefficients."""
    return (-1.0, (_f32(-(0.3 * k_ops + 1.5)),)
            + tuple(_f32(-1.0 + 0.02 * j) for j in range(1, MAX_EXP)))


def sol_probe_inputs(tile_start, seed: int = 0):
    """The probe's (n_chunks, 8, 128) float32 table for ``tile_start``,
    on its device. The sessions pad the pair count ``p`` by ``(-p) % 128 +
    128``; here ``p`` is ``tile_start[-1]``, the valid pairs, which is all
    any tile's window reads. Row 0 of each chunk (the only row the probe
    reads) is uniform in [0, 1) from a numpy seed, so that a comparison
    means something (gsjax's table is all zeros); rows 1-7 are zero."""
    p = int(tile_start[-1])
    n_chunks = (p + (-p) % LANES + LANES) // LANES
    row0 = np.random.default_rng(seed).uniform(0.0, 1.0, (n_chunks, LANES))
    table = torch.zeros((n_chunks, ATTR_W, LANES), dtype=torch.float32,
                        device=tile_start.device)
    table[:, 0] = torch.as_tensor(row0.astype(np.float32), device=tile_start.device)
    return table


def _check(tile_start, table):
    if tile_start.dtype != torch.int32 or tile_start.dim() != 1 or tile_start.numel() < 1:
        raise ValueError(f"tile_start must be a 1-d int32 (T + 1,) tensor, got "
                         f"{tile_start.dtype} {tuple(tile_start.shape)}")
    if (table.dtype != torch.float32 or table.dim() != 3 or table.shape[0] < 1
            or tuple(table.shape[1:]) != (ATTR_W, LANES)):
        raise ValueError(f"table must be float32 (n_chunks, {ATTR_W}, {LANES}), got "
                         f"{table.dtype} {tuple(table.shape)}")
    if tile_start.device != table.device:
        raise ValueError(f"inputs on several devices: {tile_start.device}, {table.device}")
    if not (tile_start.is_contiguous() and table.is_contiguous()):
        raise ValueError("tile_start and table must be contiguous")


def windows(tile_start):
    """Per tile: the first chunk of its 128-aligned window and the number
    of chunks (int64) — 1 for an empty tile whose start is unaligned."""
    ts = tile_start.to(torch.int64)
    c0 = torch.div(ts[:-1], LANES, rounding_mode="floor")
    nch = torch.div(ts[1:] - c0 * LANES + LANES - 1, LANES, rounding_mode="floor")
    return c0, nch


def _check_coefs(k_exp, exp_coefs):
    a, b = exp_coefs
    if len(b) != MAX_EXP or k_exp > MAX_EXP:
        raise ValueError(f"exp_coefs takes {MAX_EXP} offsets and k_exp <= {MAX_EXP}, got "
                         f"{len(b)} and {k_exp}")


@torch.no_grad()
def sol_probe_plain(tile_start, table, k_ops: int, k_exp: int, exp_coefs=PROBE_EXP):
    """Plain PyTorch version of the probe, for any ``k_ops >= 0`` and
    ``0 <= k_exp <= 10``:
    ``(T, 256)`` float32, every pixel of a tile holding the tile's sum over
    the 128 lanes. Vectorised over tiles; the carry is (T, 128), since
    the pixels of a tile compute the same values. Raises if a window
    reaches past the table (where the kernel writes NaN)."""
    _check(tile_start, table)
    if k_ops < 0 or k_exp < 0:
        raise ValueError("k_ops and k_exp must be >= 0")
    _check_coefs(k_exp, exp_coefs)
    exp_a, exp_b = exp_coefs
    c0, nch = windows(tile_start)
    num_tiles = c0.shape[0]
    x = torch.zeros((num_tiles, LANES), dtype=torch.float32, device=table.device)
    if num_tiles == 0:
        return x.new_zeros((0, PIX))
    if int((c0 + nch).max()) > table.shape[0]:
        raise ValueError("a tile's window reaches past the table")
    row0 = table[:, 0]
    for ci in range(int(nch.max())):
        live = torch.nonzero(ci < nch).squeeze(1)
        y = x[live] + row0[c0[live] + ci]
        for j in range(k_ops):
            y = y * _FMA_A + _fma_b(j)
        for j in range(k_exp):
            y = torch.exp(exp_a * y - exp_b[j])
        x[live] = y
    return x.sum(1, keepdim=True).expand(num_tiles, PIX).contiguous()


def _check_instance(k_ops, k_exp, warps_per_sm):
    if (k_ops, k_exp) not in SWEPT or warps_per_sm not in OCCUPANCIES:
        raise ValueError(f"(k_ops, k_exp) = ({k_ops}, {k_exp}) at {warps_per_sm} warps per "
                         f"SM has no kernel instance; swept pairs: {SWEPT}, occupancies: "
                         f"{OCCUPANCIES}")


def sol_probe(tile_start, table, k_ops: int, k_exp: int, exp_coefs=PROBE_EXP,
              warps_per_sm: int = 8):
    """The speed-of-light probe over ``tile_start`` (T + 1,) int32 and the
    (n_chunks, 8, 128) float32 ``table`` (:func:`sol_probe_inputs`) with
    ``k_ops`` multiply-add and ``k_exp`` exp passes per chunk (coefficients
    ``exp_coefs``), run at ``warps_per_sm`` resident warps per SM. Returns
    ``(T, 256)`` float32, which does not depend on the occupancy. Only the
    pairs of :data:`SWEPT` at :data:`OCCUPANCIES` have a compiled instance;
    any other raises, on every device. CUDA tensors launch the kernel on
    the current stream or raise; CPU tensors take :func:`sol_probe_plain`."""
    _check_instance(k_ops, k_exp, warps_per_sm)
    _check(tile_start, table)
    _check_coefs(k_exp, exp_coefs)
    dev = table.device
    if dev.type == "cpu":
        return sol_probe_plain(tile_start, table, k_ops, k_exp, exp_coefs)
    num_tiles = tile_start.numel() - 1
    out = torch.empty((num_tiles, PIX), dtype=torch.float32, device=dev)
    coefs = (ctypes.c_float * (1 + MAX_EXP))(exp_coefs[0], *exp_coefs[1])
    kernels.launch("sol_probe", tile_start, table, out, num_tiles, table.shape[0], k_ops, k_exp,
                   warps_per_sm, coefs)
    return out


def sol_probe_info(k_ops: int, k_exp: int, warps_per_sm: int = 8, check: bool = False):
    """The compiled instance's launch figures on the current card (the
    checking instance of an exp pair if ``check``): ``registers`` a
    thread, ``local_bytes`` a thread (spills; 0 when nothing spilled),
    ``blocks_per_sm`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    at its launch configuration), ``threads``, ``smem_bytes`` (dynamic
    shared memory a block asks for, which pins the occupancy) and
    ``resident_warps``, which equals ``warps_per_sm``. Needs CUDA."""
    _check_instance(k_ops, k_exp, warps_per_sm)
    if not torch.cuda.is_available():
        raise RuntimeError("sol_probe_info reads the card; CUDA is not available")
    v = (ctypes.c_int * 5)()
    err = kernels.load_library().gsjax_sol_probe_info(k_ops, k_exp, warps_per_sm, int(check), v)
    if err != 0:
        raise RuntimeError(f"sol_probe_info: CUDA error {err}")
    info = dict(zip(("registers", "local_bytes", "blocks_per_sm", "threads", "smem_bytes"), v))
    info["resident_warps"] = info["blocks_per_sm"] * info["threads"] // 32
    return info
