"""Multi-process bootstrap over ``torch.distributed``, rank helpers, and a
local launcher of ranks.

Counterpart of ``gsjax.parallel.multihost``. gsjax runs one process per
host and lets ``jax.distributed`` stitch the hosts' devices into one mesh;
the port runs one process per rank, each driving one device.

Bootstrap resolution order (first hit wins), gsjax's:

1. explicit arguments (``--dist_coordinator`` etc. from the CLI),
2. ``GSJAX_COORDINATOR`` / ``GSJAX_NUM_PROCESSES`` / ``GSJAX_PROCESS_ID``
   environment variables (how :func:`spawn_ranks` launches),
3. ``multihost`` (``--multihost`` / ``GSJAX_MULTIHOST=1``): ``env://``,
   the rendezvous a launcher such as ``torchrun`` sets up (``MASTER_ADDR``,
   ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) — the counterpart of
   ``jax.distributed.initialize()``'s auto-detection.

Each rank's device is ``cuda:(local_rank % device_count)``, where
``local_rank`` is ``LOCAL_RANK`` (set by torchrun) or the rank. The
backend is a rule, logged at start-up: NCCL when every rank of the host
has a card of its own (``LOCAL_WORLD_SIZE``, else the world size, at most
the device count); gloo when ranks share a card, and on the CPU. NCCL
refuses two ranks on one card, so a one-card machine runs several ranks
over gloo only.

Every rank must run the same collectives in the same order; per-rank work
(logging, evaluation, checkpoint writes) is gated on
:func:`is_main_process`.
"""

from __future__ import annotations

import datetime
import os
import signal
import socket
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from gsjax_torch.utils.system import resolve_device

# a collective that waits longer than this raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def local_rank(rank: Optional[int] = None) -> int:
    """This process's index among the ranks of its host: ``LOCAL_RANK``,
    else ``rank`` (default: the process group's rank, 0 without one)."""
    lr = _env_int("LOCAL_RANK")
    if lr is not None:
        return lr
    if rank is not None:
        return rank
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device="cuda", rank: Optional[int] = None) -> torch.device:
    """The device this rank drives: ``cuda:(local_rank % device_count)`` for
    a CUDA ``device``, the CPU for ``"cpu"``. Raises without CUDA."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", local_rank(rank) % torch.cuda.device_count())
    return dev


def backend_for(dev: torch.device, local_world: int) -> str:
    """NCCL when each of the host's ``local_world`` ranks has a card of its
    own, gloo otherwise (ranks sharing a card, or the CPU)."""
    if dev.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def maybe_initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    multihost: bool = False,
    device="cuda",
) -> bool:
    """Initialize ``torch.distributed`` if a multi-process run is requested.

    Returns True when running multi-process (after initialization, or if
    the process group already exists), False for a plain single-process
    run. ``coordinator`` is ``HOST:PORT`` (or a ``tcp://`` URL) of rank 0.
    Raises without CUDA unless ``device="cpu"``."""
    coordinator = coordinator or os.environ.get("GSJAX_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("GSJAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("GSJAX_PROCESS_ID")
    multihost = multihost or os.environ.get("GSJAX_MULTIHOST", "") == "1"
    if dist.is_initialized():
        return True

    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("multi-process runs need num_processes and process_id "
                             "alongside the coordinator address")
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world, rank = int(num_processes), int(process_id)
    elif multihost:
        if _env_int("WORLD_SIZE") is None or _env_int("RANK") is None:
            raise ValueError("multihost runs need the launcher's env:// rendezvous "
                             "(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets)")
        init = "env://"
        world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    else:
        return False
    dev = rank_device(device, rank)
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    backend = backend_for(dev, local_world)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    why = ("each rank has a card of its own" if backend == "nccl" else
           "the CPU" if dev.type == "cpu" else
           f"{local_world} ranks share {cards} card(s)")
    print(f"[dist] rank {rank}/{world} on {dev}: backend {backend} ({why})", flush=True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=TIMEOUT, **kw)
    return True


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_local_to_global(x, parts: int, index: int):
    """This rank's block of rows: ``x`` split into ``parts`` equal row
    blocks, block ``index`` (numpy array or tensor). In gsjax this
    assembles a global array from each process's rows; with one process
    per rank, a rank keeps its own rows and that is the whole of it."""
    n = x.shape[0]
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} equal blocks")
    blk = n // parts
    return x[index * blk:(index + 1) * blk]


def global_to_host_local(x, group=None) -> np.ndarray:
    """Gather a small tensor from every rank of ``group`` onto every rank,
    stacked along a new leading axis (rank order) — for metrics and
    logging only."""
    x = torch.as_tensor(x).detach()
    if not dist.is_initialized():
        return x.cpu().numpy()[None]
    if dist.get_backend(group) == "nccl":  # NCCL moves device memory only
        x = x.to(torch.device("cuda", torch.cuda.current_device()))
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return torch.stack([o.cpu() for o in out]).numpy()


# ---------------------------------------------------------------------------
# local launcher
# ---------------------------------------------------------------------------


def spawn_ranks(
    cmd: Sequence[str],
    world: int,
    timeout: float,
    env: Optional[dict] = None,
    cwd: Optional[str] = None,
    threads: Optional[int] = None,
) -> List[subprocess.CompletedProcess]:
    """Run ``cmd`` as ``world`` coordinated ranks on this host and wait.

    Each rank gets ``GSJAX_COORDINATOR`` (a free local port), its
    ``GSJAX_NUM_PROCESSES`` / ``GSJAX_PROCESS_ID``, ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE``, and the loopback interface for gloo and NCCL;
    ``threads`` sets ``OMP_NUM_THREADS``. When one rank fails the others
    would wait in their next collective, so the first nonzero exit, or
    ``timeout`` seconds, kills every rank (and its children), and this
    raises with the failing ranks' last lines. Returns each rank's exit
    code and output, in rank order."""
    with socket.socket() as s:  # a free port for rank 0's store
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, files = [], []
    t0 = time.monotonic()
    try:
        for r in range(world):
            e = dict(os.environ, **(env or {}))
            e.update(GSJAX_COORDINATOR=f"127.0.0.1:{port}", GSJAX_NUM_PROCESSES=str(world),
                     GSJAX_PROCESS_ID=str(r), LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world))
            e.setdefault("GLOO_SOCKET_IFNAME", "lo")
            e.setdefault("NCCL_SOCKET_IFNAME", "lo")
            if threads is not None:
                e["OMP_NUM_THREADS"] = str(threads)
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            files.append((out, err))
            procs.append(subprocess.Popen(list(cmd), env=e, cwd=cwd, stdout=out, stderr=err,
                                          start_new_session=True))
        failed = False
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            if any(c not in (None, 0) for c in codes):
                failed = True
                break
            if time.monotonic() - t0 > timeout:
                failed = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        for p in procs:
            p.wait()
    results = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        results.append(subprocess.CompletedProcess(p.args, p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    if failed or any(r.returncode for r in results):
        why = f"timed out after {timeout:.0f} s" if time.monotonic() - t0 > timeout else "failed"
        tails = "\n".join(f"--- rank {i} exit {r.returncode}:\n"
                          + "\n".join(r.stderr.splitlines()[-25:])
                          for i, r in enumerate(results) if r.returncode)
        raise RuntimeError(f"{world} ranks of {' '.join(cmd[:4])} ... {why}\n{tails}")
    return results

