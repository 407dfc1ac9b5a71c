"""Filesystem, seeding and device helpers (reference: utils/system_utils.py:16-28)."""

from __future__ import annotations

import os

import torch


def search_for_max_iteration(folder):
    iters = [
        int(name.split("_")[-1])
        for name in os.listdir(folder)
        if name.startswith("iteration_")
    ]
    return max(iters) if iters else None


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument. Raises
    when CUDA is asked for and absent: a silent CPU fallback would run the
    plain versions of the kernels at a tiny fraction of the card's speed."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run the plain PyTorch versions of the kernels on the CPU"
        )
    return dev


def safe_state(quiet: bool = False, seed: int = 0):
    """Reference ``safe_state`` parity (utils/general_utils.py:112-133):
    wrap stdout so every line ends with a timestamp, silence under
    ``--quiet``, and seed python, numpy and torch."""
    import random
    import sys
    from datetime import datetime

    import numpy as np

    old_f = sys.stdout

    class F:
        def write(self, x):
            if not quiet:
                if x.endswith("\n"):
                    old_f.write(
                        x.replace(
                            "\n",
                            " [{}]\n".format(
                                datetime.now().strftime("%d/%m %H:%M:%S")
                            ),
                        )
                    )
                else:
                    old_f.write(x)

        def flush(self):
            old_f.flush()

    sys.stdout = F()
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
