"""The tile-based rasterizer: torch, and hand-written CUDA kernels.

1. :mod:`gsjax_torch.ops.projection` — per-Gaussian preprocess; its
   wrappers ``preprocess_infer`` and ``preprocess_bwd`` launch
   ``preprocess_infer.cu`` and ``preprocess_bwd.cu``.
2. :mod:`gsjax_torch.ops.binning` — (Gaussian, tile) pair expansion,
   depth sort, per-tile ranges.
3. :mod:`gsjax_torch.ops.composite` — the chunked-scan compositor and
   image assembly; :mod:`gsjax_torch.ops.cuda_composite` — the compositing
   kernels' wrappers, their plain versions and the reduction:
   ``composite_infer`` launches ``composite_infer.cu``, ``composite_fwd``
   and ``composite_fwd_check`` ``composite_fwd.cu``, ``composite_bwd`` and
   ``composite_bwd_counts`` ``composite_bwd.cu``.
4. :mod:`gsjax_torch.ops.rasterize` — ``render()`` and the naive oracle.

:mod:`gsjax_torch.ops.cuda_probe` — the speed-of-light probe; ``sol_probe``
launches ``sol_probe.cu``. :mod:`gsjax_torch.ops.kernels` — the kernel
library: it builds and loads every ``csrc/*.cu`` and makes every launch
(``kernels.launch``), counting it in ``launches()`` of ``utils.profiling``.
"""

from gsjax_torch.ops.rasterize import (
    RasterizeSettings,
    mark_visible,
    render,
    render_naive,
)

__all__ = ["RasterizeSettings", "mark_visible", "render", "render_naive"]
