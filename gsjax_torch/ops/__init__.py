"""The tile-based rasterizer (torch + one CUDA kernel).

1. :mod:`gsjax_torch.ops.projection` — per-Gaussian preprocess.
2. :mod:`gsjax_torch.ops.binning` — (Gaussian, tile) pair expansion,
   depth sort, per-tile ranges.
3. :mod:`gsjax_torch.ops.composite` — the chunked-scan compositor and
   image assembly; :mod:`gsjax_torch.ops.cuda_composite` — the CUDA
   inference compositing kernel and its plain version.
4. :mod:`gsjax_torch.ops.rasterize` — ``render()`` and the naive oracle.
"""

from gsjax_torch.ops.rasterize import (
    RasterizeSettings,
    mark_visible,
    render,
    render_naive,
)

__all__ = ["RasterizeSettings", "mark_visible", "render", "render_naive"]
