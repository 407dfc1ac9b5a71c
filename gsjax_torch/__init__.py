"""gsjax_torch — the PyTorch/CUDA port of gsjax for NVIDIA Hopper.

A second package beside ``gsjax``. It mirrors gsjax's module layout and
names so every function has an obvious counterpart, imports ``torch`` and
``numpy`` only (never ``jax``, never ``gsjax``), and replaces each Pallas
TPU kernel with a CUDA kernel written by hand for ``sm_90a``
(``gsjax_torch/csrc``). Everything gsjax does in plain jnp/XLA is plain
torch here.

Package layout (as in gsjax)
----------------------------
``gsjax_torch.utils``   math (SH, quaternions, covariances, cameras), system
``gsjax_torch.data``    COLMAP/Blender readers, PLY io, camera containers
``gsjax_torch.ops``     the renderer: projection, tile binning, compositing
                        (scan in torch, inference kernel in CUDA)
``gsjax_torch.models``  fixed-capacity Gaussian state, densification, PLY
``gsjax_torch.train``   train step, loop, checkpoints, budget probe, scene
                        loading; the training CLI (``python -m gsjax_torch.train``)
``gsjax_torch.eval``    PSNR, LPIPS (VGG16, gated weights)
``gsjax_torch.viewer``  the SIBR remote-viewer bridge, the local web viewer
``gsjax_torch.parallel`` ranks over torch.distributed: mesh, collectives,
                        gaussian-sharded tile strips, scenes side by side
``gsjax_torch.render``  offline-render CLI (``python -m gsjax_torch.render``);
                        beside it ``metrics``, ``full_eval``, ``view``,
                        ``render_bench``, ``viewer_bench``, ``bench``, ``probes``,
                        ``train_multiscene``, ``scaling_bench``

Entry points that create tensors take ``device=`` and default to
``"cuda"``; they raise when CUDA is absent. Tests pass ``device="cpu"``.
"""

__version__ = "0.1.0"

import torch as _torch

# The renderer's few matmuls (world->view point transforms in preprocess)
# are numerically load-bearing: TF32 keeps ~3 decimal digits and would move
# pixel means by whole pixels at 1080p. Full float32 is the package rule;
# both flags are also PyTorch's matmul default, set here explicitly.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
