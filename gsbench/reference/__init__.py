"""The plain reference that decides ``correct``: float32 PyTorch with TF32
off, independent of the program under test.

It imports nothing of ``gsjax_torch`` (nor ``jax`` or ``gsjax``); it
takes only the inputs the benchmark makes (the seeded parameters, the
cameras, the targets) and works out everything else again: the projected
splats, the (gaussian, tile) pairs and their depth order, the blend, the
loss, the gradients, Adam's update and the densification statistics.
Its arithmetic follows the semantics gsjax fixes (the reference 3DGS
rasterizer's), written as plain tensor code in blocks of tiles so that it
fits beside nothing on the card.

- :mod:`.cameras`: camera matrices from a pose.
- :mod:`.render`: preprocess, pairs, blend, its backward and the work
  counts (blended (pair, pixel) steps) the rooflines read.
- :mod:`.train`: the loss, Adam and one training step.
- :mod:`.compare`: the numbers compared and their limits.
"""


def no_tf32():
    """Plain float32 on the card: no TF32 in matrix products or
    convolutions (PyTorch's cuDNN default would allow it)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
