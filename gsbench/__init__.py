"""The benchmark of gsjax_torch, the PyTorch and CUDA port of gsjax (see
README.md). It imports neither ``jax`` nor ``gsjax``; its reference
(``gsbench.reference``) imports nothing of the program either."""
