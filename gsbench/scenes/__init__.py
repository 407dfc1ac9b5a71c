"""Scene makers, one module a kind, found by the ``scene`` of a
configuration file: ``build(cfg, seed, device) -> dict`` with the seeded
parameters (``params``, ``active``, ``sh_degree``), the training poses
(``train_poses``), the viewer's poses (``view_poses``) and path
(``view_path(seed)``, an endless iterator of pose indices) and the scene
radius (``extent``). Everything is drawn from the seed, the gaussians on
the device in a few large calls."""
