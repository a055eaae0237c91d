"""Entry points: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``; the plans and step builders
(``steps``) and the meshes (``mesh``)."""
