"""Launchers of the port: the serving launcher (``python -m
repro_torch.launch.serve``), the training driver (``python -m
repro_torch.launch.train``) and their meshes (``launch.mesh``)."""
