"""Launchers of the port, after ``repro.launch``: the production and test
meshes (``mesh.py``), the LM server (``serve.py``, ``python -m
repro_torch.launch.serve``) and the training loop with checkpoint resume
(``train.py``, ``python -m repro_torch.launch.train``).  The
dry-run is not ported yet."""
