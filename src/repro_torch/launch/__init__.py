"""Launchers of the port, after ``repro.launch``: the production and test
meshes (``mesh.py``), the LM server (``serve.py``, ``python -m
repro_torch.launch.serve``) and the training loop with checkpoint resume
(``train.py``, ``python -m repro_torch.launch.train``) and the dry run
(``dryrun.py``, ``python -m repro_torch.launch.dryrun``: every cell traced
on the ``meta`` device, its roofline on H100 constants)."""
