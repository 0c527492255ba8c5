"""Launchers of the port, after ``repro.launch``: the LM serving driver
(``serve.py``, ``python -m repro_torch.launch.serve``).  The training
driver, the mesh helpers and the dry-run are not ported yet."""
