"""Roofline analysis of the port, after ``repro.analysis``: the H100's
rates and the roofline terms (``roofline.py``), the reference's
within-layer scan corrections (``corrections.py``, recorded by the dry
run, not added) and the tables of the dry-run records (``report.py``,
``python -m repro_torch.analysis.report``)."""
