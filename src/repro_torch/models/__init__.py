"""LM models of the port, after ``repro.models``: shared components
(``common.py``), the dense/MoE/VLM trunk (``dense.py``, ``moe.py``) and
the family API (``api.py``).  Plain PyTorch: the reference computes these
outside any Pallas kernel."""
