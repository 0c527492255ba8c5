"""Optimiser of the LM scaffolding, the port of ``repro.optim``: AdamW
(``adamw.py``) and int8 gradient compression with error feedback
(``compress.py``; ``compressed_psum`` sums the members of an axis held
by one process)."""
