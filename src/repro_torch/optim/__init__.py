"""Optimiser of the LM scaffolding, the port of ``repro.optim``: AdamW
(``adamw.py``) and int8 gradient compression with error feedback
(``compress.py``).  The reference's ``compressed_psum`` is a collective
and is not ported yet."""
