"""Deterministic synthetic data of the port: the TM edge datasets
(``pipeline.py``).  The token-LM half of the reference's pipeline
(``TokenStream``, ``shard_batch``) is not ported yet."""
