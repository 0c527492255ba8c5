"""Deterministic synthetic data of the port (``pipeline.py``): the
token-LM stream and the TM edge datasets.  The reference's ``shard_batch``
(placement on a mesh) is not ported yet; ``batch_to_device`` places a
batch on one device."""
