"""Deterministic synthetic data of the port (``pipeline.py``): the
token-LM stream and the TM edge datasets; ``shard_batch`` places a batch
by its shardings on a mesh, ``batch_to_device`` on one device."""
