"""Atomic checkpoints of the port: ``manager.py`` (``CheckpointManager``),
the port of ``repro.checkpoint.manager``."""
