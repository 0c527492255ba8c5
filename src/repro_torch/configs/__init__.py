"""Architecture and shape configurations of the LM scaffolding, copied
from ``repro.configs`` (the port imports nothing of the reference)."""
