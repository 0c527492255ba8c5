"""Fault tolerance of the port: ``supervisor.py`` (restart loop, straggler
and heartbeat trackers), a copy of ``repro.runtime_ft.supervisor``."""
