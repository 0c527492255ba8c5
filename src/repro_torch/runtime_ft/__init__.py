"""Fault tolerance of the port: ``supervisor.py`` (restart loop, straggler
and heartbeat trackers), a copy of ``repro.runtime_ft.supervisor``, and
``elastic.py`` (the new mesh after a loss of chips, a checkpoint
restored onto it)."""
