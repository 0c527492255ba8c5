"""repro_torch: the PyTorch/CUDA port of ``repro`` (Runtime Tunable
Tsetlin Machines), laid out like it.  It imports torch and numpy, never
JAX and nothing of ``repro``; its entry points run on the CUDA card unless
the caller passes ``device="cpu"`` (``device.resolve_device``)."""

__version__ = "0.1.0"
