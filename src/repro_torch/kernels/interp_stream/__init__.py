"""The paper's stream interpreter (Fig 4.4-4.6): the CUDA kernel's wrapper
and its plain twin (kernel) and a step-by-step oracle (ref)."""

from .kernel import interp_stream, interpret_stream_plain
from .ref import interpret_stream_ref

__all__ = ["interp_stream", "interpret_stream_plain", "interpret_stream_ref"]
