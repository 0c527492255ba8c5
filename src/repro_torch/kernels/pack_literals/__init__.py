"""Literal packing of a feature block, 32 datapoints per word: the CUDA
kernel's wrapper and its plain twin (kernel)."""

from .kernel import pack_literals, pack_literals_plain

__all__ = ["pack_literals", "pack_literals_plain"]
