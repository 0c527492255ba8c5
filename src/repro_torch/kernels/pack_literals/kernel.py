"""Literal packing, 32 datapoints per word: the CUDA kernel's wrapper and
its plain PyTorch twin.

The function is that of ``repro.core.tm.pack_literals``: a feature block
``{0,1}[B, F]`` with ``B % 32 == 0`` becomes ``int32[2F, B // 32]`` words
(uint32 bit patterns, ``core.bits``), bit b of word ``[2k, w]`` set when
``x[32w + b, k]`` is nonzero (``to(bool)``: any nonzero byte is 1) and
word ``[2k + 1, w]`` its complement.

``pack_literals`` is the one entry point.  On CPU tensors it runs
``pack_literals_plain``, the eager code of ``core.tm.pack_literals``; on
CUDA tensors it launches the Hopper kernel of ``csrc/pack_literals.cu``
(one launch) or raises; there is no fallback between the two.
``launches`` counts the CUDA launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core import tm
from .. import _build

# CUDA kernel launches made by pack_literals (the plain twin never counts)
launches = 0


def pack_literals_plain(x: torch.Tensor) -> torch.Tensor:
    """The packing in plain PyTorch, on any device: ``core.tm``'s."""
    return tm.pack_literals(x)


def pack_literals(x: torch.Tensor) -> torch.Tensor:
    """uint8 ``[B, F]``, ``B % 32 == 0`` -> int32 ``[2F, B // 32]``
    packed literal words.  CPU tensors run the plain twin; CUDA tensors
    (contiguous) launch the kernel or raise."""
    if x.dim() != 2:
        raise ValueError(f"x must be [B, F], got {tuple(x.shape)}")
    if x.dtype != torch.uint8:
        raise TypeError(f"x must be uint8, got {x.dtype}")
    if x.shape[0] % 32:
        raise ValueError(
            f"batch {x.shape[0]} must be a multiple of 32 for bit packing"
        )
    dev = x.device
    if dev.type == "cpu":
        return pack_literals_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"pack_literals runs on 'cpu' or 'cuda' tensors, got {dev}")
    if not x.is_contiguous():
        raise ValueError("pack_literals needs a contiguous x")
    return _pack_literals_cuda(x)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("pack_literals")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pack_literals_launch.argtypes = [p, i, i, p, p]
    lib.pack_literals_launch.restype = i
    return lib


def _pack_literals_cuda(x: torch.Tensor) -> torch.Tensor:
    b, f = x.shape
    out = torch.empty((2 * f, b // 32), dtype=torch.int32, device=x.device)
    err = _lib().pack_literals_launch(
        x.data_ptr(), b, f, out.data_ptr(), _build.stream(x.device)
    )
    _build.raise_on("pack_literals", err, "pack_literals")
    _build.count_launches(__name__, 1)
    return out
