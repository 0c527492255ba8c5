"""Class sums of a clause-major include table: the CUDA kernel's wrapper.

The function is that of ``repro.dist.tm_sharded``'s
``_local_plan_executor_clausemajor`` on one sharded tile, whose clause
rows are grouped by class (``idx int32[M, C, Lc]``, ``pol int32[M, C]``;
polarities may be weighted): for each row the AND over its ``Lc`` slots
of the packed literal rows ``packed1[idx[m, c, j]]``, unpacked to bits,
times ``pol[m, c]``, summed over the class's rows into ``int32[M, W*32]``
(``ref.clause_table_plain``).

``clause_table`` is the one entry point.  On CPU tensors it runs the
plain twin; on CUDA tensors it launches the Hopper kernel of
``csrc/clause_table.cu`` or raises; there is no fallback between the two.
``launches`` counts the CUDA launches and nothing else.  Packed words are
int32 tensors holding uint32 bit patterns (``core.bits``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import clause_table_plain

# CUDA kernel launches made by clause_table (the plain twin never counts)
launches = 0


def _check_operands(idx, pol, packed1):
    for name, t in (("idx", idx), ("pol", pol), ("packed1", packed1)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != packed1.device:
            raise ValueError(
                f"{name} is on {t.device} but packed1 on {packed1.device}"
            )
    if idx.dim() != 3 or pol.shape != idx.shape[:2] or packed1.dim() != 2:
        raise ValueError(
            f"idx [M, C, Lc], pol [M, C] and packed1 [n, W] expected, got "
            f"{tuple(idx.shape)}, {tuple(pol.shape)} and {tuple(packed1.shape)}"
        )
    if 0 in packed1.shape:
        raise ValueError(f"packed1 must be non-empty, got {tuple(packed1.shape)}")


def clause_table(
    idx: torch.Tensor, pol: torch.Tensor, packed1: torch.Tensor
) -> torch.Tensor:
    """int32[M, W*32] class sums of a class-major clause table.

    CPU tensors run the plain twin, CUDA tensors launch the kernel or
    raise."""
    _check_operands(idx, pol, packed1)
    dev = packed1.device
    if dev.type == "cpu":
        return clause_table_plain(idx, pol, packed1)
    if dev.type != "cuda":
        raise ValueError(f"clause_table runs on 'cpu' or 'cuda' tensors, got {dev}")
    return _clause_table_cuda(idx, pol, packed1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("clause_table")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.clause_table_launch.argtypes = [p, p, i, i, i, p, i, i, p, p]
    lib.clause_table_launch.restype = i
    return lib


def _clause_table_cuda(idx, pol, packed1):
    if not (idx.is_contiguous() and pol.is_contiguous() and packed1.is_contiguous()):
        raise ValueError("clause_table operands must be contiguous")
    M, C, lc = idx.shape
    n, w = packed1.shape
    if M > 65535:
        raise ValueError(f"clause_table takes at most 65535 classes, got {M}")
    if max(M * C * max(lc, 1), n * w, M * w * 32) >= 1 << 31:
        raise ValueError("clause_table operands exceed 2^31 elements")
    dev = packed1.device
    out = torch.empty((M, w * 32), dtype=torch.int32, device=dev)
    if M == 0:
        return out
    err = _lib().clause_table_launch(
        idx.data_ptr(), pol.data_ptr(), M, C, lc, packed1.data_ptr(), n, w,
        out.data_ptr(), _build.stream(dev),
    )
    _build.raise_on("clause_table", err, "clause_table")
    _build.count_launches(__name__, 1)
    return out
