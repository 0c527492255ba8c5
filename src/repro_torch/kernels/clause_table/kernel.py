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
``clause_table_shape`` is the launch's shape: the batch words per lane
and the blocks (one thread-block cluster) that share each output tile.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import clause_table_plain

# CUDA kernel launches made by clause_table (the plain twin never counts)
launches = 0

# The kernel's blocks have 16 warps; an H100 (132 SMs) keeps 224 to 264
# of them resident in clusters of 1 to 8 (cudaOccupancyMaxActiveClusters:
# 32 clusters of 7, 30 of 8), and 8 is the portable cluster size.
_WARPS = 16
_SMS = 132
_RESIDENT_BLOCKS = 224
_MAX_SPLIT = 8


def _split(n_classes: int, n_clauses: int, tiles_per_class: int) -> int:
    tiles = n_classes * tiles_per_class
    if tiles <= 0:
        return 1
    return max(1, min(_MAX_SPLIT, _RESIDENT_BLOCKS // tiles,
                      -(-n_clauses // _WARPS)))


def clause_table_shape(n_classes: int, n_clauses: int, w_words: int,
                       aligned: bool = True) -> tuple:
    """(vec, split) of a launch: the batch words each lane owns (a block's
    tile is ``32 * vec`` words) and the blocks of one cluster that share a
    (class, tile).  Four words per lane issue a quarter of the loads; they
    are taken when packed1's rows are 16-byte aligned (``aligned`` and
    ``W % 4 == 0``), when one-word tiles would not fill the card, and when
    four-word tiles, split, still give every SM a block.  The split is one
    when the tiles fill the card, else as many blocks as stay resident, at
    most 8 and at most one per 16 of the class's rows (a warp each)."""
    if (aligned and w_words % 4 == 0
            and n_classes * -(-w_words // 32) < _RESIDENT_BLOCKS):
        tiles = -(-w_words // 128)
        split = _split(n_classes, n_clauses, tiles)
        if n_classes * tiles * split >= _SMS:
            return 4, split
    return 1, _split(n_classes, n_clauses, -(-w_words // 32))


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
    lib.clause_table_launch.argtypes = [p, p, i, i, i, p, i, i, i, i, p, p]
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
    vec, split = clause_table_shape(M, C, w, packed1.data_ptr() % 16 == 0)
    err = _lib().clause_table_launch(
        idx.data_ptr(), pol.data_ptr(), M, C, lc, packed1.data_ptr(), n, w,
        vec, split, out.data_ptr(), _build.stream(dev),
    )
    _build.raise_on("clause_table", err, "clause_table")
    _build.count_launches(__name__, 1)
    return out
