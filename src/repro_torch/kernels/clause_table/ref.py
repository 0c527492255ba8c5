"""The plain PyTorch twin of the ``clause_table`` kernel, and the general
clause-major executor it is a case of.

``clause_major_sums`` is ``repro.dist.tm_sharded``'s
``_local_plan_executor_clausemajor``: for clause row ``k`` the AND over
its ``Lc`` slots of the packed literal rows ``packed1[pad_idx[k, j]]``,
unpacked to bits and summed, times ``clause_pol[k]``, into row
``clause_class[k]`` of ``int32[n_out, W*32]``.  The reference gathers the
whole ``[rows, Lc, W]`` block; here clause rows go in chunks whose
gathered block stays near ``_TWIN_ELEMENTS`` words (about 64 MB), so it
runs at tm-xl width.  Index and class semantics follow the reference's
``take`` and scatter: an index in ``[-n, 0)`` counts from the end, one
outside ``[-n, n)`` reads as all ones; a class in ``[-n_out, 0)`` counts
from the end, one outside is dropped.

``clause_table_plain`` is the kernel's function: the class-major table of
one sharded tile (``idx [M, C, Lc]``, ``pol [M, C]``), rows of class
``m`` in ``idx[m]``.  Packed words are int32 tensors holding uint32 bit
patterns (``core.bits``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.tm import unpack_bits

# gathered words per chunk of the plain twin (int32: ~64 MB)
_TWIN_ELEMENTS = 1 << 24


def _wrap_index(index: torch.Tensor, n: int) -> torch.Tensor:
    """Negative indices in [-n, 0) count from the end (others stay)."""
    return torch.where((index < 0) & (index >= -n), index + n, index)


def scatter_classes_(out: torch.Tensor, contrib: torch.Tensor,
                     clause_class: torch.Tensor) -> torch.Tensor:
    """``out.at[clause_class].add(contrib)`` in place, with the reference
    scatter's index rules: a class in [-n_out, 0) counts from the end, one
    outside [-n_out, n_out) is dropped."""
    n_out = out.shape[0]
    cls = _wrap_index(clause_class.to(device=out.device, dtype=torch.int64), n_out)
    keep = (cls >= 0) & (cls < n_out)
    return out.index_add_(0, cls.clamp(0, max(n_out - 1, 0)), contrib * keep[:, None])


def _and_slots(pad_idx: torch.Tensor, packed1: torch.Tensor) -> torch.Tensor:
    """int32[K, W]: the AND over each row's ``Lc`` slots of the packed
    literal rows they name (all ones for ``Lc = 0``)."""
    K, lc = pad_idx.shape
    n, w = packed1.shape
    idx = _wrap_index(pad_idx.to(torch.int64), n)
    inb = (idx >= 0) & (idx < n)
    idx = idx.clamp(0, n - 1)
    span = 1 << max(0, (lc - 1).bit_length())  # slots padded to a power of 2
    rows = max(1, _TWIN_ELEMENTS // max(1, span * w))
    out = torch.empty((K, w), dtype=torch.int32, device=packed1.device)
    for k0 in range(0, K, rows):
        words = torch.where(
            inb[k0:k0 + rows, :, None], packed1[idx[k0:k0 + rows]], -1
        )  # [k, Lc, W]
        words = F.pad(words, (0, 0, 0, span - lc), value=-1)
        while words.shape[1] > 1:
            h = words.shape[1] // 2
            words = words[:, :h] & words[:, h:]
        out[k0:k0 + rows] = words[:, 0]
    return out


def clause_major_sums(
    pad_idx: torch.Tensor,  # int32[K, Lc]
    clause_class: torch.Tensor,  # int[K]
    clause_pol: torch.Tensor,  # int[K]
    packed1: torch.Tensor,  # int32[n, W]
    n_out: int,
) -> torch.Tensor:
    """int32[n_out, W*32] class sums of a clause-major include table."""
    K = pad_idx.shape[0]
    w = packed1.shape[1]
    dev = packed1.device
    pol = clause_pol.to(device=dev, dtype=torch.int32)
    out = torch.zeros((n_out, w * 32), dtype=torch.int32, device=dev)
    rows = max(1, _TWIN_ELEMENTS // max(1, 32 * w))  # unpacked bits per chunk
    for k0 in range(0, K, rows):
        sl = slice(k0, k0 + rows)
        bits = unpack_bits(_and_slots(pad_idx[sl], packed1))  # [k, W*32]
        scatter_classes_(out, bits * pol[sl, None], clause_class[sl])
    return out


def clause_table_plain(
    idx: torch.Tensor,  # int32[M, C, Lc]
    pol: torch.Tensor,  # int32[M, C]
    packed1: torch.Tensor,  # int32[n, W]
) -> torch.Tensor:
    """int32[M, W*32]: the ``clause_table`` kernel's function in plain
    PyTorch, on any device."""
    M, C, lc = idx.shape
    cls = torch.arange(M, device=packed1.device).repeat_interleave(C)
    return clause_major_sums(
        idx.reshape(M * C, lc), cls, pol.reshape(M * C), packed1, M
    )
