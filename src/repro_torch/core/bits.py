"""Packed 32-bit words in PyTorch.

Packed words (bit-packed literals, clause words, class-selection masks)
are stored as ``torch.int32`` tensors holding uint32 bit patterns: torch's
``uint32`` has no shifts and no ``take`` on the CPU, while ``int32`` has
both.  The CUDA kernels read the same memory as ``uint32_t*``.

``int32`` ``>>`` is arithmetic (it copies the sign bit), so a logical
shift masks the copied bits off; no popcount op exists, so ``popcount``
is the SWAR bit count.  Numpy ``uint32`` arrays cross over with
``from_u32`` / ``to_u32``, which reinterpret the bits without copying
them on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def lshr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32-held uint32 words by a constant
    ``s`` in [0, 32)."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits (values
    at or above 2**31 wrap to negative explicitly)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32-held uint32 word -> int32 in [0, 32].

    The sign bit is counted apart, so the SWAR sums below never reach it
    and no int32 addition overflows."""
    y = x & 0x7FFFFFFF
    y = (y & 0x55555555) + ((y >> 1) & 0x55555555)
    y = (y & 0x33333333) + ((y >> 2) & 0x33333333)
    y = (y & 0x0F0F0F0F) + ((y >> 4) & 0x0F0F0F0F)
    y = y + (y >> 8)
    y = y + (y >> 16)
    return (y & 0x3F) + (x < 0).to(torch.int32)


def segmented_and_scan(sel: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Inclusive AND scan over axis 0 that restarts where ``start`` is
    True: a log-step Hillis-Steele scan whose combine ANDs only inside
    one segment, so it is exact in log2(I) vectorized rounds."""
    flag, val = start, sel
    d = 1
    while d < sel.shape[0]:
        v = val.clone()
        v[d:] = torch.where(flag[d:, None], val[d:], val[d:] & val[:-d])
        f = flag.clone()
        f[d:] = flag[d:] | flag[:-d]
        flag, val = f, v
        d *= 2
    return val


def from_u32(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy uint32 -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    t = torch.from_numpy(a.view(np.int32))
    return t if device is None else t.to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> numpy uint32 with the same bits."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)
