"""Compressed inference from the decoded plan, as the eFPGA instruction
pipeline runs it: the CUDA kernel's wrapper and its plain PyTorch twin.

The function is that of ``repro.kernels.tm_interp.kernel``: per
instruction t, ``acc &= lits[lit_idx[t]]``; where ``last_flag[t] == 1``
the clause word's bits times ``pol[t]`` are added to class-sum row
``clip(cls[t], 0, m_cap - 1)`` and ``acc`` resets.  Instructions after
the last clause end never emit.

``tm_interp`` is the one entry point.  On CPU tensors it runs
``tm_interp_plain``; on CUDA tensors it launches the Hopper kernel of
``csrc/tm_interp.cu`` or raises; there is no fallback between the two.
``launches`` counts the CUDA launches and nothing else.  Packed words
are int32 tensors holding uint32 bit patterns (``core.bits``).

The kernel walks a clause table, ``clause_end`` (the emitting
instructions in order, ``ops.clause_ends``), built on the host with the
operands; a call that lacks it derives it on the device.  The kernel
takes ``m_cap`` up to 65535 and literal panels of fewer than 2^30 words
(``L2 * W``); a CUDA call beyond either raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ...core.bits import segmented_and_scan
from ...core.tm import unpack_bits
from .. import _build

# CUDA kernel launches made by tm_interp (the plain twin never counts)
launches = 0

# the kernel's grid.y holds the classes; literal rows are 32-bit byte offsets
MAX_M_CAP = 65535
MAX_LITERAL_WORDS = 1 << 30


def tm_interp_plain(
    lit_idx: torch.Tensor,  # int32[I_cap]
    last_flag: torch.Tensor,  # int32[I_cap]
    pol: torch.Tensor,  # int32[I_cap]
    cls: torch.Tensor,  # int32[I_cap]
    packed_lits: torch.Tensor,  # int32[L2, W]
    m_cap: int,
) -> torch.Tensor:
    """The interpreter in plain PyTorch -> int32[m_cap, W*32], on any
    device, vectorised over instructions: gather the literal words, a
    segmented AND scan gives every clause word at its end, the emitted
    words are unpacked and ``index_add_``-ed into their class rows."""
    l2 = packed_lits.shape[0]
    sel = packed_lits[lit_idx.clamp(0, l2 - 1).long()]  # [I, W]
    emit = last_flag == 1
    start = torch.cat([emit.new_ones(1), emit[:-1]])
    acc = segmented_and_scan(sel, start)
    ends = torch.nonzero(emit).flatten()
    contrib = unpack_bits(acc[ends]) * pol[ends, None]  # [clauses, W*32]
    sums = torch.zeros(
        (m_cap, packed_lits.shape[1] * 32), dtype=torch.int32,
        device=packed_lits.device,
    )
    return sums.index_add_(0, cls[ends].clamp(0, m_cap - 1), contrib)


def _check_operands(lit_idx, last_flag, pol, cls, packed_lits, m_cap):
    ops = {
        "lit_idx": lit_idx, "last_flag": last_flag, "pol": pol, "cls": cls,
        "packed_lits": packed_lits,
    }
    for name, t in ops.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != packed_lits.device:
            raise ValueError(
                f"{name} is on {t.device} but packed_lits on "
                f"{packed_lits.device}"
            )
    if lit_idx.dim() != 1 or lit_idx.shape[0] == 0 or any(
        t.shape != lit_idx.shape for t in (last_flag, pol, cls)
    ):
        raise ValueError(
            "lit_idx, last_flag, pol and cls must be equal non-empty 1-D "
            f"vectors, got {[tuple(t.shape) for t in (lit_idx, last_flag, pol, cls)]}"
        )
    if packed_lits.dim() != 2 or 0 in packed_lits.shape:
        raise ValueError(
            f"packed_lits must be a non-empty [L2, W], got "
            f"{tuple(packed_lits.shape)}"
        )
    if m_cap < 1:
        raise ValueError(f"m_cap must be positive, got {m_cap}")


def tm_interp(
    lit_idx: torch.Tensor,
    last_flag: torch.Tensor,
    pol: torch.Tensor,
    cls: torch.Tensor,
    packed_lits: torch.Tensor,
    *,
    m_cap: int,
    clause_end: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Compressed inference -> int32[m_cap, W*32] class sums.

    CPU tensors run the plain twin; CUDA tensors launch the kernel or
    raise.  ``clause_end`` is the clause table the kernel walks, built on
    the host with the operands: ``clause_ends(last_flag)`` on the
    operand's device.  When it is not given the wrapper derives it with
    ``torch.nonzero``, which waits for the device."""
    _check_operands(lit_idx, last_flag, pol, cls, packed_lits, m_cap)
    if clause_end is not None and (
        clause_end.dtype != torch.int32
        or clause_end.device != packed_lits.device
        or clause_end.dim() != 1
        or clause_end.numel() > lit_idx.numel()
    ):
        raise ValueError(
            "clause_end must be an int32 vector on the operands' device with "
            f"at most I_cap={lit_idx.numel()} entries, got {clause_end.dtype} "
            f"{tuple(clause_end.shape)} on {clause_end.device}"
        )
    dev = packed_lits.device
    if dev.type == "cpu":
        return tm_interp_plain(lit_idx, last_flag, pol, cls, packed_lits, m_cap)
    if dev.type != "cuda":
        raise ValueError(f"tm_interp runs on 'cpu' or 'cuda' tensors, got {dev}")
    if clause_end is None:
        clause_end = torch.nonzero(last_flag == 1).flatten().to(torch.int32)
    return _tm_interp_cuda(lit_idx, pol, cls, packed_lits, m_cap, clause_end)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("tm_interp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tm_interp_launch.argtypes = [p, i, p, i, p, p, p, i, i, i, p, p]
    lib.tm_interp_launch.restype = i
    return lib


def _tm_interp_cuda(lit_idx, pol, cls, packed_lits, m_cap, clause_end):
    dev = packed_lits.device
    l2, w = packed_lits.shape
    if m_cap > MAX_M_CAP or l2 * w >= MAX_LITERAL_WORDS:
        raise ValueError(
            f"the tm_interp kernel takes m_cap <= {MAX_M_CAP} and fewer than "
            f"{MAX_LITERAL_WORDS} literal words, got m_cap={m_cap} and "
            f"{l2} x {w} words"
        )
    tensors = (lit_idx, pol, cls, packed_lits, clause_end)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tm_interp operands must be contiguous")
    # the kernel stores every element, zeros where a class has no clauses
    out = torch.empty((m_cap, 32 * w), dtype=torch.int32, device=dev)
    err = _lib().tm_interp_launch(
        lit_idx.data_ptr(), lit_idx.numel(), clause_end.data_ptr(),
        clause_end.numel(), pol.data_ptr(), cls.data_ptr(),
        packed_lits.data_ptr(), l2, w, m_cap, out.data_ptr(),
        _build.stream(dev),
    )
    _build.raise_on("tm_interp", err, "tm_interp")
    _build.count_launches(__name__, 1)
    return out
