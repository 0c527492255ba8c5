"""Popcount-bitplane inference over the decoded plan: the CUDA kernel's
wrapper and its plain PyTorch twin.

The function is that of ``repro.kernels.tm_popcount.kernel``: per
include, ``acc &= lits[lit_idx[t]]``; at a clause's last include
(``last_flag == 1``) the packed clause word is emitted and ``acc``
resets; emitted words are bit-transposed in 32x32 tiles and

    sums[m, 32w+b] = sum_p (popc(T & pos[p,m,c]) - popc(T & neg[p,m,c])) << p

against the polarity-bank bitplanes (``p`` only for 3-D weighted masks).

``popcount_program`` builds a program once and ``tm_popcount(program,
packed_lits)`` is the one entry point.  On CPU tensors it runs
``tm_popcount_plain``; on CUDA tensors it launches the Hopper kernel of
``csrc/tm_popcount.cu`` (two launches: compact clause words, then the
reduction over 32-clause chunks) or raises; there is no fallback between
the two.  The kernel reads the masks in clause space
(``clause_space_masks``): a clause reaches the sums only through the mask
bits at its last instruction, so gathering those bits gives the same
sums.  Its reduce walks, for each class, only the clause chunks where the
class's masks have a bit (``class_chunk_ranges``).  ``launches`` counts
the CUDA launches and nothing else.  All
packed words are int32 tensors holding uint32 bit patterns
(``core.bits``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.bits import lshr, popcount, segmented_and_scan, wrap_i32
from .. import _build

# CUDA kernel launches made by tm_popcount (the plain twin never counts)
launches = 0

# (shift, mask) rounds of the 32x32 bitplane transpose (Hacker's Delight
# 7-3, vectorized); applied to a reversed word axis so that out word b
# holds, at bit j, bit b of input word j.
_TRANSPOSE_ROUNDS = (
    (16, 0x0000FFFF),
    (8, 0x00FF00FF),
    (4, 0x0F0F0F0F),
    (2, 0x33333333),
    (1, 0x55555555),
)


def bit_transpose32(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Transpose 32x32 bit tiles held along ``axis`` (size 32) of words.

    ``out[..., b, ...]`` has bit j equal to bit b of ``x[..., j, ...]``.
    """
    x = torch.movedim(x, axis, -1).flip(-1)
    lead = x.shape[:-1]
    for s, m in _TRANSPOSE_ROUNDS:
        y = x.reshape(*lead, 32 // (2 * s), 2, s)
        a, b = y[..., 0, :], y[..., 1, :]
        t = (a ^ lshr(b, s)) & m
        x = torch.stack([a ^ t, b ^ (t << s)], dim=-2).reshape(*lead, 32)
    return torch.movedim(x.flip(-1), -1, axis)


def popcount_reduce(
    emit_words: torch.Tensor,  # int32[I, W], I % 32 == 0; 0 unless emitting
    mask_pos: torch.Tensor,  # int32[m_cap, I//32] or int32[P, m_cap, I//32]
    mask_neg: torch.Tensor,  # same shape as mask_pos
) -> torch.Tensor:
    """Emit words + polarity-bank bitplanes -> int32[m_cap, W*32] sums.

    2-D masks are unit-weight banks; 3-D masks are weight bitplanes,
    combined as ``sum_b ((pop(T & pos[b]) - pop(T & neg[b])) << b)``."""
    i, w = emit_words.shape
    tiles = bit_transpose32(emit_words.reshape(i // 32, 32, w), axis=1)
    # tiles[c, b, w] bit j = datapoint 32w+b's output of instruction 32c+j
    planes = mask_pos[None] if mask_pos.dim() == 2 else mask_pos
    negs = mask_neg[None] if mask_neg.dim() == 2 else mask_neg
    sums = None
    for b in range(planes.shape[0]):
        pos = popcount(tiles[None] & planes[b][:, :, None, None])
        neg = popcount(tiles[None] & negs[b][:, :, None, None])
        plane = (pos - neg).sum(dim=1, dtype=torch.int32) << b  # [m, 32, W]
        sums = plane if sums is None else sums + plane
    return sums.transpose(1, 2).reshape(planes.shape[1], w * 32)


def clause_space_masks(
    mask_pos: torch.Tensor,  # int32[(P,) m_cap, chunks], instruction space
    mask_neg: torch.Tensor,  # same shape as mask_pos
    clause_end: torch.Tensor,  # int[n]: each clause's last instruction
    n_chunks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polarity banks in instruction space -> the same banks in clause
    space, int32[(P,) m_cap, n_chunks] (default ``ceil(n / 32)`` words).

    Bit ``k`` of ``out[..., k >> 5]`` is bit ``end_k & 31`` of
    ``mask[..., end_k >> 5]``, 0 where that chunk lies past the masks.
    Clause ``k`` reaches the sums only through the mask bits at its last
    instruction ``end_k`` (the words of other instructions never emit), so
    reducing the compact clause words against these masks gives the sums
    of the instruction-space reduction, for any masks, also one that
    selects an instruction for two classes.  Runs on the device of the
    masks, without a host sync."""
    ends = clause_end.to(device=mask_pos.device, dtype=torch.int64)
    n = ends.numel()
    width = -(-n // 32)
    n_chunks = width if n_chunks is None else n_chunks
    if n_chunks < width:
        raise ValueError(f"{n} clauses need {width} chunks, not {n_chunks}")
    chunk = ends >> 5
    valid = (chunk >= 0) & (chunk < mask_pos.shape[-1])
    idx = torch.where(valid, chunk, 0)
    shift = (ends & 31).to(torch.int32)
    weights = torch.arange(32, device=ends.device, dtype=torch.int64)

    def gather(mask):
        bits = torch.where(valid, (mask[..., idx] >> shift) & 1, 0)
        bits = F.pad(bits, (0, 32 * n_chunks - n))
        bits = bits.reshape(*mask.shape[:-1], n_chunks, 32).to(torch.int64)
        return wrap_i32((bits << weights).sum(dim=-1))

    return gather(mask_pos), gather(mask_neg)


def class_chunk_ranges(
    cpos: torch.Tensor,  # int32[(P,) m_cap, chunks], clause space
    cneg: torch.Tensor,  # same shape as cpos
    n_chunks: Optional[int] = None,
) -> torch.Tensor:
    """Each class's half-open range of clause chunks, int32[m_cap, 2]:
    ``[lo, hi)`` spans every chunk among the first ``n_chunks`` (default
    all) where some plane of the class's ``cpos`` or ``cneg`` is non-zero;
    ``lo == hi == 0`` for a class with none.  The reduce walks only these
    chunks, so masks that are not class-major are reduced exactly too,
    over a wider range.  Runs on the device of the masks, without a host
    sync."""
    n_chunks = cpos.shape[-1] if n_chunks is None else n_chunks
    live = (cpos[..., :n_chunks] | cneg[..., :n_chunks]) != 0
    if live.dim() == 3:
        live = live.any(dim=0)
    live = F.pad(live, (0, 1))  # a dead column: no reduction is empty
    idx = torch.arange(n_chunks + 1, device=live.device)
    hi = torch.where(live, idx + 1, 0).amax(dim=1)
    lo = torch.where(live, idx, n_chunks).amin(dim=1)
    return torch.stack([torch.minimum(lo, hi), hi], dim=1).to(torch.int32)


def _pad_operands(lit_idx, last_flag, mask_pos, mask_neg):
    """Pad the instruction axis to a multiple of 32 (padding ANDs row 0
    and never emits) and the masks to the matching chunk count."""
    i_cap = lit_idx.shape[0]
    i_pad = -(-i_cap // 32) * 32
    lit_idx = F.pad(lit_idx, (0, i_pad - i_cap))
    last_flag = F.pad(last_flag, (0, i_pad - i_cap))
    pad_chunks = i_pad // 32 - mask_pos.shape[-1]
    return (
        lit_idx, last_flag,
        F.pad(mask_pos, (0, pad_chunks)), F.pad(mask_neg, (0, pad_chunks)),
    )


def tm_popcount_plain(
    lit_idx: torch.Tensor,  # int32[I_cap]
    last_flag: torch.Tensor,  # int32[I_cap]
    mask_pos: torch.Tensor,  # int32[(P,) m_cap, ceil(I_cap/32)]
    mask_neg: torch.Tensor,
    packed_lits: torch.Tensor,  # int32[L2, W]
) -> torch.Tensor:
    """The popcount algorithm in plain PyTorch -> int32[m_cap, W*32]: the
    twin of ``repro``'s ``tm_popcount_xla`` (gather, segmented AND scan,
    bit transpose, popcount), on any device."""
    lit_idx, last_flag, mask_pos, mask_neg = _pad_operands(
        lit_idx, last_flag, mask_pos, mask_neg
    )
    sel = packed_lits[lit_idx.long()]  # [I, W] literal select
    emit = last_flag == 1
    start = torch.cat([emit.new_ones(1), emit[:-1]])
    acc = segmented_and_scan(sel, start)  # packed clause outputs
    emit_words = torch.where(emit[:, None], acc, 0)
    return popcount_reduce(emit_words, mask_pos, mask_neg)


class PopcountProgram(NamedTuple):
    """A program of ``tm_popcount``, built once by ``popcount_program``.

    The instruction-space operands (the reference's and the plain twin's)
    and what the kernel reads: each clause's last instruction, padded to
    ``I_cap``, with ``n_clauses`` valid entries; the masks in clause space
    at the capacity width ``ceil(I_cap / 32)``; each class's range of
    clause chunks, int32 ``[m_cap, 2]``."""

    lit_idx: torch.Tensor  # int32[I_cap]
    last_flag: torch.Tensor  # int32[I_cap]
    mask_pos: torch.Tensor  # int32[(P,) m_cap, ceil(I_cap/32)]
    mask_neg: torch.Tensor
    clause_end: torch.Tensor  # int32[I_cap]
    n_clauses: int
    clause_masks: Tuple[torch.Tensor, torch.Tensor]
    class_ranges: torch.Tensor  # int32[m_cap, 2]

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """Every tensor of the program, in field order."""
        return (self.lit_idx, self.last_flag, self.mask_pos, self.mask_neg,
                self.clause_end, *self.clause_masks, self.class_ranges)

    def to(self, device) -> "PopcountProgram":
        """The program with each tensor moved to ``device``."""
        li, last, mp, mn, ends, cpos, cneg, ranges = (
            t.to(device) for t in self.tensors()
        )
        return PopcountProgram(
            li, last, mp, mn, ends, self.n_clauses, (cpos, cneg), ranges
        )


def popcount_program(
    lit_idx: torch.Tensor,  # int32[I_cap]
    last_flag: torch.Tensor,  # int32[I_cap]
    mask_pos: torch.Tensor,  # int32[(P,) m_cap, <= ceil(I_cap/32)]
    mask_neg: torch.Tensor,  # same shape as mask_pos
) -> PopcountProgram:
    """Check the instruction-space operands once and derive, on their
    device, the clause table, the clause-space masks and the class
    ranges the kernel reads.  Masks with fewer chunks than the
    instructions need are read as zero-padded."""
    ops = {"lit_idx": lit_idx, "last_flag": last_flag, "mask_pos": mask_pos,
           "mask_neg": mask_neg}
    dev = lit_idx.device
    for name, t in ops.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device} but lit_idx on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(
            f"tm_popcount runs on 'cpu' or 'cuda' tensors, got {dev}"
        )
    i_cap = lit_idx.shape[0]
    if lit_idx.dim() != 1 or last_flag.shape != lit_idx.shape or i_cap == 0:
        raise ValueError(
            f"lit_idx and last_flag must be equal non-empty 1-D vectors, got "
            f"{tuple(lit_idx.shape)} and {tuple(last_flag.shape)}"
        )
    if not lit_idx.is_contiguous():
        raise ValueError("lit_idx must be contiguous")
    if mask_pos.shape != mask_neg.shape or mask_pos.dim() not in (2, 3):
        raise ValueError(
            f"mask_pos/mask_neg must share a [m_cap, chunks] or [P, m_cap, "
            f"chunks] shape, got {tuple(mask_pos.shape)} and "
            f"{tuple(mask_neg.shape)}"
        )
    width = -(-i_cap // 32)
    if mask_pos.shape[-1] > width or 0 in mask_pos.shape:
        raise ValueError(
            f"masks of shape {tuple(mask_pos.shape)} do not fit "
            f"{i_cap} instructions ({width} chunks)"
        )
    ends = torch.nonzero(last_flag == 1).flatten().to(torch.int32)
    n = ends.numel()
    cmasks = clause_space_masks(mask_pos, mask_neg, ends, width)
    return PopcountProgram(
        lit_idx, last_flag, mask_pos, mask_neg, F.pad(ends, (0, i_cap - n)),
        n, cmasks, class_chunk_ranges(*cmasks, -(-n // 32)),
    )


def tm_popcount(
    program: PopcountProgram, packed_lits: torch.Tensor  # int32[L2, W]
) -> torch.Tensor:
    """Popcount-bitplane inference -> int32[m_cap, W*32] class sums.

    CPU tensors run the plain twin on the program's instruction-space
    operands; CUDA tensors launch the kernel on the rest."""
    dev = program.lit_idx.device
    if packed_lits.dtype != torch.int32:
        raise TypeError(f"packed_lits must be int32, got {packed_lits.dtype}")
    if packed_lits.device != dev:
        raise ValueError(
            f"packed_lits is on {packed_lits.device} but the program on {dev}"
        )
    if (packed_lits.dim() != 2 or 0 in packed_lits.shape
            or not packed_lits.is_contiguous()):
        raise ValueError(
            f"packed_lits must be a non-empty contiguous [L2, W], got "
            f"{tuple(packed_lits.shape)}"
        )
    if dev.type == "cpu":
        return tm_popcount_plain(*program[:4], packed_lits)
    return _tm_popcount_cuda(program, packed_lits)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("tm_popcount")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tm_popcount_launch.argtypes = [
        p, i, p, i, p, i, i, p, p, p, i, i, i, p, i, p, p,
    ]
    lib.tm_popcount_launch.restype = i
    return lib


def _tm_popcount_cuda(program: PopcountProgram, packed_lits: torch.Tensor):
    dev = packed_lits.device
    lit_idx, n_clauses = program.lit_idx, program.n_clauses
    cpos, cneg = program.clause_masks
    planes, m_cap = (1, cpos.shape[0]) if cpos.dim() == 2 else cpos.shape[:2]
    n_chunks = -(-n_clauses // 32)
    l2, w = packed_lits.shape
    # one allocation, as rows of the sums: the sums [m_cap][32 w], then
    # the compact clause words [w][k_pad] (the tail rows written 0)
    k_pad = 32 * max(n_chunks, 1)
    block = torch.empty((m_cap + k_pad // 32, 32 * w), dtype=torch.int32,
                        device=dev)
    out = block[:m_cap]
    err = _lib().tm_popcount_launch(
        lit_idx.data_ptr(), lit_idx.shape[0], program.clause_end.data_ptr(),
        n_clauses, packed_lits.data_ptr(), l2, w, cpos.data_ptr(),
        cneg.data_ptr(), program.class_ranges.data_ptr(), planes, m_cap,
        cpos.shape[-1],
        out.data_ptr() + 4 * out.numel(), k_pad, out.data_ptr(),
        _build.stream(dev),
    )
    _build.raise_on("tm_popcount", err, "tm_popcount")
    _build.count_launches(__name__, 2 if n_clauses else 1)
    return out
