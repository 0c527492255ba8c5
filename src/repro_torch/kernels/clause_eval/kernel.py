"""Dense bitpacked clause evaluation: the CUDA kernel's wrapper and its
plain PyTorch twin.

The function is that of ``repro.kernels.clause_eval.kernel``: for clause
k and batch word w, the AND of the packed literal rows l with
``actions[k, l] == 1``; a clause whose actions sum to 0 gives the word 0
(an empty clause outputs 0 at inference).  Actions are ``{0,1}``.

``clause_eval`` is the one entry point.  On CPU tensors it runs
``clause_eval_plain``; on CUDA tensors it launches the Hopper kernel of
``csrc/clause_eval.cu`` or raises; there is no fallback between the two.
``launches`` counts the CUDA launches and nothing else.  Packed words are
int32 tensors holding uint32 bit patterns (``core.bits``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build

# CUDA kernel launches made by clause_eval (the plain twin never counts)
launches = 0

# literals ANDed per step of the plain twin: its [NC, chunk, W] masked
# block stays near 64 MB at the paper's width (NC x W = 512k words)
_TWIN_ELEMENTS = 1 << 24


def clause_eval_plain(
    actions: torch.Tensor,  # int32 {0,1}[NC, L2]
    packed_lits: torch.Tensor,  # int32[L2, W]
) -> torch.Tensor:
    """The clause AND in plain PyTorch -> int32[NC, W], on any device.

    Torch has no bitwise-AND reduction, so each chunk of literals is
    masked into an ``[NC, chunk, W]`` block (all ones where the action is
    not 1) and halved with ``x[:, :h] & x[:, h:]``; the full ``[NC, L2,
    W]`` block is never built."""
    nc, l2 = actions.shape
    w = packed_lits.shape[1]
    chunk = 1 << max(0, (_TWIN_ELEMENTS // max(1, nc * w)).bit_length() - 1)
    chunk = min(chunk, 1 << (l2 - 1).bit_length())  # powers of two halve
    pad = -l2 % chunk  # padded literals have action 0: they mask to ones
    include = F.pad(actions == 1, (0, pad))
    lits = F.pad(packed_lits, (0, 0, 0, pad))
    acc = torch.full((nc, w), -1, dtype=torch.int32, device=actions.device)
    for c0 in range(0, l2 + pad, chunk):
        x = torch.where(include[:, c0:c0 + chunk, None], lits[c0:c0 + chunk], -1)
        while x.shape[1] > 1:
            h = x.shape[1] // 2
            x = x[:, :h] & x[:, h:]
        acc &= x[:, 0]
    nonempty = actions.sum(dim=1) > 0
    return torch.where(nonempty[:, None], acc, 0)


def _check_operands(actions, packed_lits):
    if packed_lits.dtype != torch.int32:
        raise TypeError(f"packed_lits must be int32, got {packed_lits.dtype}")
    if actions.device != packed_lits.device:
        raise ValueError(
            f"actions is on {actions.device} but packed_lits on "
            f"{packed_lits.device}"
        )
    if actions.dim() != 2 or packed_lits.dim() != 2 or 0 in (
        *actions.shape, *packed_lits.shape
    ):
        raise ValueError(
            f"actions [NC, L2] and packed_lits [L2, W] must be non-empty "
            f"matrices, got {tuple(actions.shape)} and "
            f"{tuple(packed_lits.shape)}"
        )
    if actions.shape[1] != packed_lits.shape[0]:
        raise ValueError(
            f"actions has {actions.shape[1]} literals but packed_lits "
            f"{packed_lits.shape[0]} rows"
        )


def clause_eval(actions: torch.Tensor, packed_lits: torch.Tensor) -> torch.Tensor:
    """int32[NC, W] clause output words (empty clause -> 0).

    ``actions`` is cast to int32 as the reference casts it; CPU tensors
    run the plain twin, CUDA tensors launch the kernel or raise."""
    actions = actions.to(torch.int32)
    _check_operands(actions, packed_lits)
    dev = packed_lits.device
    if dev.type == "cpu":
        return clause_eval_plain(actions, packed_lits)
    if dev.type != "cuda":
        raise ValueError(f"clause_eval runs on 'cpu' or 'cuda' tensors, got {dev}")
    return _clause_eval_cuda(actions, packed_lits)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("clause_eval")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.clause_eval_launch.argtypes = [p, p, i, i, i, p, p]
    lib.clause_eval_launch.restype = i
    return lib


def _clause_eval_cuda(actions, packed_lits):
    if not (actions.is_contiguous() and packed_lits.is_contiguous()):
        raise ValueError("clause_eval operands must be contiguous")
    nc, l2 = actions.shape
    w = packed_lits.shape[1]
    dev = packed_lits.device
    out = torch.empty((nc, w), dtype=torch.int32, device=dev)
    err = _lib().clause_eval_launch(
        actions.data_ptr(), packed_lits.data_ptr(), nc, l2, w, out.data_ptr(),
        _build.stream(dev),
    )
    _build.raise_on("clause_eval", err, "clause_eval")
    _build.count_launches(__name__, 1)
    return out
