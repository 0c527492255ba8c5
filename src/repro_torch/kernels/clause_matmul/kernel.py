"""Clause evaluation as a matrix product: the CUDA kernel's wrapper and
its plain PyTorch twin.

The function is that of ``repro.kernels.clause_matmul.kernel``: for
``{0,1}`` actions ``A[NC, L2]`` and literals ``L[L2, B]``,
``viol = A @ (1 - L)`` and ``fired = (viol == 0) & (sum(A, 1) > 0)``, as
int32[NC, B].

``clause_matmul`` is the one entry point.  On CPU tensors it runs
``clause_matmul_plain``; on CUDA tensors it launches the int8
tensor-core kernel of ``csrc/clause_matmul.cu`` (two launches: narrow
both operands to int8, then the TMA-fed ``wgmma`` product) or raises;
there is no fallback between the two.  ``launches`` counts the CUDA
launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

# CUDA kernel launches made by clause_matmul (the plain twin never counts)
launches = 0


def clause_matmul_plain(
    actions: torch.Tensor,  # int32 {0,1}[NC, L2]
    lits: torch.Tensor,  # int32 {0,1}[L2, B]
) -> torch.Tensor:
    """The product in plain PyTorch -> int32[NC, B], on any device.

    float32 holds the violation counts exactly (they stay below 2**24);
    CUDA has no int32 matmul.  On the card TF32 would round them, so the
    twin refuses to run with TF32 enabled
    (``torch.backends.cuda.matmul.allow_tf32 = False`` is the default)."""
    if actions.is_cuda and (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "clause_matmul_plain needs exact float32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    viol = actions.to(torch.float32) @ (1 - lits).to(torch.float32)
    nonempty = actions.sum(dim=1) > 0
    return ((viol == 0) & nonempty[:, None]).to(torch.int32)


def _check_operands(actions, lits):
    if actions.device != lits.device:
        raise ValueError(
            f"actions is on {actions.device} but lits on {lits.device}"
        )
    if actions.dim() != 2 or lits.dim() != 2 or 0 in (
        *actions.shape, *lits.shape
    ):
        raise ValueError(
            f"actions [NC, L2] and lits [L2, B] must be non-empty matrices, "
            f"got {tuple(actions.shape)} and {tuple(lits.shape)}"
        )
    if actions.shape[1] != lits.shape[0]:
        raise ValueError(
            f"actions has {actions.shape[1]} literals but lits "
            f"{lits.shape[0]} rows"
        )


def clause_matmul(actions: torch.Tensor, lits: torch.Tensor) -> torch.Tensor:
    """int32[NC, B] clause outputs (1 = fired; empty clause -> 0).

    Both operands are cast to int32 as the reference casts them; CPU
    tensors run the plain twin, CUDA tensors launch the kernel or raise."""
    if actions.dtype != torch.int32:
        actions = actions.to(torch.int32)
    if lits.dtype != torch.int32:
        lits = lits.to(torch.int32)
    _check_operands(actions, lits)
    dev = lits.device
    if dev.type == "cpu":
        return clause_matmul_plain(actions, lits)
    if dev.type != "cuda":
        raise ValueError(
            f"clause_matmul runs on 'cpu' or 'cuda' tensors, got {dev}"
        )
    return _clause_matmul_cuda(actions, lits)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("clause_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.clause_matmul_launch.argtypes = [p, p, i, i, i, i, p, p, p, p, p]
    lib.clause_matmul_launch.restype = i
    lib.clause_matmul_k_step.argtypes = []
    lib.clause_matmul_k_step.restype = i
    return lib


@functools.cache
def _k_step() -> int:
    return _lib().clause_matmul_k_step()


def _clause_matmul_cuda(actions, lits):
    if not (actions.is_contiguous() and lits.is_contiguous()):
        raise ValueError("clause_matmul operands must be contiguous")
    nc, l2 = actions.shape
    b = lits.shape[1]
    dev = lits.device
    lib = _lib()
    step = _k_step()
    l2p = -(-l2 // step) * step  # scratch rows: the literal axis rounded up
    # one allocation, as rows of the output: the output int32[nc][b], then
    # the scratch int8 a8[nc][l2p], int8 nlt[b][l2p] and int32
    # nonempty[nc] from the first 64-byte boundary on.  The output is a
    # view of it and keeps the scratch (16 MB at the paper's width, a
    # quarter of the output) alive with it.
    scratch = (nc + b) * l2p + 4 * nc + 64
    block = torch.empty((nc + -(-scratch // (4 * b)), b), dtype=torch.int32,
                        device=dev)
    out = block[:nc]
    a8 = -(-(block.data_ptr() + 4 * nc * b) // 64) * 64
    err = lib.clause_matmul_launch(
        actions.data_ptr(), lits.data_ptr(), nc, l2, b, l2p, a8,
        a8 + nc * l2p, a8 + (nc + b) * l2p, out.data_ptr(), _build.stream(dev),
    )
    _build.raise_on("clause_matmul", err, "clause_matmul")
    _build.count_launches(__name__, 2)
    return out
