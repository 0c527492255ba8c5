"""Fused packed-TA training step: the CUDA kernel's wrapper and its plain
PyTorch twin, the port of ``repro.kernels.tm_train.kernel``.

One summed-delta batch update of the packed int8 state (``ops``),
bit-identical after unpacking to ``core.train.train_batch_parallel``
under the same call key:

  1. clause outputs for all classes and all samples at once, as packed
     words (``packed_clause_words``): the ``clause_eval`` kernel over the
     include actions (``packed >= 0``), with all ones ORed into the rows
     of empty clauses (an all-excluded clause outputs 1 in training, 0 at
     inference, where ``clause_eval`` serves);
  2. per sample, the feedback of its two touched class rows (target and
     sampled negative) from the threefry streams of the seeding contract
     (``core.train``), each sample's delta clipped against the pre-batch
     state, summed over the batch and clipped again in the centred int8
     domain: ``clip(state + d, 1, 2N) - (N+1) == clip(packed + d, -N,
     N-1)``.

``tm_train`` is step 2 given the clause words: on CPU tensors it runs
``tm_train_plain``, on CUDA tensors it launches ``csrc/tm_train.cu`` (two
launches: a prologue per sample that also draws each clause's selection
once, then the update, one thread per TA) or raises; there is no
fallback between the two.  The kernel compares each uniform with a
probability as an integer (``uniform_threshold``).  ``fused_train_batch`` is
both steps; on the CPU it is ``fused_train_batch_plain``.  ``launches``
counts the CUDA launches and nothing else.

The reference is fused XLA, not Pallas: the TPU's hardware generator
cannot give threefry's bits.  threefry2x32 is integer code, so the CUDA
kernel draws the same streams in registers, and draws only what a
selected clause reads.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ...core import prng
from ...core.tm import TMConfig, pack_literals
from ...core.train import (
    _feedback_from_clause_outputs,
    _sample_rows,
    chunk_samples,
    feedback_thresholds,
    sample_keys,
    validate_batch_capacity,
)
from ..clause_eval.kernel import clause_eval, clause_eval_plain
from .ops import packed_include_actions

# CUDA kernel launches made by tm_train (2 per call; the twin never counts)
launches = 0

# the update kernel's grid: literal tiles x clauses x classes
_MAX_GRID_YZ = 65535


def uniform_threshold(p) -> np.ndarray:
    """``ceil(p * 2**23)`` of float32 probabilities ``p``, clipped into
    [0, 2**23] (NaN: 0), as uint32: a uniform drawn from 32 random bits is
    ``u = (bits >> 9) * 2**-23`` exactly, so ``u < p`` iff ``bits >> 9 <
    uniform_threshold(p)``.  The product by a power of two is exact in
    float32, as it is in the kernel's prologue."""
    t = np.ceil(np.asarray(p, np.float32) * np.float32(1 << 23))
    return np.clip(np.nan_to_num(t, nan=0.0), 0, 1 << 23).astype(np.uint32)


def _clause_words(actions, packed_lits, evaluate):
    m, c, l2 = actions.shape
    flat = actions.reshape(m * c, l2)
    words = evaluate(flat.to(torch.int32), packed_lits)
    empty = torch.where(flat.any(dim=1), 0, -1).to(torch.int32)
    return (words | empty[:, None]).reshape(m, c, -1)


def packed_clause_words(actions: torch.Tensor, packed_lits: torch.Tensor) -> torch.Tensor:
    """Training-semantics clause outputs, 32 datapoints per word.

    actions: bool[M, C, 2F]; packed_lits: int32[2F, W] -> int32[M, C, W]
    (bit b of word w is the output for datapoint ``32w + b``; an
    all-excluded clause gives all ones).  The AND is ``clause_eval``:
    its kernel on CUDA tensors, its plain twin on CPU ones."""
    return _clause_words(actions, packed_lits, clause_eval)


def _pack_batch(xb: torch.Tensor) -> torch.Tensor:
    """{0,1}[B, F] -> int32[2F, ceil(B/32)]; pad rows are zeros, unused."""
    pad = -xb.shape[0] % 32
    return pack_literals(F.pad(xb.to(torch.uint8), (0, 0, 0, pad)))


def sample_bits(clause_words, packed_lits, rows, i):
    """Samples ``i``'s clause outputs on their touched rows ``rows [n, 2]``
    (bool[n, 2, C]) and their literals (bool[n, 2F]), read out of the
    packed words."""
    word, bit = i >> 5, i & 31
    sat = (clause_words[rows, :, word[:, None]] >> bit[:, None, None]) & 1
    lits = (packed_lits[:, word] >> bit) & 1
    return sat.bool(), lits.bool().T


def tm_train_plain(
    cfg: TMConfig,
    packed: torch.Tensor,  # int8[M, C, F, 2]
    clause_words: torch.Tensor,  # int32[M, C, W] (or [M*C, W])
    packed_lits: torch.Tensor,  # int32[2F, W]
    yb: torch.Tensor,  # int[B]
    key: torch.Tensor,  # the call key, [2]
) -> torch.Tensor:
    """The update in plain PyTorch -> int8[M, C, F, 2], on any device.

    Each sample's clause outputs and literals are read out of the packed
    words; the feedback is ``core.train``'s shared arithmetic on the two
    touched rows, widened to int32 for a chunk of samples at a time."""
    M, C, L, N = cfg.n_classes, cfg.n_clauses, cfg.n_literals, cfg.n_states
    dev = packed.device
    flat = packed.reshape(M, C, L).to(torch.int32)
    cw = clause_words.reshape(M, C, -1)
    B = yb.shape[0]
    rows, lands, row_keys = _sample_rows(cfg, sample_keys(key.to(dev), B), yb.to(dev))
    is_target = torch.tensor((True, False), device=dev)
    summed = torch.zeros_like(flat)
    n = chunk_samples(cfg)
    for i0 in range(0, B, n):
        i = torch.arange(i0, min(B, i0 + n), device=dev)
        r = rows[i0:i0 + n]
        sat, lits = sample_bits(cw, packed_lits, r, i)
        rows_state = flat[r] + (N + 1)  # the canonical domain
        new = _feedback_from_clause_outputs(
            cfg, row_keys[i0:i0 + n], rows_state, rows_state > N, sat,
            lits[:, None], is_target,
        )
        delta = (new - rows_state) * lands[i0:i0 + n, :, None, None]
        summed.index_add_(0, r.reshape(-1), delta.reshape(-1, C, L))
    new_flat = (flat + summed).clamp(-N, N - 1).to(torch.int8)
    return new_flat.reshape(M, C, cfg.n_features, 2)


def _check_operands(cfg, packed, clause_words, packed_lits, yb, key):
    M, C, L = cfg.n_classes, cfg.n_clauses, cfg.n_literals
    if packed.dtype != torch.int8 or packed.numel() != M * C * L:
        raise ValueError(
            f"packed must be int8 with {M}x{C}x{L} states, got "
            f"{packed.dtype} {tuple(packed.shape)}"
        )
    if clause_words.dtype != torch.int32 or packed_lits.dtype != torch.int32:
        raise TypeError("clause_words and packed_lits must be int32 words")
    w = packed_lits.shape[-1]
    if packed_lits.shape != (L, w) or clause_words.numel() != M * C * w:
        raise ValueError(
            f"packed_lits must be [{L}, W] and clause_words [{M * C}, W], "
            f"got {tuple(packed_lits.shape)} and {tuple(clause_words.shape)}"
        )
    if yb.dim() != 1 or yb.shape[0] > 32 * w:
        raise ValueError(
            f"labels must be [B] with B <= 32 * W = {32 * w}, got "
            f"{tuple(yb.shape)}"
        )
    if tuple(key.shape) != (2,):
        raise ValueError(f"key must hold two words, got {tuple(key.shape)}")
    devices = {t.device for t in (packed, clause_words, packed_lits, yb)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")


def tm_train(
    cfg: TMConfig,
    packed: torch.Tensor,
    clause_words: torch.Tensor,
    packed_lits: torch.Tensor,
    yb: torch.Tensor,
    key: torch.Tensor,
) -> torch.Tensor:
    """The packed state after one summed-delta update, given the batch's
    training clause words (``packed_clause_words``) and packed literals.
    CPU tensors run ``tm_train_plain``; CUDA tensors launch the kernel or
    raise."""
    _check_operands(cfg, packed, clause_words, packed_lits, yb, key)
    dev = packed.device
    if dev.type == "cpu":
        return tm_train_plain(cfg, packed, clause_words, packed_lits, yb, key)
    if dev.type != "cuda":
        raise ValueError(f"tm_train runs on 'cpu' or 'cuda' tensors, got {dev}")
    return _tm_train_cuda(cfg, packed, clause_words, packed_lits, yb, key)


@functools.cache
def _thresholds(cfg: TMConfig) -> tuple:
    """The kernel's integer (strengthen, weaken) thresholds of ``cfg``."""
    return tuple(int(t) for t in uniform_threshold(feedback_thresholds(cfg)))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("tm_train")
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.tm_train_launch.argtypes = [
        p, p, p, p, i, i, i, i, i, u, u, i, i, u, u, p, p, p,
    ]
    lib.tm_train_launch.restype = i
    return lib


def _tm_train_cuda(cfg, packed, clause_words, packed_lits, yb, key):
    M, C, L = cfg.n_classes, cfg.n_clauses, cfg.n_literals
    if not all(t.is_contiguous() for t in (packed, clause_words, packed_lits)):
        raise ValueError("tm_train operands must be contiguous")
    if M < 2 or M > _MAX_GRID_YZ or C > _MAX_GRID_YZ or C * L >= 1 << 32:
        raise ValueError(
            f"tm_train on CUDA takes 2 <= classes <= {_MAX_GRID_YZ}, clauses "
            f"<= {_MAX_GRID_YZ} and clauses x literals < 2**32; got "
            f"{M} x {C} x {L}"
        )
    dev = packed.device
    labels = yb.to(torch.int32).contiguous()
    out = torch.empty_like(packed)
    batch = labels.shape[0]
    if batch == 0:
        return out.copy_(packed)
    k0, k1 = (int(w) & prng.M32 for w in key.tolist())  # a CUDA key syncs
    strengthen, weaken = _thresholds(cfg)
    # per (sample, touched row): class, selection threshold and two keys
    # (6 words), the class again, and a selection bit per clause
    scratch = torch.empty(batch * 2 * (7 + -(-C // 32)), dtype=torch.int32, device=dev)
    err = _lib().tm_train_launch(
        packed.data_ptr(), clause_words.data_ptr(), packed_lits.data_ptr(),
        labels.data_ptr(), M, C, L, packed_lits.shape[1], batch, k0, k1,
        cfg.n_states, cfg.threshold, strengthen, weaken, scratch.data_ptr(),
        out.data_ptr(), _build.stream(dev),
    )
    _build.raise_on("tm_train", err, "tm_train")
    _build.count_launches(__name__, 2)
    return out


def fused_train_batch_plain(
    cfg: TMConfig, packed: torch.Tensor, key: torch.Tensor,
    xb: torch.Tensor, yb: torch.Tensor,
) -> torch.Tensor:
    """The plain PyTorch twin of ``fused_train_batch``: plain clause words
    (``clause_eval_plain``), then ``tm_train_plain``; on any device."""
    M, C, L = cfg.n_classes, cfg.n_clauses, cfg.n_literals
    plits = _pack_batch(xb.to(packed.device))
    actions = packed_include_actions(packed.reshape(M, C, L))
    cw = _clause_words(actions, plits, clause_eval_plain)
    return tm_train_plain(cfg, packed, cw, plits, yb, key)


def fused_train_batch(
    cfg: TMConfig, packed: torch.Tensor, key: torch.Tensor,
    xb: torch.Tensor, yb: torch.Tensor,
) -> torch.Tensor:
    """One summed-delta batch update on the packed int8 state.

    packed: int8[M, C, F, 2]; xb: {0,1}[B, F]; yb: int[B]; key: the call
    key -> int8[M, C, F, 2], a new tensor.  CPU tensors run the plain
    twin; CUDA tensors run the ``clause_eval`` and ``tm_train`` kernels
    or raise."""
    dev = packed.device
    if dev.type == "cpu":
        return fused_train_batch_plain(cfg, packed, key, xb, yb)
    if dev.type != "cuda":
        raise ValueError(f"fused_train_batch runs on 'cpu' or 'cuda' tensors, got {dev}")
    if xb.shape[0] == 0:
        return packed.clone()
    M, C, L = cfg.n_classes, cfg.n_clauses, cfg.n_literals
    plits = _pack_batch(xb.to(dev))
    cw = packed_clause_words(packed_include_actions(packed.reshape(M, C, L)), plits)
    return tm_train(cfg, packed, cw, plits, yb.to(dev), key)


def fused_fit_step(
    cfg: TMConfig,
    packed: torch.Tensor,
    key: torch.Tensor,
    xb: torch.Tensor,
    yb: torch.Tensor,
    *,
    step: int,
    plan=None,
) -> torch.Tensor:
    """Resumable fused step under the fold-in seeding contract (as
    ``core.train.fit_step``): the batch trains under ``fold_in(key,
    step)``, so (key, step, state) checkpoints move between this path and
    the reference.  ``plan`` opts into the negotiated batch envelope."""
    validate_batch_capacity(xb.shape[0], plan)
    return fused_train_batch(cfg, packed, prng.fold_in(key, step), xb, yb)
