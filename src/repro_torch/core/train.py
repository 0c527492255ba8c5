"""Vanilla Tsetlin Machine training (Granmo 2018), the port of
``repro.core.train``, bit-identical to it.

Faithful *online* semantics in ``train_batch``: samples update TA state
one after another.  For each sample:

  * target class y        -> clauses selected w.p. (T - clamp(v))/2T;
       positive clauses get Type I feedback, negative ones Type II
  * one random class != y -> clauses selected w.p. (T + clamp(v))/2T;
       positive clauses get Type II feedback, negative ones Type I

Type I  (combats false negatives / reinforces patterns):
   clause==1: literal==1 -> +1 w.p. (s-1)/s (1.0 if boost_true_positive)
              literal==0 -> -1 w.p. 1/s
   clause==0: all TAs    -> -1 w.p. 1/s
Type II (combats false positives):
   clause==1 & literal==0 & action==Exclude -> +1 (deterministic)

``train_batch_parallel`` is the summed-delta form: every sample's
feedback against the same pre-batch state, each clipped to [1, 2N] on
its own, then summed and clipped again.

Seeding contract (fold-in based; ``core.prng`` reproduces ``jax.random``):

  * ``sample_keys(key, n, offset)``: the sample at global position
    ``offset + i`` trains under ``fold_in(key, offset + i)``;
  * ``train_batch`` / ``train_batch_parallel`` consume samples at
    positions ``0..B-1`` of their call key;
  * ``fit_step(..., step=s)`` uses the call key ``fold_in(key, s)``;
  * ``fit`` runs epoch ``e``, batch ``b`` as step ``e * n_batches + b``
    and shuffles epoch ``e`` with ``fold_in(fold_in(key, _SHUFFLE), e)``.

The reference's jitted trainers donate the state; these return a new
tensor and leave the caller's alone.  Every function works on the device
of the state (a key on another device is moved there).  The feedback
functions take any leading batch of (sample, class row) in front of
their operands, so the summed-delta trainers evaluate a chunk of
samples' two touched rows at once: chunks keep the ``[n, 2, C, 2F]``
blocks near ``_CHUNK_TAS`` elements.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng
from .tm import TMConfig, clause_polarities, literals, predict

# Domain-separation tag for shuffle keys (outside the step-index range).
_SHUFFLE = 0x5F5F5F5F

# TA rows x literals per chunk of the summed-delta trainers (~16M: each
# int64 temporary of the draws stays near 128 MB at any width)
_CHUNK_TAS = 1 << 24


def sample_keys(key: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """Per-sample training keys ``[n, 2]`` for positions offset..offset+n-1."""
    idx = offset + torch.arange(n, dtype=torch.int64, device=key.device)
    return prng.fold_in(key, idx)


def validate_batch_capacity(n_rows: int, plan, what: str = "training batch"):
    """Raise the structured ``CapacityExceeded`` when a training batch
    blows through a negotiated ``CapacityPlan``'s batch words (32
    datapoints per bit-packed word).  Imported lazily: ``accel`` depends
    on ``core``, not the other way around."""
    if plan is None:
        return
    from ..accel.capacity import CapacityExceeded

    n_rows = int(n_rows)
    if n_rows > plan.batch_words * 32:
        raise CapacityExceeded(
            "batch_words", -(-n_rows // 32), plan.batch_words, what
        )


def feedback_thresholds(cfg: TMConfig) -> tuple:
    """(strengthen, weaken) probabilities as the float32 values a float32
    uniform is compared with: the reference compares against a Python
    float, which JAX rounds to float32."""
    s = cfg.specificity
    strengthen = 1.0 if cfg.boost_true_positive else (s - 1.0) / s
    return float(np.float32(strengthen)), float(np.float32(1.0 / s))


def _type_i_delta(
    cfg: TMConfig, key: torch.Tensor, clause_out: torch.Tensor, lits: torch.Tensor
) -> torch.Tensor:
    """Type I state delta for all clauses of one class.

    key [..., 2]; clause_out bool[..., C]; lits bool[..., 2F] ->
    int32[..., C, 2F]."""
    C, L = cfg.n_clauses, cfg.n_literals
    strengthen, weaken = feedback_thresholds(cfg)
    sub = prng.split(key)
    lit = lits[..., None, :]
    u = prng.uniform(sub[..., 0, :], (C, L))
    # clause fired
    inc = (lit & (u < strengthen)).to(torch.int32)
    dec_lit0 = (~lit & (u < weaken)).to(torch.int32)
    fired = inc - dec_lit0
    # clause did not fire: gentle push towards Exclude
    u2 = prng.uniform(sub[..., 1, :], (C, L))
    unfired = -(u2 < weaken).to(torch.int32)
    return torch.where(clause_out[..., None], fired, unfired)


def _type_ii_delta(
    cfg: TMConfig, clause_out: torch.Tensor, lits: torch.Tensor,
    actions: torch.Tensor,
) -> torch.Tensor:
    """Type II delta: push Excluded TAs of 0-literals towards Include when
    the clause (wrongly) fires. int32[..., C, 2F]."""
    push = clause_out[..., None] & ~lits[..., None, :] & ~actions
    return push.to(torch.int32)


def feedback_masks(
    cfg: TMConfig,
    key: torch.Tensor,  # [..., 2]
    sat: torch.Tensor,  # bool[..., C]  training-semantics outputs (empty -> 1)
    is_target,  # bool, or a bool tensor broadcast over the leading dims
):
    """Which clauses of a class row get Type I and which Type II feedback
    (bool[..., C] each; together the selected clauses): the clipped vote,
    ``p_sel`` in float32, and one selection uniform per clause."""
    T = cfg.threshold
    pol = clause_polarities(cfg, sat.device)
    v = (sat.to(torch.int32) * pol).sum(dim=-1, dtype=torch.int32).clamp(-T, T)
    is_target = torch.as_tensor(is_target, device=sat.device)
    p_sel = torch.where(
        is_target,
        (T - v).to(torch.float32) / (2.0 * T),
        (T + v).to(torch.float32) / (2.0 * T),
    )
    k_sel = prng.split(key)[..., 0, :]
    selected = prng.uniform(k_sel, (cfg.n_clauses,)) < p_sel[..., None]
    pos = pol > 0
    target = is_target[..., None]
    return (selected & torch.where(target, pos, ~pos),
            selected & torch.where(target, ~pos, pos))


def _feedback_from_clause_outputs(
    cfg: TMConfig,
    key: torch.Tensor,  # [..., 2]
    class_state: torch.Tensor,  # int32[..., C, 2F]
    actions: torch.Tensor,  # bool[..., C, 2F]  (class_state > N)
    sat: torch.Tensor,  # bool[..., C]  training-semantics outputs (empty -> 1)
    lits: torch.Tensor,  # bool[..., 2F]
    is_target,  # bool, or a bool tensor broadcast over the leading dims
) -> torch.Tensor:
    """New state for one class row given its precomputed clause outputs.

    The single source of the Type I/II feedback arithmetic: the dense
    trainers, the class-slice form (``sample_class_delta``) and the
    packed plain twin (``kernels.tm_train``) all run it, whatever computed
    ``sat``; the CUDA kernel repeats it per TA."""
    t1_mask, t2_mask = feedback_masks(cfg, key, sat, is_target)
    d1 = _type_i_delta(cfg, prng.split(key)[..., 1, :], sat, lits)
    d2 = _type_ii_delta(cfg, sat, lits, actions)
    delta = t1_mask[..., None] * d1 + t2_mask[..., None] * d2
    return (class_state + delta).clamp(1, 2 * cfg.n_states)


def _class_feedback(
    cfg: TMConfig,
    key: torch.Tensor,
    class_state: torch.Tensor,  # int32[..., C, 2F]
    lits: torch.Tensor,  # bool[..., 2F]
    is_target,
) -> torch.Tensor:
    """New state for class rows given one sample's literals each."""
    actions = class_state > cfg.n_states
    sat = (lits[..., None, :] | ~actions).all(dim=-1)  # train: empty -> 1
    return _feedback_from_clause_outputs(
        cfg, key, class_state, actions, sat, lits, is_target
    )


def _negatives(cfg: TMConfig, k_neg: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The random class != y of each sample (int64, y's shape)."""
    neg = prng.randint(k_neg, (), 0, cfg.n_classes - 1).to(torch.int64)
    y = y.to(device=neg.device, dtype=torch.int64)
    return torch.where(neg >= y, neg + 1, neg)


def _sample_rows(cfg: TMConfig, keys: torch.Tensor, yb: torch.Tensor):
    """For samples keyed ``keys [B, 2]`` with labels ``yb``: the two class
    rows each reads ``[B, 2]`` (target, negative), whether each row's
    update lands ``bool[B, 2]``, and their feedback keys ``[B, 2, 2]``
    (k_tgt, k_not).

    Labels index as the reference's int32 indices do: a negative label
    counts from the end, a read clamps into [0, M), and a target still
    outside [0, M) drops its update.  The negative class is drawn
    against the label as given."""
    M = cfg.n_classes
    sub = prng.split(keys, 3)  # k_neg, k_tgt, k_not
    y = yb.to(device=keys.device, dtype=torch.int32).to(torch.int64)
    y_idx = torch.where(y < 0, y + M, y)
    rows = torch.stack([y_idx.clamp(0, M - 1), _negatives(cfg, sub[:, 0], y)], dim=1)
    lands = torch.stack([(y_idx >= 0) & (y_idx < M), torch.ones_like(y, dtype=torch.bool)], dim=1)
    return rows, lands, sub[:, 1:]


_TARGET_THEN_NEGATIVE = (True, False)


def chunk_samples(cfg: TMConfig) -> int:
    """Samples per chunk of the summed-delta trainers."""
    return max(1, _CHUNK_TAS // (2 * cfg.n_clauses * cfg.n_literals))


def train_batch(
    cfg: TMConfig, state: torch.Tensor, key: torch.Tensor,
    xb: torch.Tensor, yb: torch.Tensor,
) -> torch.Tensor:
    """Sequential (online) updates over a batch. xb: {0,1}[B, F], yb:
    int[B].  One Python iteration per sample."""
    state = state.clone()
    dev = state.device
    keys = sample_keys(key.to(dev), xb.shape[0])
    rows, lands, row_keys = _sample_rows(cfg, keys, yb)
    lits = literals(xb.to(dev))
    for i, sample_lands in enumerate(lands.tolist()):
        for r, is_target in enumerate(_TARGET_THEN_NEGATIVE):
            if sample_lands[r]:
                m = rows[i, r]
                state[m] = _class_feedback(cfg, row_keys[i, r], state[m], lits[i], is_target)
    return state


def train_batch_parallel(
    cfg: TMConfig, state: torch.Tensor, key: torch.Tensor,
    xb: torch.Tensor, yb: torch.Tensor,
) -> torch.Tensor:
    """Data-parallel (summed-delta) batch update.

    Every sample's feedback against the SAME pre-batch state, each
    clipped to [1, 2N], summed, and clipped again: the reference's
    ``[B, M, C, 2F]`` delta tensor, formed here as the two touched rows
    per sample in chunks of samples and scatter-added (integer addition
    commutes, so the sum is the reference's)."""
    N, C, L = cfg.n_states, cfg.n_clauses, cfg.n_literals
    dev = state.device
    keys = sample_keys(key.to(dev), xb.shape[0])
    rows, lands, row_keys = _sample_rows(cfg, keys, yb)
    lits = literals(xb.to(dev))
    is_target = torch.tensor(_TARGET_THEN_NEGATIVE, device=dev)
    summed = torch.zeros_like(state)
    n = chunk_samples(cfg)
    for i0 in range(0, xb.shape[0], n):
        r = rows[i0:i0 + n]
        rows_state = state[r]  # [n, 2, C, 2F]
        new = _class_feedback(
            cfg, row_keys[i0:i0 + n], rows_state, lits[i0:i0 + n, None], is_target
        )
        delta = (new - rows_state) * lands[i0:i0 + n, :, None, None]
        summed.index_add_(0, r.reshape(-1), delta.reshape(-1, C, L))
    return (state + summed).clamp(1, 2 * N)


def sample_class_delta(
    cfg: TMConfig,
    class_state: torch.Tensor,  # int32[Mc, C, 2F]  a slice of class rows
    m_ids: torch.Tensor,  # int[Mc]  global class ids of those rows
    key: torch.Tensor,  # this sample's key (from ``sample_keys``)
    x: torch.Tensor,  # {0,1}[F]
    y,  # int label
) -> torch.Tensor:
    """One sample's summed-delta feedback restricted to a class-row slice:
    the target row from the sample's k_tgt stream, the sampled negative
    row from its k_not stream, every other row zero (both branches are
    evaluated for every row, as the class-sharded reference does)."""
    dev = class_state.device
    lits = literals(x.to(dev))
    sub = prng.split(key.to(dev), 3)
    y = torch.as_tensor(y, device=dev, dtype=torch.int64)
    neg = _negatives(cfg, sub[0], y)
    new_t = _class_feedback(cfg, sub[1], class_state, lits, True)
    new_n = _class_feedback(cfg, sub[2], class_state, lits, False)
    m = torch.as_tensor(m_ids, device=dev, dtype=torch.int64)[:, None, None]
    zero = torch.zeros_like(class_state)
    return torch.where(
        m == y, new_t - class_state, torch.where(m == neg, new_n - class_state, zero)
    )


def class_slice_delta(
    cfg: TMConfig,
    class_state: torch.Tensor,  # int32[Mc, C, 2F]  the rows of classes m0..m0+Mc-1
    m0: int,
    keys: torch.Tensor,  # [B, 2] the samples' keys (from ``sample_keys``)
    xb: torch.Tensor,  # {0,1}[B, F]
    yb: torch.Tensor,  # int[B]
) -> torch.Tensor:
    """The summed feedback of a batch restricted to a class-row slice:
    ``sum_i sample_class_delta(cfg, class_state, m0 + arange(Mc), keys[i],
    xb[i], yb[i])``, computed for the rows each sample touches only (its
    target ``y`` and its negative, when they fall in the slice), in
    chunks of (sample, row) pairs, and scatter-added (integer addition
    commutes, so the sum is the per-sample one)."""
    Mc, C, L = class_state.shape
    dev = class_state.device
    sub = prng.split(keys.to(dev), 3)  # k_neg, k_tgt, k_not
    y = yb.to(device=dev, dtype=torch.int64)
    neg = _negatives(cfg, sub[:, 0], y)
    rows = torch.stack([y, neg], dim=1).reshape(-1) - m0  # [2B] (target, negative)
    pick = torch.nonzero((rows >= 0) & (rows < Mc)).flatten()
    rows = rows[pick]
    row_keys = sub[:, 1:].reshape(-1, 2)[pick]
    is_target = (pick % 2) == 0
    lits = literals(xb.to(dev))[pick // 2]
    summed = torch.zeros_like(class_state)
    n = 2 * chunk_samples(cfg)
    for i0 in range(0, pick.numel(), n):
        r = rows[i0:i0 + n]
        rows_state = class_state[r]  # [n, C, 2F]
        new = _class_feedback(
            cfg, row_keys[i0:i0 + n], rows_state, lits[i0:i0 + n], is_target[i0:i0 + n]
        )
        summed.index_add_(0, r, new - rows_state)
    return summed


def fit_step(
    cfg: TMConfig,
    state: torch.Tensor,
    key: torch.Tensor,
    xb: torch.Tensor,
    yb: torch.Tensor,
    *,
    step: int,
    parallel: bool = False,
    plan=None,
) -> torch.Tensor:
    """One resumable training step: the batch trains under
    ``fold_in(key, step)``, so a (key, step, state) checkpoint resumes
    bit-exactly.  ``plan`` (an ``accel.CapacityPlan``) opts into the
    negotiated batch envelope (``CapacityExceeded``)."""
    validate_batch_capacity(xb.shape[0], plan)
    kb = prng.fold_in(key, step)
    f = train_batch_parallel if parallel else train_batch
    return f(cfg, state, kb, xb, yb)


def fit(
    cfg: TMConfig,
    state: torch.Tensor,
    key: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    epochs: int = 10,
    batch: int = 128,
    shuffle: bool = True,
    parallel: bool = False,
) -> torch.Tensor:
    """Epoch loop: epoch ``e`` batch ``b`` is ``fit_step(step=e *
    n_batches + b)``; a ragged tail of fewer than ``batch`` rows is not
    trained, as in the reference."""
    n = x.shape[0]
    n_batches = max(1, n // batch)
    k_shuffle = prng.fold_in(key, _SHUFFLE)
    for e in range(epochs):
        if shuffle:
            order = prng.permutation(prng.fold_in(k_shuffle, e), n)
        else:
            order = torch.arange(n)
        order = order.to(x.device)
        for b in range(n_batches):
            idx = order[b * batch:(b + 1) * batch]
            state = fit_step(
                cfg, state, key, x[idx], y[idx],
                step=e * n_batches + b, parallel=parallel,
            )
    return state


def accuracy(cfg: TMConfig, state: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> float:
    pred = predict(cfg, state, x.to(state.device))
    return float((pred == y.to(pred.device)).to(torch.float32).mean())
