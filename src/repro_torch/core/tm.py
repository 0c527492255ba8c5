"""Dense (vanilla) Tsetlin Machine model in PyTorch.

The port of ``repro.core.tm``.  For M classes, C clauses per class and F
Boolean features:

  * TA state tensor  S : int32[M, C, 2F] in [1, 2N]   (N = ``n_states``)
  * include action   A : bool [M, C, 2F]   A = S > N
  * literals are **interleaved**: slot k is feature k >> 1, complemented
    iff k & 1 == 1 (keeps within-clause include offsets strictly positive
    for the compressed encoding, see compress.py).

Clause semantics: in training an empty clause (no includes) outputs 1, at
inference 0.  Packed words are int32 tensors holding uint32 bit patterns
(``core.bits``).  Every function works on the device of its inputs.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .bits import wrap_i32


@dataclasses.dataclass(frozen=True)
class TMConfig:
    n_classes: int
    n_clauses: int          # clauses per class; polarity alternates +,-,+,-,...
    n_features: int         # Boolean features (literals = 2 * n_features)
    n_states: int = 128     # per-action state count N; S in [1, 2N]
    threshold: int = 15     # T
    specificity: float = 3.9  # s
    boost_true_positive: bool = True

    @property
    def n_literals(self) -> int:
        return 2 * self.n_features

    @property
    def n_tas(self) -> int:
        return self.n_classes * self.n_clauses * self.n_literals


def init_state(cfg: TMConfig, key=None, *, device="cpu") -> torch.Tensor:
    """TA states start on the Exclude side of the decision boundary (= N).
    ``key`` is unused (deterministic init), kept for the reference's
    signature."""
    del key
    shape = (cfg.n_classes, cfg.n_clauses, cfg.n_literals)
    return torch.full(shape, cfg.n_states, dtype=torch.int32, device=device)


def include_actions(cfg: TMConfig, state: torch.Tensor) -> torch.Tensor:
    """bool[M, C, 2F] — True where the TA action is Include."""
    return state > cfg.n_states


def state_from_actions(cfg: TMConfig, actions) -> torch.Tensor:
    """Minimal TA state tensor realizing the given include mask — the
    inverse of ``include_actions``."""
    a = torch.as_tensor(actions).to(torch.bool)
    return a.to(torch.int32) + cfg.n_states


def literals(x: torch.Tensor) -> torch.Tensor:
    """{0,1}[..., F] -> bool[..., 2F] with slot 2k = x_k, slot 2k+1 =
    NOT x_k."""
    x = x.to(torch.bool)
    return torch.stack([x, ~x], dim=-1).reshape(*x.shape[:-1], x.shape[-1] * 2)


def clause_outputs(
    cfg: TMConfig, actions: torch.Tensor, lits: torch.Tensor, *, training: bool
) -> torch.Tensor:
    """Clause outputs.  actions: bool[M, C, 2F]; lits: bool[..., 2F] ->
    bool[..., M, C] (a leading batch of literal rows is kept)."""
    lits = lits[..., None, None, :]
    # a clause fires iff every included literal is 1
    sat = (lits | ~actions).all(dim=-1)
    if training:
        return sat
    return sat & actions.any(dim=-1)


def clause_polarities(cfg: TMConfig, device=None) -> torch.Tensor:
    """int32[C]: +1 for even clause index, -1 for odd."""
    idx = torch.arange(cfg.n_clauses, device=device)
    return torch.where(idx % 2 == 0, 1, -1).to(torch.int32)


def class_sums(
    cfg: TMConfig, actions: torch.Tensor, lits: torch.Tensor, *, training: bool
) -> torch.Tensor:
    """int32[..., M] class sums for literal rows ``lits``."""
    c = clause_outputs(cfg, actions, lits, training=training).to(torch.int32)
    pol = clause_polarities(cfg, actions.device)
    return (c * pol).sum(dim=-1, dtype=torch.int32)


def batch_class_sums(
    cfg: TMConfig, state: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """int32[B, M] inference-semantics class sums (the oracle every fast
    path is held to).  Holds B x M x C x 2F booleans: chunk big batches."""
    return class_sums(
        cfg, include_actions(cfg, state), literals(x), training=False
    )


def batch_class_sums_weighted(
    cfg: TMConfig,
    state: torch.Tensor,
    x: torch.Tensor,
    weights: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """int32[B, M] class sums with per-clause vote weights int[M, C]; each
    clause votes ``weight * pol``.  ``None`` is ``batch_class_sums``."""
    actions = include_actions(cfg, state)
    pol = clause_polarities(cfg, state.device)[None, :]
    vote = pol if weights is None else weights.to(torch.int32) * pol
    c = clause_outputs(cfg, actions, literals(x), training=False)
    return (c.to(torch.int32) * vote).sum(dim=-1, dtype=torch.int32)


def predict(cfg: TMConfig, state: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched dense prediction. x: {0,1}[B, F] -> int32[B] class ids."""
    return batch_class_sums(cfg, state, x).argmax(dim=-1).to(torch.int32)


def predict_weighted(
    cfg: TMConfig,
    state: torch.Tensor,
    x: torch.Tensor,
    weights: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """Batched weighted prediction: argmax of the weighted class sums
    (the first class on ties, as ``jnp.argmax``)."""
    sums = batch_class_sums_weighted(cfg, state, x, weights)
    return sums.argmax(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Bitpacked inference (paper §3: 32 datapoints per machine word)
# ---------------------------------------------------------------------------

def pack_columns(bits: torch.Tensor) -> torch.Tensor:
    """{0,1}[B, L] -> int32[L, ceil(B / 32)] packed words; bit b of word w
    holds row 32w + b (rows past B pack as 0)."""
    B, L = bits.shape
    x = bits.to(torch.int64)
    if B % 32:  # a pad is a copy: only a ragged batch pays for it
        x = F.pad(x, (0, 0, 0, -B % 32))
    x = x.T.reshape(L, -1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return wrap_i32((x << shifts).sum(dim=-1))


def pack_literals(x: torch.Tensor) -> torch.Tensor:
    """{0,1}[B, F] with B % 32 == 0 -> int32[2F, B // 32] packed words;
    bit b of word w holds datapoint 32w + b."""
    if x.shape[0] % 32:
        raise ValueError(f"batch {x.shape[0]} must be a multiple of 32 for bit packing")
    return pack_columns(literals(x))


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int32 words [..., W] -> int32[..., W*32] of {0,1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32)


def packed_class_sums(
    cfg: TMConfig, state: torch.Tensor, packed_lits: torch.Tensor
) -> torch.Tensor:
    """Bitpacked dense inference: packed literals int32[2F, W] ->
    int32[W*32, M] class sums (equal to ``batch_class_sums`` for the
    packing of ``pack_literals``)."""
    actions = include_actions(cfg, state)  # [M, C, 2F]
    # acc[m, c, w] = AND over included k of packed_lits[k, w]; -1 is all ones
    masked = torch.where(actions[..., None], packed_lits, -1)  # [M, C, 2F, W]
    acc = masked[:, :, 0]
    for k in range(1, masked.shape[2]):
        acc = acc & masked[:, :, k]
    acc = torch.where(actions.any(dim=-1)[..., None], acc, 0)
    bits = unpack_bits(acc)  # [M, C, B]
    pol = clause_polarities(cfg, state.device)
    sums = (bits * pol[None, :, None]).sum(dim=1, dtype=torch.int32)
    return sums.T


def dense_model_bytes(cfg: TMConfig) -> int:
    """Uncompressed model footprint: 1 bit per TA action."""
    return (cfg.n_tas + 7) // 8
