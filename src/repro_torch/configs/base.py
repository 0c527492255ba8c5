"""Architecture + shape configuration system, the port's own copy of
``repro.configs.base`` (plain frozen dataclasses, equal field by field).

Every assigned architecture is a frozen ``ArchConfig``; shapes are the four
assigned input-shape cells.  ``registry.py`` maps ``--arch <id>`` to these.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _pad_to(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm_xlstm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    attn_every: int = 6  # hybrid: shared attention block period
    window: int = 0  # sliding-window attention (0 = full causal)
    # enc-dec
    n_encoder_layers: int = 0
    encoder_len: int = 1500  # whisper frame count (stub frontend output)
    # vlm
    n_patches: int = 0  # stub ViT patch embedding count
    # numerics / optimizer
    dtype: str = "bfloat16"
    moment_dtype: str = "float32"
    rope_theta: float = 10000.0
    # distribution
    fsdp: bool = False  # shard big weight dims over the data axis too
    attn_tp: bool = True  # False: replicate attention weights (pure-DP
    # attention; right call when d_model/TP would be MXU-starved)
    # training memory: gradient-accumulation microbatches (activation
    # footprint scales with global_batch / microbatches)
    train_microbatches: int = 1
    # analysis: in the reference, replace layer-stack scans with Python
    # loops so XLA cost_analysis counts every layer.  The port's layer
    # loops are Python loops already, so nothing reads it here; the dry
    # run's u=1/u=2 variants (launch/dryrun.py ``_unit_variant``) set it
    # so their configs equal the reference's field for field
    analysis_unroll: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded so the vocab dim shards evenly (logits for
        padded rows are masked in the loss)."""
        return _pad_to(self.vocab, 256)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ArchConfig) -> Tuple[ShapeSpec, ...]:
    """long_500k requires a sub-quadratic decode path: recurrent-state
    (ssm/xlstm) or windowed-attention (hybrid) families only.  Pure
    full-attention archs skip it (documented in DESIGN.md §Arch-applicability
    and recorded as SKIP rows in EXPERIMENTS.md)."""
    if cfg.family in ("ssm_xlstm", "hybrid"):
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)


def shape_by_name(name: str) -> ShapeSpec:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
