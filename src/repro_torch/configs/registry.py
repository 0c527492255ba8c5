"""``--arch <id>`` registry, the port's own copy of
``repro.configs.registry``: the 10 assigned architectures (exact dims from
the assignment) + reduced smoke variants.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from .base import ArchConfig

# --------------------------------------------------------------------------
# Assigned architectures (dims verbatim from the assignment block)
# --------------------------------------------------------------------------

ARCHS: Dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


STARCODER2_7B = _reg(ArchConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152,
    fsdp=True, train_microbatches=8,
))

STABLELM_12B = _reg(ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352,
    fsdp=True, train_microbatches=8,
))

DEEPSEEK_7B = _reg(ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400,
    fsdp=True, train_microbatches=8,
))

STABLELM_3B = _reg(ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304,
    fsdp=True, train_microbatches=4,
))

XLSTM_125M = _reg(ArchConfig(
    name="xlstm-125m", family="ssm_xlstm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    train_microbatches=2,
))

LLAMA4_MAVERICK = _reg(ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048,
    n_experts=128, top_k=1,
    moment_dtype="bfloat16",  # optimizer state budget (DESIGN.md §5)
    fsdp=True, train_microbatches=8,
))

MOONSHOT_16B = _reg(ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840,
    n_experts=64, top_k=6,
    fsdp=True, train_microbatches=8, attn_tp=False,
))

ZAMBA2_2P7B = _reg(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2,
    attn_every=6, window=4096,  # windowed shared attention => long_500k OK
    fsdp=True, train_microbatches=4,
))

WHISPER_MEDIUM = _reg(ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    n_encoder_layers=24, encoder_len=1500,
    train_microbatches=4,
))

INTERNVL2_26B = _reg(ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553,
    n_patches=256, fsdp=True, train_microbatches=8,
))


# --------------------------------------------------------------------------
# Reduced smoke variants (same family/topology, tiny dims) — used by
# per-arch smoke tests that run a real forward/train step on CPU.
# --------------------------------------------------------------------------

def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2 if cfg.family != "hybrid" else 4,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=512,
    )
    if cfg.is_moe:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.family == "hybrid":
        kw.update(ssm_state=8, ssm_headdim=16, ssm_expand=2, attn_every=2, window=64)
    if cfg.family == "encdec":
        kw.update(n_encoder_layers=2, encoder_len=16)
    if cfg.family == "vlm":
        kw.update(n_patches=4)
    return dataclasses.replace(cfg, **kw)


def get(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return smoke_variant(ARCHS[name[: -len("-smoke")]])
    return ARCHS[name]


def all_arch_names():
    return list(ARCHS.keys())
