"""Dense (and MoE) GQA decoder LM, the port of ``repro.models.dense``:
starcoder2-7b, stablelm-12b/3b, deepseek-7b, moonshot-v1-16b (MoE),
llama4-maverick (MoE), and the internvl2 backbone (early-fusion patch
embeddings).

Structure per layer (pre-norm):  x += attn(RMSNorm(x)); x += ffn(RMSNorm(x))
FFN is SwiGLU for dense configs, top-k MoE for MoE configs.  Layer
parameters stay stacked on a leading ``[L, ...]`` axis, as in the
reference; ``common.LMParams`` holds them, its ``state_dict()`` keys
the reference's tree paths joined by ``.``.  Training recomputes each layer in
the backward (``torch.utils.checkpoint``).

``loss``, ``prefill`` and ``decode`` take ``(cfg, params, batch)`` as the
reference's do, ``params`` an ``LMParams`` or its nested dict of tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, ShapeSpec
from ..tree import as_tree
from .common import (
    AttnParams,
    LMParams,
    Params,
    attention_block,
    attn_param_specs,
    causal_lm_loss,
    checkpointed,
    embed_lookup,
    init_from_specs,
    lm_logits,
    meta,
    rms_norm,
    stack_apply,
    stack_apply_collect,
    stack_apply_with_state,
    stack_specs,
)
from .moe import moe_ffn, moe_param_specs


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree's shapes and dtypes on the ``meta`` device."""
    D, Fd, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    layer: Dict[str, Any] = {
        "attn": attn_param_specs(cfg)._asdict(),
        "attn_norm": meta((D,)),
        "mlp_norm": meta((D,)),
    }
    if cfg.is_moe:
        layer["moe"] = moe_param_specs(cfg)
    else:
        layer["mlp"] = {
            "w_gate": meta((D, Fd)),
            "w_up": meta((D, Fd)),
            "w_down": meta((Fd, D)),
        }
    out: Dict[str, Any] = {
        "embed": meta((cfg.padded_vocab, D)),
        "final_norm": meta((D,)),
        "layers": stack_specs(layer, L),
    }
    if cfg.family == "vlm":
        out["patch_proj"] = meta((D, D))  # stub ViT output -> backbone space
    return out


def init_params(cfg: ArchConfig, generator: Union[int, torch.Generator],
                device=None) -> LMParams:
    """Random parameters (``common.init_from_specs``: normal, std 0.02,
    in each leaf's dtype: bf16, the MoE router fp32)."""
    return init_from_specs(cfg, param_specs(cfg), generator, device)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _ffn(p_layer: Dict[str, Any], x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.is_moe:
        return moe_ffn(p_layer["moe"], x, cfg)
    m = p_layer["mlp"]
    g = torch.einsum("bsd,df->bsf", x, m["w_gate"])
    u = torch.einsum("bsd,df->bsf", x, m["w_up"])
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, m["w_down"])


def _layer(p, h, cfg: ArchConfig, positions, cache_kv=None, cache_pos=None,
           heads=None):
    """-> (h, kv) of one layer (``heads``: ``attention_block``'s)."""
    a_in = rms_norm(h, p["attn_norm"])
    attn_out, kv = attention_block(
        AttnParams(**p["attn"]), a_in, cfg, positions=positions, causal=True,
        window=cfg.window, cache_kv=cache_kv, cache_pos=cache_pos, heads=heads,
    )
    h = h + attn_out
    f_in = rms_norm(h, p["mlp_norm"])
    return h + _ffn(p, f_in, cfg), kv


def _trunk(params, h, cfg: ArchConfig, positions, remat: bool):
    def layer_fn(p, hh):
        return _layer(p, hh, cfg, positions)[0]

    fn = checkpointed(layer_fn) if remat else layer_fn
    h = stack_apply(fn, params["layers"], h)
    return rms_norm(h, params["final_norm"])


def _embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig):
    h = embed_lookup(params["embed"], batch["tokens"])  # [B, St, D]
    if cfg.family == "vlm":
        x, w = batch["patches"], params["patch_proj"]
        dt = torch.promote_types(x.dtype, w.dtype)  # as jnp.einsum promotes
        patches = torch.einsum("bpd,de->bpe", x.to(dt), w.to(dt))
        h = torch.cat([patches.to(h.dtype), h], dim=1)  # early fusion
    return h


def loss(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor]):
    params = as_tree(params)
    h = _embed_inputs(params, batch, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    h = _trunk(params, h, cfg, positions, remat=True)
    if cfg.family == "vlm":
        h = h[:, cfg.n_patches:]  # loss on text positions only
    logits = lm_logits(h, params["embed"])
    return causal_lm_loss(logits, batch["tokens"], cfg.vocab)


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            heads=None):
    """-> (last-position logits [B, V], kv cache [L, B, S, Hkv, hd] x2).
    ``heads`` (a ``dist.sharding.HeadRanges``, one rank of a rank mesh):
    attention runs head-parallel and the cache holds the rank's KV heads."""
    params = as_tree(params)
    h = _embed_inputs(params, batch, cfg)
    positions = torch.arange(h.shape[1], device=h.device)
    h, caches = stack_apply_collect(
        lambda p, hh: _layer(p, hh, cfg, positions, heads=heads), params["layers"], h
    )
    h = rms_norm(h, params["final_norm"])
    logits = lm_logits(h[:, -1], params["embed"])
    return logits, {"k": caches[0], "v": caches[1]}


@torch.no_grad()
def decode(cfg: ArchConfig, params: Params, cache: Dict[str, torch.Tensor],
           batch: Dict[str, Any], *, heads=None):
    """One-token step.  batch: token [B, 1], pos (an int or a 0-d
    tensor).  The cache is donated: written in place and returned.
    ``heads``: as in ``prefill`` (the cache is the rank's heads)."""
    params = as_tree(params)
    h = embed_lookup(params["embed"], batch["token"])  # [B, 1, D]
    pos = int(batch["pos"])
    positions = torch.full((1,), pos, device=h.device)

    def layer_fn(p, hh, c):
        return _layer(p, hh, cfg, positions, cache_kv=c, cache_pos=pos, heads=heads)

    h, (k_new, v_new) = stack_apply_with_state(
        layer_fn, params["layers"], h, (cache["k"], cache["v"])
    )
    h = rms_norm(h, params["final_norm"])
    logits = lm_logits(h[:, -1], params["embed"])
    return logits, {"k": k_new, "v": v_new}


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B = shape.global_batch
    if shape.kind in ("train", "prefill"):
        S = shape.seq_len
        if cfg.family == "vlm":
            return {
                "patches": meta((B, cfg.n_patches, cfg.d_model), torch.bfloat16),
                "tokens": meta((B, S - cfg.n_patches), torch.int32),
            }
        return {"tokens": meta((B, S), torch.int32)}
    # decode
    return {"token": meta((B, 1), torch.int32), "pos": meta((), torch.int32)}


def cache_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    kv = meta((L, B, S, Hkv, hd), torch.bfloat16)
    return {"k": kv, "v": kv}
