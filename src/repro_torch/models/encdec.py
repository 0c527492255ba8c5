"""Whisper-style encoder-decoder backbone (whisper-medium), the port of
``repro.models.encdec``.

The conv audio front end is a stub, as in the reference: ``input_specs``
provides precomputed frame embeddings [B, encoder_len, D], in the
parameters' dtype (``torch.einsum`` does not promote a mixed pair as
``jnp.einsum`` does).  Bidirectional encoder layers + causal decoder
layers with cross-attention; decode uses a self-attention KV cache, the
cross KV computed once at prefill (one einsum over the stacked decoder's
``[L, D, Hkv*hd]`` weights, where the reference ``vmap``s).  GELU is the
tanh form (``jax.nn.gelu``'s default).

``Server.generate`` sends no ``frames``, so ``prefill`` raises
``KeyError`` there as the reference's does; Whisper is driven through
``make_prefill_step`` and ``make_decode_step`` with ``frames``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, ShapeSpec
from ..tree import as_tree
from .common import (
    AttnParams,
    LMParams,
    attention_block,
    attn_param_specs,
    causal_lm_loss,
    checkpointed,
    embed_lookup,
    gqa_attention,
    heads_out,
    init_from_specs,
    lm_logits,
    meta,
    own_heads,
    rms_norm,
    stack_apply,
    stack_apply_collect,
    stack_apply_with_state,
    stack_specs,
)


def _gelu_mlp(p, hh):
    m_in = rms_norm(hh, p["mlp_norm"])
    u = F.gelu(torch.einsum("bsd,df->bsf", m_in, p["mlp"]["w_up"]), approximate="tanh")
    return hh + torch.einsum("bsf,fd->bsd", u, p["mlp"]["w_down"])


class Whisper:
    @staticmethod
    def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
        D, Fd = cfg.d_model, cfg.d_ff
        Le = cfg.n_encoder_layers or cfg.n_layers
        Ld = cfg.n_layers
        mlp = {"w_up": meta((D, Fd)), "w_down": meta((Fd, D))}
        enc_layer = {
            "attn": attn_param_specs(cfg)._asdict(),
            "attn_norm": meta((D,)),
            "mlp_norm": meta((D,)),
            "mlp": dict(mlp),
        }
        dec_layer = {
            "self_attn": attn_param_specs(cfg)._asdict(),
            "cross_attn": attn_param_specs(cfg)._asdict(),
            "self_norm": meta((D,)),
            "cross_norm": meta((D,)),
            "mlp_norm": meta((D,)),
            "mlp": dict(mlp),
        }
        return {
            "embed": meta((cfg.padded_vocab, D)),
            "enc_final_norm": meta((D,)),
            "dec_final_norm": meta((D,)),
            "encoder": stack_specs(enc_layer, Le),
            "decoder": stack_specs(dec_layer, Ld),
        }

    @staticmethod
    def init_params(cfg: ArchConfig, generator, device=None) -> LMParams:
        return init_from_specs(cfg, Whisper.param_specs(cfg), generator, device)

    # -- encoder ------------------------------------------------------------

    @staticmethod
    def encode(cfg: ArchConfig, params, frames: torch.Tensor, *, remat: bool):
        positions = torch.arange(frames.shape[1], device=frames.device)

        def layer_fn(p, hh):
            a_in = rms_norm(hh, p["attn_norm"])
            out, _ = attention_block(
                AttnParams(**p["attn"]), a_in, cfg, positions=positions, causal=False,
            )
            return _gelu_mlp(p, hh + out)

        fn = checkpointed(layer_fn) if remat else layer_fn
        h = stack_apply(fn, params["encoder"], frames)
        return rms_norm(h, params["enc_final_norm"])

    # -- decoder ------------------------------------------------------------

    @staticmethod
    def _cross(cfg, p, hh, enc_kv, heads=None):
        """Cross-attention against ``enc_kv`` (its heads ``heads``' KV heads:
        head-parallel over ``model``, as ``attention_block``)."""
        B, S, D = hh.shape
        hd = cfg.head_dim
        w, Hq, _ = own_heads(AttnParams(**p["cross_attn"]), cfg, heads)
        a_in = rms_norm(hh, p["cross_norm"])
        q = torch.einsum("bsd,dh->bsh", a_in, w.wq).reshape(B, S, Hq, hd)
        k, v = enc_kv
        out = gqa_attention(q, k, v, causal=False)
        return hh + heads_out(out.reshape(B, S, Hq * hd), w.wo, heads)

    @staticmethod
    def _enc_kv(cfg, p, enc: torch.Tensor, heads=None):
        B, Se, D = enc.shape
        w, _, Hkv = own_heads(AttnParams(**p["cross_attn"]), cfg, heads)
        hd = cfg.head_dim
        k = torch.einsum("bsd,dh->bsh", enc, w.wk).reshape(B, Se, Hkv, hd)
        v = torch.einsum("bsd,dh->bsh", enc, w.wv).reshape(B, Se, Hkv, hd)
        return k, v

    @staticmethod
    def _dec_layer(cfg, p, hh, enc, positions, heads=None):
        """-> (hh, fresh (k, v)) of one decoder layer over the whole
        sequence."""
        a_in = rms_norm(hh, p["self_norm"])
        out, kv = attention_block(
            AttnParams(**p["self_attn"]), a_in, cfg, positions=positions, causal=True,
            heads=heads,
        )
        hh = Whisper._cross(cfg, p, hh + out, Whisper._enc_kv(cfg, p, enc, heads), heads)
        return _gelu_mlp(p, hh), kv

    @staticmethod
    def loss(cfg: ArchConfig, params, batch):
        params = as_tree(params)
        enc = Whisper.encode(cfg, params, batch["frames"], remat=True)
        tokens = batch["tokens"]
        h = embed_lookup(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=h.device)

        def layer_fn(p, hh):
            return Whisper._dec_layer(cfg, p, hh, enc, positions)[0]

        h = stack_apply(checkpointed(layer_fn), params["decoder"], h)
        h = rms_norm(h, params["dec_final_norm"])
        return causal_lm_loss(lm_logits(h, params["embed"]), tokens, cfg.vocab)

    @staticmethod
    @torch.no_grad()
    def prefill(cfg: ArchConfig, params, batch, *, heads=None):
        """-> (last-position logits, {"k", "v": self KV [L, B, S, Hkv, hd],
        "ck", "cv": cross KV [L, B, encoder_len, Hkv, hd]}).  ``heads`` (a
        ``dist.sharding.HeadRanges``): the decoder's self- and
        cross-attention run head-parallel and the caches hold the rank's
        KV heads; the encoder runs whole."""
        params = as_tree(params)
        enc = Whisper.encode(cfg, params, batch["frames"], remat=False)
        tokens = batch["tokens"]
        h = embed_lookup(params["embed"], tokens)
        positions = torch.arange(tokens.shape[1], device=h.device)
        h, kv = stack_apply_collect(
            lambda p, hh: Whisper._dec_layer(cfg, p, hh, enc, positions, heads),
            params["decoder"], h,
        )
        h = rms_norm(h, params["dec_final_norm"])
        # cross-KV cached once for decode: one einsum over the stacked layers
        B, Se, _ = enc.shape
        L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        ca = params["decoder"]["cross_attn"]
        ws = [ca["wk"], ca["wv"]]
        if heads is not None and heads.kv is not None:
            cols = slice(heads.kv.start * hd, heads.kv.stop * hd)
            ws = [w[:, :, cols] for w in ws]
            Hkv = heads.kv.stop - heads.kv.start
        ck, cv = (torch.einsum("bsd,ldh->lbsh", enc, w).reshape(L, B, Se, Hkv, hd)
                  for w in ws)
        cache = {"k": kv[0], "v": kv[1], "ck": ck, "cv": cv}
        return lm_logits(h[:, -1], params["embed"]), cache

    @staticmethod
    @torch.no_grad()
    def decode(cfg: ArchConfig, params, cache, batch, *, heads=None):
        """One-token step; the self KV cache is written in place.
        ``heads``: as in ``prefill``."""
        params = as_tree(params)
        h = embed_lookup(params["embed"], batch["token"])
        pos = int(batch["pos"])
        positions = torch.full((1,), pos, device=h.device)

        def body(p, hh, c):
            kc, vc, ck, cv = c
            a_in = rms_norm(hh, p["self_norm"])
            out, (kc, vc) = attention_block(
                AttnParams(**p["self_attn"]), a_in, cfg, positions=positions,
                causal=True, cache_kv=(kc, vc), cache_pos=pos, heads=heads,
            )
            # cross-attention against the cached encoder KV
            hh = Whisper._cross(cfg, p, hh + out, (ck, cv), heads)
            return _gelu_mlp(p, hh), (kc, vc)

        h, (k_new, v_new) = stack_apply_with_state(
            body, params["decoder"], h, (cache["k"], cache["v"], cache["ck"], cache["cv"]),
        )
        h = rms_norm(h, params["dec_final_norm"])
        cache = {"k": k_new, "v": v_new, "ck": cache["ck"], "cv": cache["cv"]}
        return lm_logits(h[:, -1], params["embed"]), cache

    @staticmethod
    def input_specs(cfg: ArchConfig, shape: ShapeSpec):
        B = shape.global_batch
        frames = meta((B, cfg.encoder_len, cfg.d_model), torch.bfloat16)
        if shape.kind in ("train", "prefill"):
            return {"frames": frames, "tokens": meta((B, shape.seq_len), torch.int32)}
        return {"token": meta((B, 1), torch.int32), "pos": meta((), torch.int32)}

    @staticmethod
    def cache_specs(cfg: ArchConfig, shape: ShapeSpec):
        B, S = shape.global_batch, shape.seq_len
        L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        kv = meta((L, B, S, Hkv, hd), torch.bfloat16)
        ckv = meta((L, B, cfg.encoder_len, Hkv, hd), torch.bfloat16)
        return {"k": kv, "v": kv, "ck": ckv, "cv": ckv}
