"""Full-model assemblies for the recurrent families, the port of
``repro.models.recurrent_lm``:

* xLSTM LM (xlstm-125m): alternating mLSTM / sLSTM blocks, O(1)-state decode
* Zamba2 (zamba2-2.7b): Mamba2 backbone + ONE shared attention+MLP block
  applied every ``attn_every`` layers (window-limited KV ring buffer so
  long decode memory is bounded)

``prefill`` follows the reference: it rebuilds each layer's decode state
by a step scan over the prompt (one decode step per position and layer;
the chunked forms give Zamba2's outputs).  ``decode`` writes the state in
place (the reference donates it).  Reference caveats kept: ``XLSTM.decode``
ignores ``pos``; Zamba2's prefill keeps the last ``W = min(window, S)``
keys at slots ``0..W-1`` while decode writes slot ``pos mod W``, so when
``S % W != 0`` it overwrites a key that is not the oldest, and when
``S < window`` the decode window shrinks to ``S``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig, ShapeSpec
from ..tree import as_tree
from .common import (
    AttnParams,
    LMParams,
    NEG,
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
    rope,
    stack_apply,
    stack_apply_collect,
    stack_apply_with_state,
    stack_specs,
)
from .ssm import (
    CONV_K,
    ssm_cache_specs,
    ssm_decode_step,
    ssm_dims,
    ssm_forward,
    ssm_param_specs,
)
from .xlstm import (
    mlstm_decode_step,
    mlstm_forward,
    mlstm_param_specs,
    mlstm_state0,
    slstm_decode_step,
    slstm_forward,
    slstm_param_specs,
    slstm_state0,
    xlstm_dims,
)


def _scan_states(step, x: torch.Tensor, state0):
    """Fold ``step(x[:, t:t+1], state) -> (y [B,1,D], state)`` over the
    positions of ``x`` [B, S, D] -> (y [B, S, D], final state)."""
    state, ys = state0, []
    for t in range(x.shape[1]):
        y, state = step(x[:, t:t + 1], state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def all_states(state, heads):
    """A layer's recurrent state blocks [B, H_rank, ...] -> every head
    [B, H, ...], all-gathered over ``model`` (``heads.state`` set); else
    the state itself."""
    if heads is None or heads.state is None:
        return state
    from ..dist.collectives import all_gather  # deferred: dist imports models

    return tuple(all_gather(t, heads.mesh, "model", 1) for t in state)


def own_state(state, heads):
    """A layer's recurrent state of every head [B, H, ...] -> this rank's
    heads ``heads.state`` (dim 1); else the state itself."""
    if heads is None or heads.state is None:
        return state
    return tuple(t[:, heads.state] for t in state)


# ===========================================================================
# xLSTM LM
# ===========================================================================

class XLSTM:
    @staticmethod
    def n_pairs(cfg: ArchConfig) -> int:
        if cfg.n_layers % 2:
            raise ValueError(f"xLSTM needs an even n_layers, got {cfg.n_layers}")
        return cfg.n_layers // 2

    @staticmethod
    def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
        P = XLSTM.n_pairs(cfg)
        D = cfg.d_model
        pair = {
            "m": mlstm_param_specs(cfg),
            "s": slstm_param_specs(cfg),
            "m_norm": meta((D,)),
            "s_norm": meta((D,)),
        }
        return {
            "embed": meta((cfg.padded_vocab, D)),
            "final_norm": meta((D,)),
            "pairs": stack_specs(pair, P),
        }

    @staticmethod
    def init_params(cfg: ArchConfig, generator, device=None) -> LMParams:
        return init_from_specs(cfg, XLSTM.param_specs(cfg), generator, device)

    @staticmethod
    def _trunk(cfg, params, h, remat: bool):
        def pair_fn(p, hh):
            hh = hh + mlstm_forward(p["m"], rms_norm(hh, p["m_norm"]), cfg)
            hh = hh + slstm_forward(p["s"], rms_norm(hh, p["s_norm"]), cfg)
            return hh

        fn = checkpointed(pair_fn) if remat else pair_fn
        h = stack_apply(fn, params["pairs"], h)
        return rms_norm(h, params["final_norm"])

    @staticmethod
    def loss(cfg: ArchConfig, params, batch):
        params = as_tree(params)
        h = embed_lookup(params["embed"], batch["tokens"])
        h = XLSTM._trunk(cfg, params, h, remat=True)
        return causal_lm_loss(lm_logits(h, params["embed"]), batch["tokens"], cfg.vocab)

    @staticmethod
    @torch.no_grad()
    def prefill(cfg: ArchConfig, params, batch, *, heads=None):
        """-> (last-position logits, ((C, n, m), (c, n, m, h)) stacked over
        the pairs): each block runs its decode step over the prompt, so
        the outputs and the final states come from one scan.  ``heads``
        (a ``dist.sharding.HeadRanges`` with ``state`` set): the mLSTM
        states keep the rank's heads."""
        params = as_tree(params)
        h = embed_lookup(params["embed"], batch["tokens"])
        B, S, D = h.shape
        _, H, hd = xlstm_dims(cfg)

        def pair_fn(p, hh):
            ys, mc = _scan_states(
                lambda xt, c: mlstm_decode_step(p["m"], xt, c, cfg),
                rms_norm(hh, p["m_norm"]), mlstm_state0(B, H, hd, hh.device))
            hh = hh + ys
            ys, sc = _scan_states(
                lambda xt, c: slstm_decode_step(p["s"], xt, c, cfg),
                rms_norm(hh, p["s_norm"]), slstm_state0(B, D, hh.dtype, hh.device))
            return hh + ys, (own_state(mc, heads), sc)

        h, caches = stack_apply_collect(pair_fn, params["pairs"], h)
        h = rms_norm(h, params["final_norm"])
        return lm_logits(h[:, -1], params["embed"]), caches

    @staticmethod
    @torch.no_grad()
    def decode(cfg: ArchConfig, params, cache, batch, *, heads=None):
        """One-token step; ``batch["pos"]`` is not read (the state carries
        the position).  The cache is written in place and returned.
        ``heads``: as in ``prefill``; each pair's mLSTM state block is
        all-gathered over ``model`` where it is used, its heads kept."""
        params = as_tree(params)
        h = embed_lookup(params["embed"], batch["token"])  # [B,1,D]

        def pair_fn(p, hh, c):
            mc, sc = c
            y, mc = mlstm_decode_step(p["m"], rms_norm(hh, p["m_norm"]),
                                      all_states(mc, heads), cfg)
            mc = own_state(mc, heads)
            hh = hh + y
            y, sc = slstm_decode_step(p["s"], rms_norm(hh, p["s_norm"]), sc, cfg)
            return hh + y, (mc, sc)

        h, cache = stack_apply_with_state(pair_fn, params["pairs"], h, cache)
        h = rms_norm(h, params["final_norm"])
        return lm_logits(h[:, -1], params["embed"]), cache

    @staticmethod
    def input_specs(cfg: ArchConfig, shape: ShapeSpec):
        B = shape.global_batch
        if shape.kind in ("train", "prefill"):
            return {"tokens": meta((B, shape.seq_len), torch.int32)}
        return {"token": meta((B, 1), torch.int32), "pos": meta((), torch.int32)}

    @staticmethod
    def cache_specs(cfg: ArchConfig, shape: ShapeSpec):
        B = shape.global_batch
        P = XLSTM.n_pairs(cfg)
        D, H, hd = xlstm_dims(cfg)
        f32 = torch.float32
        mc = (meta((P, B, H, hd, hd), f32), meta((P, B, H, hd), f32),
              meta((P, B, H), f32))
        sc = (meta((P, B, D), f32), meta((P, B, D), f32), meta((P, B, D), f32),
              meta((P, B, D), torch.bfloat16))
        return (mc, sc)


# ===========================================================================
# Zamba2 hybrid
# ===========================================================================

class Zamba2:
    @staticmethod
    def n_groups(cfg: ArchConfig) -> int:
        if cfg.n_layers % cfg.attn_every:
            raise ValueError(
                f"attn_every={cfg.attn_every} must divide n_layers={cfg.n_layers}")
        return cfg.n_layers // cfg.attn_every

    @staticmethod
    def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
        G, E = Zamba2.n_groups(cfg), cfg.attn_every
        D, Fd = cfg.d_model, cfg.d_ff
        mamba_layer = {"ssm": ssm_param_specs(cfg), "norm": meta((D,))}
        shared = {
            "attn": attn_param_specs(cfg)._asdict(),
            "attn_norm": meta((D,)),
            "mlp_norm": meta((D,)),
            "mlp": {
                "w_gate": meta((D, Fd)),
                "w_up": meta((D, Fd)),
                "w_down": meta((Fd, D)),
            },
        }
        return {
            "embed": meta((cfg.padded_vocab, D)),
            "final_norm": meta((D,)),
            "mamba": stack_specs(stack_specs(mamba_layer, E), G),  # [G, E, ...]
            "shared": shared,  # ONE block, applied G times
        }

    @staticmethod
    def init_params(cfg: ArchConfig, generator, device=None) -> LMParams:
        return init_from_specs(cfg, Zamba2.param_specs(cfg), generator, device)

    @staticmethod
    def _mlp(shared, hh):
        m_in = rms_norm(hh, shared["mlp_norm"])
        m = shared["mlp"]
        g = torch.einsum("bsd,df->bsf", m_in, m["w_gate"])
        u = torch.einsum("bsd,df->bsf", m_in, m["w_up"])
        return hh + torch.einsum("bsf,fd->bsd", F.silu(g) * u, m["w_down"])

    @staticmethod
    def _qkv(cfg, shared, a_in, positions, heads):
        """-> (q, k, v) of the shared attention's heads (``heads``' own
        heads: ``common.own_heads``), RoPE applied, and its weights."""
        B, S, D = a_in.shape
        hd = cfg.head_dim
        w, Hq, Hkv = own_heads(AttnParams(**shared["attn"]), cfg, heads)
        q = torch.einsum("bsd,dh->bsh", a_in, w.wq).reshape(B, S, Hq, hd)
        k = torch.einsum("bsd,dh->bsh", a_in, w.wk).reshape(B, S, Hkv, hd)
        v = torch.einsum("bsd,dh->bsh", a_in, w.wv).reshape(B, S, Hkv, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        return q, k, v, w

    @staticmethod
    def _shared_attn(cfg, shared, hh, positions, window, heads=None):
        """-> (hh after the shared attention and MLP, (k, v)); with
        ``heads``, head-parallel over ``model`` (k and v: the rank's
        heads)."""
        a_in = rms_norm(hh, shared["attn_norm"])
        B, S, D = a_in.shape
        q, k, v, w = Zamba2._qkv(cfg, shared, a_in, positions[None], heads)
        out = gqa_attention(q, k, v, causal=True, window=window)
        out = heads_out(out.reshape(B, S, q.shape[2] * cfg.head_dim), w.wo, heads)
        return Zamba2._mlp(shared, hh + out), (k, v)

    @staticmethod
    def _trunk(cfg, params, h, remat: bool):
        positions = torch.arange(h.shape[1], device=h.device)

        def mamba_fn(p, hx):
            return hx + ssm_forward(p["ssm"], rms_norm(hx, p["norm"]), cfg)

        mfn = checkpointed(mamba_fn) if remat else mamba_fn

        def group_fn(g_params, hh):
            hh = stack_apply(mfn, g_params, hh)
            return Zamba2._shared_attn(cfg, params["shared"], hh, positions,
                                       cfg.window)[0]

        gfn = checkpointed(group_fn) if remat else group_fn
        h = stack_apply(gfn, params["mamba"], h)
        return rms_norm(h, params["final_norm"])

    @staticmethod
    def loss(cfg: ArchConfig, params, batch):
        params = as_tree(params)
        h = embed_lookup(params["embed"], batch["tokens"])
        h = Zamba2._trunk(cfg, params, h, remat=True)
        return causal_lm_loss(lm_logits(h, params["embed"]), batch["tokens"], cfg.vocab)

    @staticmethod
    @torch.no_grad()
    def prefill(cfg: ArchConfig, params, batch, *, heads=None):
        """Prefill producing decode caches: each mamba layer's output from
        the chunked form and its state from a decode-step scan over the
        prompt, and the shared attention's last ``W`` keys and values.
        ``heads`` (a ``dist.sharding.HeadRanges``): the shared attention
        runs head-parallel, and the ring buffer and the SSM states keep
        the rank's heads."""
        params = as_tree(params)
        h = embed_lookup(params["embed"], batch["tokens"])
        B, S, D = h.shape
        W = min(cfg.window or S, S)
        positions = torch.arange(S, device=h.device)
        d_inner, H, P_, N = ssm_dims(cfg)

        def m_step(p, hx):  # output by the chunked form, state by a step scan
            x_in = rms_norm(hx, p["norm"])
            y = ssm_forward(p["ssm"], x_in, cfg)
            c0 = (
                torch.zeros((B, CONV_K - 1, d_inner + 2 * N), dtype=hx.dtype,
                            device=hx.device),
                torch.zeros((B, H, N, P_), dtype=torch.float32, device=hx.device),
            )
            _, (conv, state) = _scan_states(
                lambda xt, c: ssm_decode_step(p["ssm"], xt, c, cfg), x_in, c0)
            return hx + y, (conv, *own_state((state,), heads))

        def group_fn(g_params, hh):
            hh, m_caches = stack_apply_collect(m_step, g_params, hh)
            hh, (k, v) = Zamba2._shared_attn(cfg, params["shared"], hh, positions,
                                             cfg.window, heads)
            # ring buffer of absolute-rope keys
            return hh, (m_caches, (k[:, -W:], v[:, -W:]))

        h, caches = stack_apply_collect(group_fn, params["mamba"], h)
        h = rms_norm(h, params["final_norm"])
        return lm_logits(h[:, -1], params["embed"]), caches

    @staticmethod
    @torch.no_grad()
    def decode(cfg: ArchConfig, params, cache, batch, *, heads=None):
        """One-token step against the ring buffer (slot ``pos mod W``); the
        cache is written in place and returned.  ``heads``: as in
        ``prefill``; each mamba layer's SSM state block is all-gathered
        over ``model`` where it is used, its heads kept."""
        params = as_tree(params)
        h = embed_lookup(params["embed"], batch["token"])  # [B,1,D]
        pos = int(batch["pos"])
        B = h.shape[0]
        hd = cfg.head_dim
        sh = params["shared"]
        positions = torch.full((1, 1), pos, device=h.device)

        def m_step(p, hx, c):
            conv, state = c
            y, (conv, state) = ssm_decode_step(p["ssm"], rms_norm(hx, p["norm"]),
                                               (conv, *all_states((state,), heads)), cfg)
            return hx + y, (conv, *own_state((state,), heads))

        def group_fn(g_params, hh, g_cache):
            m_caches, (kc, vc) = g_cache
            W = kc.shape[1]
            hh, m_new = stack_apply_with_state(m_step, g_params, hh, m_caches)
            # shared attention against the ring buffer
            a_in = rms_norm(hh, sh["attn_norm"])
            q, k, v, w = Zamba2._qkv(cfg, sh, a_in, positions, heads)
            Hq, Hkv = q.shape[2], k.shape[2]
            slot = pos % W
            kc[:, slot] = k[:, 0].to(kc.dtype)
            vc[:, slot] = v[:, 0].to(vc.dtype)
            n_valid = min(pos + 1, W)  # all slots valid once pos+1 >= W
            scores = torch.einsum(
                "bqhrd,bkhd->bhrqk", q.reshape(B, 1, Hkv, Hq // Hkv, hd), kc
            ).to(torch.float32) / math.sqrt(hd)
            valid = torch.arange(W, device=h.device) < n_valid
            scores = torch.where(valid, scores, NEG)
            probs = torch.softmax(scores, dim=-1).to(hh.dtype)
            out = torch.einsum("bhrqk,bkhd->bqhrd", probs, vc).reshape(B, 1, Hq * hd)
            hh = hh + heads_out(out, w.wo, heads)
            return Zamba2._mlp(sh, hh), (m_new, (kc, vc))

        h, cache = stack_apply_with_state(group_fn, params["mamba"], h, cache)
        h = rms_norm(h, params["final_norm"])
        return lm_logits(h[:, -1], params["embed"]), cache

    @staticmethod
    def input_specs(cfg: ArchConfig, shape: ShapeSpec):
        return XLSTM.input_specs(cfg, shape)

    @staticmethod
    def cache_specs(cfg: ArchConfig, shape: ShapeSpec):
        B = shape.global_batch
        G, E = Zamba2.n_groups(cfg), cfg.attn_every
        W = min(cfg.window or shape.seq_len, shape.seq_len)
        conv, state = ssm_cache_specs(cfg, B, E)
        m_caches = (meta((G, *conv.shape), conv.dtype),
                    meta((G, *state.shape), state.dtype))
        kv = meta((G, B, W, cfg.n_kv_heads, cfg.head_dim), torch.bfloat16)
        return (m_caches, (kv, kv))
