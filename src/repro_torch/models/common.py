"""Shared model components, the port of ``repro.models.common``: norms,
RoPE, GQA attention (+KV cache), MLP, embedding, loss and the loops over
stacked layers.

The reference's streaming attention (``_flash_attention``) is a
``lax.scan`` with a custom VJP; here it is a ``torch.autograd.Function``
whose forward streams the softmax over ``ATTN_CHUNK`` key blocks and whose
backward recomputes block by block, so neither direction holds more than
one block of scores.  Masks use ``-1e30``, not ``-inf``, as the reference's
do: a query row whose keys are all masked averages ``v`` uniformly.

The reference's activation hints stay: ``embed_lookup`` and
``causal_lm_loss`` call the port's ``dist.sharding.hint``, which states
the layout against the installed mesh and keeps the tensor whole.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..tree import flatten, register, tree_map, unflatten

NEG = -1e30  # the reference's mask value


def meta(shape, dtype=torch.bfloat16) -> torch.Tensor:
    """A shape and dtype without storage (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def stack_specs(specs, n: int):
    """A spec tree -> the same tree with a leading ``[n]`` layer axis."""
    return tree_map(lambda s: meta((n, *s.shape), s.dtype), specs)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class LMParams(nn.Module):
    """The parameters of one LM of any family: the tensors of ``params``
    (a nested dict shaped like the family's ``param_specs``) become its
    parameters without a copy, its ``state_dict()`` keys the reference's
    tree paths joined by ``.``."""

    def __init__(self, cfg: ArchConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        register(self, params)


Params = Union[LMParams, Dict[str, Any]]


def init_from_specs(cfg: ArchConfig, specs, generator: Union[int, torch.Generator],
                    device=None) -> LMParams:
    """Random parameters (normal, std 0.02, in each leaf's dtype) shaped
    like ``specs``, on ``device`` (the CUDA card unless ``device="cpu"``),
    drawn leaf by leaf in path order from ``generator`` (a seed, or a
    ``torch.Generator`` on that device)."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    leaves = [
        (path, torch.randn(s.shape, dtype=s.dtype, device=dev,
                           generator=generator).mul_(0.02))
        for path, s in flatten(specs)
    ]
    return LMParams(cfg, unflatten(leaves))


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] integer."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half
    ))
    angles = positions[..., :, None].to(torch.float32) * freqs  # [..., S, half]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    g = torch.einsum("...d,df->...f", x, w_gate)
    u = torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", F.silu(g) * u, w_down)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN_CHUNK = 1024  # kv-block size for the streaming-softmax path
ATTN_CHUNK_THRESHOLD = 2048  # use streaming path when Skv exceeds this


def _plain_attention(q, k, v, *, causal, q_offset, window, kv_len):
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, hd)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).to(torch.float32)
    scores = scores / math.sqrt(hd)

    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset  # [Sq, 1]
    k_pos = torch.arange(Skv, device=q.device)[None, :]  # [1, Skv]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    if kv_len is not None:
        mask &= k_pos < kv_len
    scores = torch.where(mask, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v)
    return out.reshape(B, Sq, Hq, hd)


def _block_mask(Sq, C, j, q_offset, causal, window, Skv, device):
    q_pos = torch.arange(Sq, device=device)[:, None] + q_offset
    k_pos = j * C + torch.arange(C, device=device)[None, :]
    mask = k_pos < Skv
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    return mask


def _flash_prep(q, k, v):
    """-> (qg pre-scaled fp32 [B,Sq,Hkv,rep,hd], k blocks, v blocks
    [nB] x [B,C,Hkv,hd], C)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    C = ATTN_CHUNK
    nB = -(-Skv // C)
    pad = nB * C - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qg = (q.to(torch.float32) / math.sqrt(hd)).reshape(B, Sq, Hkv, rep, hd)
    return qg, k.split(C, dim=1), v.split(C, dim=1), C


def _flash_fwd_scan(qg, kb, vb, *, C, causal, q_offset, window, Skv):
    """qg: [B,Sq,Hkv,rep,hd] (pre-scaled fp32); kb/vb: blocks [B,C,Hkv,hd].
    -> (acc fp32 [B,Sq,Hkv,rep,hd], m, l [B,Hkv,rep,Sq])"""
    B, Sq, Hkv, rep, hd = qg.shape
    m = torch.full((B, Hkv, rep, Sq), -math.inf, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, Hkv, rep, Sq), dtype=torch.float32, device=qg.device)
    acc = torch.zeros((B, Sq, Hkv, rep, hd), dtype=torch.float32, device=qg.device)
    for j, (kj, vj) in enumerate(zip(kb, vb)):
        s = torch.einsum("bqhrd,bkhd->bhrqk", qg, kj.to(torch.float32))
        mask = _block_mask(Sq, C, j, q_offset, causal, window, Skv, qg.device)
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + torch.einsum(
            "bhrqk,bkhd->bqhrd", p, vj.to(torch.float32)
        )
        m = m_new
    return acc, m, l


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_attention`` with its custom VJP
    (``_flash_fwd`` / ``_flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window):
        B, Sq, Hq, hd = q.shape
        Skv = k.shape[1]
        qg, kb, vb, C = _flash_prep(q, k, v)
        acc, m, l = _flash_fwd_scan(
            qg, kb, vb, C=C, causal=causal, q_offset=q_offset, window=window,
            Skv=Skv,
        )
        out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        ctx.save_for_backward(q, k, v, out.to(q.dtype), m, l)
        ctx.args = (causal, q_offset, window)
        return out.reshape(B, Sq, Hq, hd).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors  # out: [B,Sq,Hkv,rep,hd]
        causal, q_offset, window = ctx.args
        B, Sq, Hq, hd = q.shape
        Skv = k.shape[1]
        qg, kb, vb, C = _flash_prep(q, k, v)
        do = dout.reshape(out.shape).to(torch.float32)
        out32 = out.to(torch.float32)
        linv = 1.0 / torch.clamp(l, min=1e-30)  # [B,Hkv,rep,Sq]
        # delta = rowsum(dout * out)  [B,Hkv,rep,Sq]
        delta = torch.einsum("bqhrd,bqhrd->bhrq", do, out32)
        dq = torch.zeros_like(qg)
        dks, dvs = [], []
        for j, (kj, vj) in enumerate(zip(kb, vb)):
            kj, vj = kj.to(torch.float32), vj.to(torch.float32)
            s = torch.einsum("bqhrd,bkhd->bhrqk", qg, kj)
            mask = _block_mask(Sq, C, j, q_offset, causal, window, Skv, q.device)
            s = torch.where(mask, s, NEG)
            p = torch.exp(s - m[..., None]) * linv[..., None]  # normalized probs
            dvs.append(torch.einsum("bhrqk,bqhrd->bkhd", p, do))
            dp = torch.einsum("bqhrd,bkhd->bhrqk", do, vj)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhrqk,bkhd->bqhrd", ds, kj)
            dks.append(torch.einsum("bhrqk,bqhrd->bkhd", ds, qg))
        dq = (dq / math.sqrt(hd)).reshape(B, Sq, Hq, hd).to(q.dtype)
        dk = torch.cat(dks, dim=1)[:, :Skv].to(k.dtype)
        dv = torch.cat(dvs, dim=1)[:, :Skv].to(v.dtype)
        return dq, dk, dv, None, None, None


def _flash_attention(q, k, v, causal, q_offset, window):
    return _FlashAttention.apply(q, k, v, causal, q_offset, window)


def gqa_attention(
    q: torch.Tensor,  # [B, Sq, Hq, hd]
    k: torch.Tensor,  # [B, Skv, Hkv, hd]
    v: torch.Tensor,  # [B, Skv, Hkv, hd]
    *,
    causal: bool,
    q_offset: int = 0,  # absolute position of q[0] (decode)
    window: int = 0,  # sliding window (0 = unlimited)
    kv_len: Optional[int] = None,  # valid kv prefix length (decode masking)
) -> torch.Tensor:
    Sq, Skv = q.shape[1], k.shape[1]
    if Sq > 1 and Skv > ATTN_CHUNK_THRESHOLD and kv_len is None:
        return _flash_attention(q, k, v, causal, q_offset, window)
    return _plain_attention(
        q, k, v, causal=causal, q_offset=q_offset, window=window, kv_len=kv_len
    )


class AttnParams(NamedTuple):
    wq: torch.Tensor  # [D, Hq*hd]
    wk: torch.Tensor  # [D, Hkv*hd]
    wv: torch.Tensor  # [D, Hkv*hd]
    wo: torch.Tensor  # [Hq*hd, D]


def attn_param_specs(cfg: ArchConfig, dtype=torch.bfloat16) -> AttnParams:
    D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return AttnParams(
        wq=meta((D, Hq * hd), dtype),
        wk=meta((D, Hkv * hd), dtype),
        wv=meta((D, Hkv * hd), dtype),
        wo=meta((Hq * hd, D), dtype),
    )


def own_heads(p: AttnParams, cfg: ArchConfig, heads) -> Tuple[AttnParams, int, int]:
    """-> (the weights of ``heads``' query and KV heads: the columns of
    ``wq``, ``wk``, ``wv`` and the rows of ``wo``; its query and KV head
    counts).  ``heads`` is a ``dist.sharding.HeadRanges`` or None (all
    heads: ``p`` itself)."""
    if heads is None or heads.kv is None:
        return p, cfg.n_heads, cfg.n_kv_heads
    hd, q, kv = cfg.head_dim, heads.q, heads.kv
    cols_q, cols_kv = slice(q.start * hd, q.stop * hd), slice(kv.start * hd, kv.stop * hd)
    return (AttnParams(p.wq[:, cols_q], p.wk[:, cols_kv], p.wv[:, cols_kv], p.wo[cols_q]),
            q.stop - q.start, kv.stop - kv.start)


def heads_out(out: torch.Tensor, wo: torch.Tensor, heads) -> torch.Tensor:
    """The attention output ``out`` [B, S, H*hd] times ``wo`` [H*hd, D];
    with ``heads`` splitting the heads over ``model``, each rank's product
    over its own heads, summed over ``model`` (an all-reduce)."""
    y = torch.einsum("bsh,hd->bsd", out, wo)
    if heads is None or heads.kv is None:
        return y
    from ..dist.collectives import from_model_region  # deferred: dist imports models

    return from_model_region(y, heads.mesh)


def attention_block(
    p: AttnParams,
    x: torch.Tensor,  # [B, S, D]
    cfg: ArchConfig,
    *,
    positions: torch.Tensor,  # [S] absolute positions for RoPE
    causal: bool = True,
    window: int = 0,
    cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # decode
    cache_pos: Optional[int] = None,  # decode: write index
    heads=None,  # dist.sharding.HeadRanges: this rank's heads (a rank mesh)
):
    """Self-attention with optional KV cache read/write.

    Returns (out [B,S,D], the updated (k_cache, v_cache) or the fresh
    (k, v)).  The caches are written in place (the reference donates
    them).  As ``jax.lax.dynamic_update_slice`` does, the write start is
    clamped to ``[0, Smax - S]`` while ``q_offset`` and ``kv_len`` keep
    the unclamped ``cache_pos``.

    With ``heads`` (its ``kv`` range set) the block is head-parallel over
    the mesh's ``model`` axis: the rank projects its own query and KV
    heads, keeps (or writes into its cache block) its own k and v,
    attends over them and sums ``out @ wo[its rows]`` over ``model``.
    """
    B, S, D = x.shape
    hd = cfg.head_dim
    p, Hq, Hkv = own_heads(p, cfg, heads)
    q = torch.einsum("bsd,dh->bsh", x, p.wq).reshape(B, S, Hq, hd)
    k = torch.einsum("bsd,dh->bsh", x, p.wk).reshape(B, S, Hkv, hd)
    v = torch.einsum("bsd,dh->bsh", x, p.wv).reshape(B, S, Hkv, hd)
    q = rope(q, positions[None, :], cfg.rope_theta)
    k = rope(k, positions[None, :], cfg.rope_theta)

    if cache_kv is None:
        out = gqa_attention(q, k, v, causal=causal, window=window)
        kv = (k, v)
    else:
        kc, vc = cache_kv  # [B, Smax, Hkv, hd]
        start = min(max(cache_pos, 0), kc.shape[1] - S)
        kc[:, start:start + S] = k.to(kc.dtype)
        vc[:, start:start + S] = v.to(vc.dtype)
        out = gqa_attention(
            q, kc, vc, causal=False, q_offset=cache_pos, window=window,
            kv_len=cache_pos + S,
        )
        kv = (kc, vc)
    return heads_out(out.reshape(B, S, Hq * hd), p.wo, heads), kv


# ---------------------------------------------------------------------------
# embedding / loss
# ---------------------------------------------------------------------------

def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    from ..dist.sharding import hint  # deferred: dist imports models

    return hint(embed[tokens], "batch", None, None)


def lm_logits(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Tied-embedding readout: [..., D] x [V, D] -> [..., V]."""
    return torch.einsum("...d,vd->...v", x, embed)


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor, true_vocab: int):
    """Next-token cross entropy in fp32; padded vocab rows masked out."""
    from ..dist.sharding import hint  # deferred: dist imports models

    V = logits.shape[-1]
    logits = hint(logits.to(torch.float32), "batch", None, "model")
    vocab_mask = torch.arange(V, device=logits.device) < true_vocab
    logits = torch.where(vocab_mask, logits, NEG)
    shift_logits = logits[:, :-1]
    shift_labels = tokens[:, 1:].long()
    logz = torch.logsumexp(shift_logits, dim=-1)
    gold = torch.gather(shift_logits, -1, shift_labels[..., None]).squeeze(-1)
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# layer stacks: Python loops over the stacked layer axis
# ---------------------------------------------------------------------------

def _unstack(tree):
    """A tree whose leaves are stacked on axis 0 -> one tree per layer.
    ``unbind`` once per leaf, so the backward stacks each leaf's layer
    gradients once (a ``select`` per layer would write a zero-filled
    gradient of the whole stack for every layer)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    if isinstance(tree, tuple):
        return list(zip(*(_unstack(v) for v in tree)))
    return list(tree.unbind(0))


def checkpointed(fn):
    """``fn`` recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant, so one checkpoint nests inside another).  No layer
    draws randomness: nothing is replayed in the recompute."""
    return lambda *args: checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False
    )


def stack_apply(layer_fn, params_stacked, x):
    """x -> fold ``layer_fn(p_i, h)`` over the stacked layer axis."""
    h = x
    for p_i in _unstack(params_stacked):
        h = layer_fn(p_i, h)
    return h


def _stack_into(out, i, n, aux, like=None):
    """Write layer ``i``'s aux leaves into stacked buffers (made at the
    first layer).  Where ``like`` (the input state, stacked) has a leaf
    at the same place in the tree with the aux leaf's shape and dtype,
    that leaf is the buffer: the aux is written into it in place (a
    no-op when the layer already wrote it there)."""
    if isinstance(aux, tuple):
        if out is None:
            out = (None,) * len(aux)
        likes = like if isinstance(like, tuple) else ()
        return tuple(_stack_into(o, i, n, a, likes[j] if j < len(likes) else None)
                     for j, (o, a) in enumerate(zip(out, aux)))
    if out is None:
        if (isinstance(like, torch.Tensor) and like.shape[1:] == aux.shape
                and like.dtype == aux.dtype):
            out = like
        else:
            out = aux.new_empty((n, *aux.shape))
    if out[i].data_ptr() != aux.data_ptr():
        out[i] = aux
    return out


def stack_apply_collect(layer_fn, params_stacked, x):
    """Like ``stack_apply`` but ``layer_fn`` returns (h, aux); the auxes
    are stacked on axis 0 (written into one buffer per leaf as the layers
    run, so the per-layer copies are not all held at once)."""
    layers = _unstack(params_stacked)
    h, stacked = x, None
    for i, p_i in enumerate(layers):
        h, aux = layer_fn(p_i, h)
        stacked = _stack_into(stacked, i, len(layers), aux)
    return h, stacked


def stack_apply_with_state(layer_fn, params_stacked, x, state):
    """``layer_fn(p, h, s) -> (h, s')`` threads per-layer state (a tree
    of tuples of tensors stacked on axis 0).  Returns ``h`` and the
    ``s'`` of every layer stacked on axis 0 in ``s'``'s own structure,
    as the reference does.  An ``s'`` leaf with the shape and dtype of
    the ``s`` leaf at the same place is written into that stacked leaf
    in place (the reference donates the state); any other is stacked
    into a new buffer."""
    layers = _unstack(params_stacked)
    h, stacked = x, None
    for i, (p_i, s_i) in enumerate(zip(layers, _unstack(state))):
        h, s_new = layer_fn(p_i, h, s_i)
        stacked = _stack_into(stacked, i, len(layers), s_new, like=state)
    return h, stacked
