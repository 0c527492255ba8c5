"""Mamba2 (SSD) block, the port of ``repro.models.ssm``: chunked parallel
scan for training and prefill, an O(1) recurrent step for decode.

Simplified-but-faithful SSD (arXiv:2405.21060): scalar decay per head,
single B/C group.  Recurrence per head h with state N, head dim P:

    H_t = exp(dt_t * A_h) * H_{t-1} + dt_t * B_t (x)  (outer product  N x P)
    y_t = C_t · H_t + D_h * x_t

Chunked evaluation: intra-chunk attention-like term + inter-chunk state
scan (a Python loop over the chunks).

One divergence by design: the intra-chunk decay is masked with ``-inf``
before its ``exp``.  The reference takes the ``exp`` of the whole square
and masks after it; the upper triangle's decay is positive, overflows to
inf once a chunk's summed ``|dt * A|`` passes ~88 (one chunk of 64 at
parameters of std 0.3; of 128 at the init scale), and its
backward is then NaN (``0 * inf``) for every gradient through ``dt`` and
the input.  The forward is bit for bit the same; the gradients equal
the reference's wherever the reference's are finite.

Dtypes follow the reference's promotion: ``jnp.einsum`` promotes a bf16
operand to fp32 beside an fp32 one, ``torch.einsum`` refuses mixed
dtypes, so the cast is written out.  Each product of three operands is
written as two, so the order of contraction does not depend on whether
``opt_einsum`` is installed.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import meta, rms_norm

CONV_K = 4


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_headdim
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


def ssm_param_specs(cfg: ArchConfig, dtype=torch.bfloat16) -> Dict[str, Any]:
    D = cfg.d_model
    d_inner, H, P, N = ssm_dims(cfg)
    d_conv = d_inner + 2 * N  # conv over x, B, C channels
    return {
        "in_proj": meta((D, 2 * d_inner + 2 * N + H), dtype),
        "conv_w": meta((CONV_K, d_conv), dtype),
        "conv_b": meta((d_conv,), dtype),
        "A_log": meta((H,), torch.float32),
        "D": meta((H,), torch.float32),
        "dt_bias": meta((H,), torch.float32),
        "norm": meta((d_inner,), dtype),
        "out_proj": meta((d_inner, D), dtype),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    d_inner, H, P, N = ssm_dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * N, H], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, k=4. xBC: [B, S, Cc].  The taps are summed
    in the reference's order (Python ``sum`` from 0), each rounded to
    the activation dtype."""
    pads = F.pad(xBC, (0, 0, CONV_K - 1, 0))
    out = sum(
        pads[:, i : i + xBC.shape[1]] * w[i][None, None, :] for i in range(CONV_K)
    )
    return F.silu(out + b[None, None, :])


def chunk_len(S: int, chunk: int) -> int:
    """The chunk length ``min(chunk, S)``; raises ``ValueError`` where the
    reference ``assert``s that it divides ``S``."""
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} must divide into chunks of {Q}")
    return Q


def ssm_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig, *,
                chunk: int = 256) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] (training / prefill form)."""
    B, S, D = x.shape
    d_inner, H, P, N = ssm_dims(cfg)
    f32 = torch.float32
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xs, Bs, Cs = torch.split(xBC, [d_inner, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    dt = F.softplus(dt.to(f32) + p["dt_bias"][None, None])  # [B,S,H]
    A = -torch.exp(p["A_log"])  # [H] negative
    dA = dt * A[None, None]  # [B,S,H] log-decay per step

    Q = chunk_len(S, chunk)
    nC = S // Q

    def reshape_c(a):
        return a.reshape(B, nC, Q, *a.shape[2:])

    xs_c, Bs_c, Cs_c, dA_c, dt_c = map(reshape_c, (xs, Bs, Cs, dA, dt))
    cum = torch.cumsum(dA_c, dim=2)  # [B,nC,Q,H] cumulative log-decay
    total = cum[:, :, -1]  # [B,nC,H]

    # intra-chunk (attention-like, causal)
    xw = xs_c * dt_c[..., None]  # dt-weighted inputs [B,nC,Q,H,P], fp32
    scores_bc = torch.einsum("bcqn,bckn->bcqk", Cs_c, Bs_c)  # [B,nC,Q,Q], x's dtype
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nC,Q,K,H]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # masked before the exp (the reference masks after it): the same
    # forward, but the masked upper triangle, whose decay is positive, no
    # longer overflows to inf and turns its zero gradient into NaN
    w = torch.exp(torch.where(causal[None, None, :, :, None], decay, -math.inf))
    sw = scores_bc.to(f32)[..., None] * w  # [B,nC,Q,K,H]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", sw, xw)

    # chunk states: S_c = sum_s exp(total - cum_s) * B_s (x) xw_s  -> [B,nC,H,N,P]
    state_w = torch.exp(total[:, :, None] - cum)  # [B,nC,Q,H]
    chunk_state = torch.einsum(
        "bcqn,bcqhp->bchnp", Bs_c.to(f32), state_w[..., None] * xw
    )

    # inter-chunk scan over nC: the state before each chunk
    h = torch.zeros((B, H, N, P), dtype=f32, device=x.device)
    h_prevs = []
    for c in range(nC):
        h_prevs.append(h)
        h = torch.exp(total[:, c])[..., None, None] * h + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # [B,nC,H,N,P]

    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cs_c.to(f32), h_prevs) * torch.exp(
        cum
    )[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + p["D"][None, None, :, None] * xs.to(f32)
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p["norm"])
    return torch.einsum("bse,ed->bsd", y, p["out_proj"])


def ssm_decode_step(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # [B, 1, D]
    cache: Tuple[torch.Tensor, torch.Tensor],  # (conv [B, K-1, Cc], ssm [B,H,N,P])
    cfg: ArchConfig,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    B = x.shape[0]
    d_inner, H, P, N = ssm_dims(cfg)
    f32 = torch.float32
    conv_state, h = cache
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"])
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    # conv ring buffer: [B, K-1, Cc] previous inputs
    full = torch.cat([conv_state, xBC], dim=1)  # [B,K,Cc]
    conv_out = torch.einsum("bkc,kc->bc", full, p["conv_w"]) + p["conv_b"]
    xBC_t = F.silu(conv_out)
    xs, Bs, Cs = torch.split(xBC_t, [d_inner, N, N], dim=-1)
    xs = xs.reshape(B, H, P).to(f32)
    dt_t = F.softplus(dt[:, 0].to(f32) + p["dt_bias"][None])  # [B,H]
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt_t * A[None])  # [B,H]
    contrib = Bs.to(f32)[:, None, :, None] * (dt_t[..., None] * xs)[:, :, None, :]
    h = decay[..., None, None] * h + contrib
    y = torch.einsum("bn,bhnp->bhp", Cs.to(f32), h)
    y = y + p["D"][None, :, None] * xs
    y = y.reshape(B, d_inner).to(x.dtype)
    y = y * F.silu(z[:, 0])
    y = rms_norm(y, p["norm"])
    out = torch.einsum("be,ed->bd", y, p["out_proj"])[:, None, :]
    return out, (full[:, 1:], h)


def ssm_cache_specs(cfg: ArchConfig, batch: int, n_layers: int):
    d_inner, H, P, N = ssm_dims(cfg)
    d_conv = d_inner + 2 * N
    return (
        meta((n_layers, batch, CONV_K - 1, d_conv), torch.bfloat16),
        meta((n_layers, batch, H, N, P), torch.float32),
    )
