"""Mixture-of-Experts FFN (top-k routing, sort+scatter dispatch), the
single-device path of ``repro.models.moe``.

Dispatch:
  1. router logits -> top-k experts per token (fp32 router), a softmax
     over the k weights
  2. assignments sorted stably by expert id; rank-within-expert via
     searchsorted
  3. tokens scattered into a capacity-bounded [E, C, D] buffer
     (assignments past capacity C are dropped, standard GShard semantics)
  4. per-expert SwiGLU via batched einsum on the [E, ...] buffers
  5. results gathered back and combined with router weights

The reference's expert-parallel path over a mesh (``moe_ffn_ep``) is not
ported yet.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import meta


def moe_param_specs(cfg: ArchConfig, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": meta((D, E), torch.float32),
        "w_gate": meta((E, D, Fd), dtype),
        "w_up": meta((E, D, Fd), dtype),
        "w_down": meta((E, Fd, D), dtype),
    }


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8 for tiling


def _route(logits, k: int, E_local: int, C: int, dtype):
    """-> (se, st, sw, keep, pos): each (token, choice) assignment sorted
    stably by expert id, its token, its weight, whether it survives
    capacity, and its rank within its expert."""
    T = logits.shape[0]
    topw, topi = torch.topk(logits, k, dim=-1)  # [T, k] (global expert ids)
    topw = torch.softmax(topw, dim=-1).to(dtype)

    flat_e = topi.reshape(-1)  # [T*k]
    flat_t = torch.arange(T, device=logits.device).repeat_interleave(k)
    flat_w = topw.reshape(-1)
    # local assignments keep id in [0, E_local); others -> sink E_local
    local = (flat_e >= 0) & (flat_e < E_local)
    flat_e = torch.where(local, flat_e, E_local)

    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(T * k, device=logits.device) - first  # rank within expert
    keep = (pos < C) & (se < E_local)
    return se, st, sw, keep, pos


def _dispatch_compute(xf, logits, w_gate, w_up, w_down, *, k, n_experts, C, dtype):
    """Capacity-bounded top-k dispatch + per-expert SwiGLU + combine.

    xf: [T, D]; logits fp32 [T, E_total]; weights [E_local, D, F]."""
    T, D = xf.shape
    E_local = w_gate.shape[0]
    se, st, sw, keep, pos = _route(logits, k, E_local, C, dtype)
    pos_c = torch.where(keep, pos, 0)
    se_c = torch.where(keep, se, 0)

    buf = torch.zeros((E_local, C, D), dtype=dtype, device=xf.device)
    buf = buf.index_put(
        (se_c, pos_c), torch.where(keep[:, None], xf[st], 0), accumulate=True
    )

    h_g = torch.einsum("ecd,edf->ecf", buf, w_gate)
    h_u = torch.einsum("ecd,edf->ecf", buf, w_up)
    h = F.silu(h_g) * h_u
    out_buf = torch.einsum("ecf,efd->ecd", h, w_down)  # [E_local, C, D]

    vals = out_buf[se_c, pos_c] * torch.where(keep, sw, 0)[:, None]
    return torch.zeros((T, D), dtype=dtype, device=xf.device).index_add(0, st, vals)


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] on one device."""
    B, S, D = x.shape
    T = B * S
    xf = x.reshape(T, D)
    logits = torch.einsum("td,de->te", xf.to(torch.float32), p["router"])
    y = _dispatch_compute(
        xf, logits, p["w_gate"], p["w_up"], p["w_down"],
        k=cfg.top_k, n_experts=cfg.n_experts,
        C=moe_capacity(cfg, T), dtype=x.dtype,
    )
    return y.reshape(B, S, D)
