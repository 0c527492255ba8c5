"""xLSTM blocks (arXiv:2405.04517), the port of ``repro.models.xlstm``:
mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar memory,
recurrent scan).  Layers alternate mLSTM/sLSTM.

mLSTM per head (state C: hd x hd matrix, normalizer n: hd, stabilizer m):
    f_t, i_t exp/sigmoid input-conditioned gates
    C_t = f C_{t-1} + i v_t k_t^T ;  n_t = f n_{t-1} + i k_t
    h_t = o_t * (C_t q_t) / max(|n_t . q_t|, 1)
Chunkwise: quadratic within chunk, recurrent (C, n, m) across chunks (a
Python loop over the chunks); decode is O(1) per token.

sLSTM per unit (c, n, m scalar states; per-head block-diag recurrence):
    c_t = f c_{t-1} + i tanh(z);  n_t = f n_{t-1} + i;  h = o * c/n
a Python loop over the positions.

As in the reference: the key scale ``1/sqrt(hd)`` is rounded to the
activation dtype (sqrt(192) is 13.875 in bf16); masks are ``-inf`` and
the maxes over them ``torch.amax`` (its gradient splits ties evenly, as
JAX's does); ``torch.maximum`` splits a tie's gradient as
``jnp.maximum`` does (sLSTM's first step ties ``n`` with 1).  Products
of three operands are written as two (see ``models/ssm.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .common import meta, rms_norm
from .ssm import chunk_len

F32 = torch.float32


def xlstm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    H = cfg.n_heads
    hd = cfg.d_model // H
    return cfg.d_model, H, hd


def mlstm_param_specs(cfg: ArchConfig, dtype=torch.bfloat16) -> Dict[str, Any]:
    D, H, hd = xlstm_dims(cfg)
    return {
        "wq": meta((D, D), dtype),
        "wk": meta((D, D), dtype),
        "wv": meta((D, D), dtype),
        "wi": meta((D, H), F32),  # input gate (per head)
        "wf": meta((D, H), F32),  # forget gate (per head)
        "wo": meta((D, D), dtype),  # output gate (per unit)
        "norm": meta((D,), dtype),
        "proj": meta((D, D), dtype),
    }


def slstm_param_specs(cfg: ArchConfig, dtype=torch.bfloat16) -> Dict[str, Any]:
    D, H, hd = xlstm_dims(cfg)
    return {
        "wz": meta((D, D), dtype),
        "wi": meta((D, D), F32),
        "wf": meta((D, D), F32),
        "wo": meta((D, D), dtype),
        "rz": meta((H, hd, hd), dtype),  # block-diagonal recurrence
        "ri": meta((H, hd, hd), F32),
        "rf": meta((H, hd, hd), F32),
        "ro": meta((H, hd, hd), dtype),
        "norm": meta((D,), dtype),
        "proj": meta((D, D), dtype),
    }


def _key_scale(hd: int, dtype) -> float:
    """``jnp.sqrt(jnp.float32(hd)).astype(dtype)`` as a Python float."""
    return float(torch.tensor(math.sqrt(hd), dtype=F32).to(dtype))


def mlstm_state0(B: int, H: int, hd: int, device):
    """The empty (C, n, m) carry."""
    return (
        torch.zeros((B, H, hd, hd), dtype=F32, device=device),
        torch.zeros((B, H, hd), dtype=F32, device=device),
        torch.full((B, H), -1e30, dtype=F32, device=device),
    )


def slstm_state0(B: int, D: int, dtype, device):
    """The empty (c, n, m, h) state; ``h`` in the activation dtype."""
    return (
        torch.zeros((B, D), dtype=F32, device=device),
        torch.zeros((B, D), dtype=F32, device=device),
        torch.full((B, D), -1e30, dtype=F32, device=device),
        torch.zeros((B, D), dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_forward(p, x: torch.Tensor, cfg: ArchConfig, *, chunk: int = 256) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] chunkwise-parallel."""
    B, S, D = x.shape
    _, H, hd = xlstm_dims(cfg)
    q = torch.einsum("bsd,de->bse", x, p["wq"]).reshape(B, S, H, hd)
    k = torch.einsum("bsd,de->bse", x, p["wk"]).reshape(B, S, H, hd) / _key_scale(
        hd, x.dtype)
    v = torch.einsum("bsd,de->bse", x, p["wv"]).reshape(B, S, H, hd)
    ig = torch.einsum("bsd,dh->bsh", x.to(F32), p["wi"])  # log-space
    fg = F.logsigmoid(torch.einsum("bsd,dh->bsh", x.to(F32), p["wf"]))
    og = torch.sigmoid(torch.einsum("bsd,de->bse", x, p["wo"]))

    Q = chunk_len(S, chunk)
    nC = S // Q

    def rs(a):
        return a.reshape(B, nC, Q, *a.shape[2:])

    qc, kc, vc, ic, fc = map(rs, (q.to(F32), k.to(F32), v.to(F32), ig, fg))

    cumf = torch.cumsum(fc, dim=2)  # [B,nC,Q,H]
    # intra-chunk log weights: lw[t,s] = cumf_t - cumf_s + i_s  (s <= t)
    lw = cumf[:, :, :, None, :] - cumf[:, :, None, :, :] + ic[:, :, None, :, :]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    lw = torch.where(causal[None, None, :, :, None], lw, -math.inf)

    # scan chunks carrying (C [B,H,hd,hd], n [B,H,hd], m [B,H])
    C, n, m = mlstm_state0(B, H, hd, x.device)
    ys = []
    for c in range(nC):
        qq, kk, vv, ii, lww, cf = qc[:, c], kc[:, c], vc[:, c], ic[:, c], lw[:, c], cumf[:, c]
        total_f = cf[:, -1]  # [B,H]
        # stabilizer per t: max of intra weights and the state weight
        state_lw = cf + m[:, None, :]  # [B,Q,H]
        m_new_t = torch.maximum(torch.amax(lww, dim=2), state_lw)  # [B,Q,H]
        w_intra = torch.exp(lww - m_new_t[:, :, None, :])  # [B,Q,K,H]
        scores = torch.einsum("bqhd,bkhd->bqkh", qq, kk)
        sw = scores * w_intra
        y_intra = torch.einsum("bqkh,bkhd->bqhd", sw, vv)
        norm_intra = torch.sum(sw, dim=2)
        w_state = torch.exp(state_lw - m_new_t)  # [B,Q,H]
        y_state = torch.einsum("bqhd,bhde->bqhe", qq, C) * w_state[..., None]
        norm_state = torch.einsum("bqhd,bhd->bqh", qq, n) * w_state
        denom = torch.maximum(torch.abs(norm_intra + norm_state), torch.exp(-m_new_t))
        ys.append((y_intra + y_state) / denom[..., None])  # [B,Q,H,hd]
        # update chunk state
        m_next = torch.maximum(
            total_f + m, torch.amax(ii + total_f[:, None] - cf, dim=1)
        )  # [B,H]
        w_keep = torch.exp(total_f + m - m_next)  # [B,H]
        w_add = torch.exp(ii + total_f[:, None] - cf - m_next[:, None, :])  # [B,Q,H]
        C = C * w_keep[..., None, None] + torch.einsum(
            "bqhd,bqhe->bhde", w_add[..., None] * kk, vv
        )
        n = n * w_keep[..., None] + torch.einsum("bqh,bqhd->bhd", w_add, kk)
        m = m_next

    y = torch.stack(ys, dim=1).reshape(B, S, H * hd)
    y = og * y.to(x.dtype)
    y = rms_norm(y, p["norm"])
    return torch.einsum("bse,ed->bsd", y, p["proj"])


def mlstm_decode_step(p, x: torch.Tensor, cache, cfg: ArchConfig):
    """x: [B,1,D]; cache = (C [B,H,hd,hd], n [B,H,hd], m [B,H])."""
    B = x.shape[0]
    _, H, hd = xlstm_dims(cfg)
    C, n, m = cache
    xt = x[:, 0]
    q = torch.einsum("bd,de->be", xt, p["wq"]).reshape(B, H, hd).to(F32)
    k = (torch.einsum("bd,de->be", xt, p["wk"]) / _key_scale(hd, x.dtype)).reshape(
        B, H, hd).to(F32)
    v = torch.einsum("bd,de->be", xt, p["wv"]).reshape(B, H, hd).to(F32)
    ig = torch.einsum("bd,dh->bh", xt.to(F32), p["wi"])
    fg = F.logsigmoid(torch.einsum("bd,dh->bh", xt.to(F32), p["wf"]))
    og = torch.sigmoid(torch.einsum("bd,de->be", xt, p["wo"]))

    m_new = torch.maximum(fg + m, ig)
    wf = torch.exp(fg + m - m_new)
    wi = torch.exp(ig - m_new)
    C = C * wf[..., None, None] + wi[..., None, None] * (k[..., :, None] * v[..., None, :])
    n = n * wf[..., None] + wi[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.sum(q * n, dim=-1)), torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, H * hd)
    y = og * y.to(x.dtype)
    y = rms_norm(y, p["norm"])
    return torch.einsum("be,ed->bd", y, p["proj"])[:, None], (C, n, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_step(p, state, xt: torch.Tensor, cfg: ArchConfig):
    """One timestep. state = (c, n, m, h) each [B, D] (m,c,n fp32)."""
    B = xt.shape[0]
    D, H, hd = xlstm_dims(cfg)
    c, n, m, h = state
    hb = h.reshape(B, H, hd)

    def rec(w):  # block-diag recurrence
        return torch.einsum("bhp,hpq->bhq", hb.to(w.dtype), w).reshape(B, D)

    z = torch.tanh(torch.einsum("bd,de->be", xt, p["wz"]) + rec(p["rz"]))
    i_log = torch.einsum("bd,de->be", xt.to(F32), p["wi"]) + rec(p["ri"])
    f_log = F.logsigmoid(torch.einsum("bd,de->be", xt.to(F32), p["wf"]) + rec(p["rf"]))
    o = torch.sigmoid(torch.einsum("bd,de->be", xt, p["wo"]) + rec(p["ro"]))
    m_new = torch.maximum(f_log + m, i_log)
    ip = torch.exp(i_log - m_new)
    fp = torch.exp(f_log + m - m_new)
    c_new = fp * c + ip * z.to(F32)
    n_new = fp * n + ip
    one = torch.ones((), dtype=F32, device=xt.device)
    h_new = o * (c_new / torch.maximum(n_new, one)).to(o.dtype)
    return (c_new, n_new, m_new, h_new), h_new


def slstm_forward(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    B, S, D = x.shape
    state = slstm_state0(B, D, x.dtype, x.device)
    hs = []
    for t in range(S):
        state, h = slstm_step(p, state, x[:, t], cfg)
        hs.append(h)
    y = torch.stack(hs, dim=1)  # [B, S, D]
    y = rms_norm(y, p["norm"])
    return torch.einsum("bse,ed->bsd", y, p["proj"])


def slstm_decode_step(p, x: torch.Tensor, cache, cfg: ArchConfig):
    """x: [B,1,D]; cache = (c, n, m, h)."""
    state, h_new = slstm_step(p, cache, x[:, 0], cfg)
    y = rms_norm(h_new, p["norm"])
    return torch.einsum("be,ed->bd", y, p["proj"])[:, None], state
