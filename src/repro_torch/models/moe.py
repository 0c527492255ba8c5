"""Mixture-of-Experts FFN (top-k routing, sort+scatter dispatch,
expert-parallel over a mesh's ``model`` axis), the port of
``repro.models.moe``.

Dispatch:
  1. router logits -> top-k experts per token (fp32 router), a softmax
     over the k weights
  2. assignments sorted stably by expert id; rank-within-expert via
     searchsorted
  3. tokens scattered into a capacity-bounded [E, C, D] buffer
     (assignments past capacity C are dropped, standard GShard semantics)
  4. per-expert SwiGLU via batched einsum on the [E, ...] buffers
  5. results gathered back and combined with router weights

While an activation mesh is installed (``dist.sharding.
set_activation_mesh``) and its ``model`` axis divides ``n_experts``,
``moe_ffn`` takes the expert-parallel path ``moe_ffn_ep``, as the
reference's does: each batch shard's tile ``m`` routes its tokens
against the global router, keeps its own experts ``[m * E/n, (m+1) *
E/n)`` with capacity ``moe_capacity(cfg, T_local)`` per expert, and the
partial outputs are summed over ``model`` (the reference's ``psum``).
On a logical mesh one process drives the tiles one after another and
sums them in tile order on the mesh's first device.  On a rank mesh each
rank is one tile: ``x`` is its own token rows, its experts are its block
of the expert weights, and one ``all_reduce`` over its ``model`` group
sums the partials (``dist.collectives.from_model_region``; the
gradients of the tokens and the router are summed over ``model`` on the
way back, ``to_model_region``).  The dispatch (``index_put`` /
``index_add``) runs on the rank's local tensors.
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


def _route(logits, k: int, E_local: int, C: int, dtype, expert_lo: int = 0):
    """-> (se, st, sw, keep, pos): each (token, choice) assignment sorted
    stably by local expert id (global id - ``expert_lo``), its token, its
    weight, whether it survives capacity, and its rank within its expert."""
    T = logits.shape[0]
    topw, topi = torch.topk(logits, k, dim=-1)  # [T, k] (global expert ids)
    topw = torch.softmax(topw, dim=-1).to(dtype)

    flat_e = topi.reshape(-1)  # [T*k]
    if expert_lo:
        flat_e = flat_e - expert_lo
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


def _dispatch_compute(xf, logits, w_gate, w_up, w_down, *, k, n_experts, C, dtype,
                      expert_lo: int = 0):
    """Capacity-bounded top-k dispatch + per-expert SwiGLU + combine.

    xf: [T, D]; logits fp32 [T, E_total]; weights [E_local, D, F] of the
    experts ``[expert_lo, expert_lo + E_local)``.  Picks of other experts
    are dropped (their contribution comes from other tiles; see
    moe_ffn_ep)."""
    T, D = xf.shape
    E_local = w_gate.shape[0]
    se, st, sw, keep, pos = _route(logits, k, E_local, C, dtype, expert_lo)
    pos_c = torch.where(keep, pos, 0)
    se_c = torch.where(keep, se, 0)

    # The reference scatter-adds every pick, the dropped ones as zeros at
    # slot (0, 0).  Kept picks own distinct slots, so each is written once
    # (the same values) and the dropped ones go to a trash row: an
    # accumulating scatter on CUDA sorts its indices and serialises on
    # the repeated one.
    slot = torch.where(keep, se_c * C + pos_c, E_local * C)
    buf = torch.zeros((E_local * C + 1, D), dtype=dtype, device=xf.device)
    buf = buf.index_put((slot,), xf[st])[:-1].view(E_local, C, D)

    h_g = torch.einsum("ecd,edf->ecf", buf, w_gate)
    h_u = torch.einsum("ecd,edf->ecf", buf, w_up)
    h = F.silu(h_g) * h_u
    out_buf = torch.einsum("ecf,efd->ecd", h, w_down)  # [E_local, C, D]

    vals = out_buf[se_c, pos_c] * torch.where(keep, sw, 0)[:, None]
    return torch.zeros((T, D), dtype=dtype, device=xf.device).index_add(0, st, vals)


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D].  The expert-parallel path when an
    activation mesh is installed whose ``model`` axis divides the
    experts; otherwise the plain single-device path."""
    from ..dist.sharding import _axis_sizes, activation_mesh

    mesh = activation_mesh()
    if (
        mesh is not None
        and "model" in mesh.axis_names
        and cfg.n_experts % _axis_sizes(mesh)["model"] == 0
    ):
        return moe_ffn_ep(p, x, cfg, mesh)
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


def moe_ffn_ep(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
               mesh) -> torch.Tensor:
    """Expert-parallel MoE: tokens shard over the batch axes
    (``batch_axes``), experts over ``model``.  The tile at (batch shard,
    ``model`` index m) computes, on its device, its token rows against
    the global router and its local experts only; the partial outputs
    are summed over ``model`` in tile order on the mesh's first device.
    With one tile this is ``moe_ffn``'s plain path op for op.  With a
    batch split the capacity follows the shard's tokens, so the dropped
    picks are those of the plain path applied to each shard."""
    from ..dist.sharding import _axis_sizes, batch_shards

    if getattr(mesh, "distributed", False):
        return _moe_ffn_ranks(p, x, cfg, mesh)
    B, S, D = x.shape
    n_model = _axis_sizes(mesh)["model"]
    shards = batch_shards(mesh, B)
    B_l = B // len(shards)
    T_local = B_l * S
    C = moe_capacity(cfg, T_local)
    E_local = cfg.n_experts // n_model
    first = mesh.first_device
    outs = []
    for coords, b in shards:
        xl = x[b * B_l:(b + 1) * B_l]
        y = None
        for m in range(n_model):
            dev = mesh.device_at({**coords, "model": m})
            lo = m * E_local
            xf = xl.reshape(T_local, D).to(dev)
            logits = torch.einsum("td,de->te", xf.to(torch.float32), p["router"].to(dev))
            w = [p[n][lo:lo + E_local].to(dev) for n in ("w_gate", "w_up", "w_down")]
            yl = _dispatch_compute(
                xf, logits, *w, k=cfg.top_k, n_experts=cfg.n_experts, C=C,
                dtype=x.dtype, expert_lo=lo,
            ).to(first)
            y = yl if y is None else y + yl  # the reference's psum over model
        outs.append(y.reshape(B_l, S, D))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


def _expert_block(w, lo: int, E_local: int) -> torch.Tensor:
    """This rank's experts ``[lo, lo + E_local)`` of an expert weight: the
    block of a ``ShardedLeaf`` split over ``model`` on its expert dim
    (its other dims gathered), or a slice of a whole tensor."""
    from ..dist.collectives import ShardedLeaf, _axes

    if isinstance(w, ShardedLeaf):
        if _axes(w.spec[0] if w.spec else None) != ("model",):
            raise ValueError(f"an expert weight split {w.spec}, not over model on "
                             "its expert dim")
        return w.without_dim0().gather()
    return w[lo:lo + E_local]


def _moe_ffn_ranks(p, x: torch.Tensor, cfg: ArchConfig, mesh) -> torch.Tensor:
    """``moe_ffn_ep`` for this rank of a rank mesh: ``x`` [B_l, S, D] is
    its token rows (the same on every rank of its ``model`` group)."""
    from ..dist.collectives import ShardedLeaf, from_model_region, to_model_region

    B_l, S, D = x.shape
    n_model = mesh.shape["model"]
    T_local = B_l * S
    E_local = cfg.n_experts // n_model
    lo = mesh.coords["model"] * E_local
    router = p["router"]
    if isinstance(router, ShardedLeaf):
        router = router.gather()
    xf = to_model_region(x.reshape(T_local, D), mesh)
    logits = torch.einsum("td,de->te", xf.to(torch.float32),
                          to_model_region(router, mesh))
    w = [_expert_block(p[n], lo, E_local) for n in ("w_gate", "w_up", "w_down")]
    yl = _dispatch_compute(
        xf, logits, *w, k=cfg.top_k, n_experts=cfg.n_experts,
        C=moe_capacity(cfg, T_local), dtype=x.dtype, expert_lo=lo,
    )
    return from_model_region(yl, mesh).reshape(B_l, S, D)
