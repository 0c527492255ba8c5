"""Minimal AdamW with dtype-configurable moments, the port of
``repro.optim.adamw``.

Moments can be kept in bf16 for very large models (llama4-maverick) so the
optimizer state fits the device's memory.  ``apply`` follows the
reference's arithmetic: the global gradient norm and the clip scale in
fp32, the bias corrections ``1 - b ** step`` in fp32, the update in fp32,
parameters cast back to their dtype and moments to ``moment_dtype``.

The port updates parameters and moments in place (the reference's step
donates them): at stablelm-3b's width the fp32 moments alone are 21 GB,
so a second copy of them does not fit beside the first.  Each leaf is
updated in slices of at most ``_CHUNK`` elements, so the fp32 temporaries
of the largest leaf stay small; the update is elementwise, so the slices
change no result.

On a rank mesh (``dist.sharding``) params and moments are ``DTensor``
blocks and the gradients this rank's blocks of the global gradient
(``dist.steps.make_train_step``): ``init`` makes each moment a block laid
out like its parameter, ``apply`` updates the blocks in place, and the
global gradient norm counts every logical element once -- each rank
sums the squares of the blocks it holds the first replica of (its
coordinate 0 on every axis the leaf is replicated over), then the sums
are all-reduced over the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..tree import as_tree, leaves, tree_map

_CHUNK = 1 << 24  # elements per slice of a leaf's update


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32  # bf16 for >100B models


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any
    v: Any


def _dist():
    from ..dist import sharding

    return sharding


def init(cfg: AdamWConfig, params: Any) -> AdamWState:
    """Zero moments shaped like ``params`` (a tree or a ``LMParams``), on
    its devices (a ``DTensor`` parameter's moments are blocks laid out
    like it)."""
    tree = as_tree(params)
    shd = _dist()
    device = shd.local(leaves(tree)[0]).device

    def zeros(p):
        if shd._is_dtensor(p):
            mesh = shd.mesh_of(p)
            block = torch.zeros(p.to_local().shape, dtype=cfg.moment_dtype,
                                device=p.to_local().device)
            spec = shd.placements_to_spec(p.placements, mesh, p.dim())
            return shd.from_block(block, shd.NamedSharding(mesh, spec), p.shape)
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, tree),
        v=tree_map(zeros, tree),
    )


def init_specs(cfg: AdamWConfig, param_specs: Any) -> AdamWState:
    """The state's shapes and dtypes on the ``meta`` device (no
    allocation)."""
    def spec(p):
        return torch.empty(p.shape, dtype=cfg.moment_dtype, device="meta")

    return AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        m=tree_map(spec, as_tree(param_specs)),
        v=tree_map(spec, as_tree(param_specs)),
    )


def _chunks(t: torch.Tensor):
    flat = t.view(-1)
    return [flat[i:i + _CHUNK] for i in range(0, flat.numel(), _CHUNK)]


def _first_replica(p) -> bool:
    """Whether this rank holds the first replica of ``p``'s block (always,
    for a tensor that is no ``DTensor``)."""
    shd = _dist()
    if not shd._is_dtensor(p):
        return True
    coords = shd.mesh_of(p).coords
    return all(coords[a] == 0 for a, pl in zip(shd.mesh_of(p).axis_names, p.placements)
               if pl.is_replicate())


@torch.no_grad()
def apply(cfg: AdamWConfig, params: Any, grads: Any, state: AdamWState):
    """-> (params, new_state, grad_norm).  Params keep their dtype; they
    and the state's moments are updated in place and returned."""
    shd = _dist()
    tree = as_tree(params)
    pflat = leaves(tree)
    gflat = leaves(as_tree(grads))
    f32 = torch.float32
    sq = sum(
        sum(torch.sum(torch.square(c.to(f32))) for c in _chunks(g.contiguous()))
        for g, p in zip(gflat, pflat) if _first_replica(p)
    )
    ranked = [p for p in pflat if shd._is_dtensor(p)]
    if ranked:  # the squares of every logical element, once
        from ..dist.collectives import all_reduce

        mesh = shd.mesh_of(ranked[0])
        if not isinstance(sq, torch.Tensor):
            sq = torch.zeros((), dtype=f32, device=mesh.device)
        all_reduce(sq, mesh, mesh.axis_names)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)

    step = shd.local(state.step) + 1
    stepf = step.to(f32)
    bc1 = 1.0 - torch.full((), cfg.b1, dtype=f32, device=stepf.device) ** stepf
    bc2 = 1.0 - torch.full((), cfg.b2, dtype=f32, device=stepf.device) ** stepf

    def upd(p, g, m, v):
        p, m, v = shd.local(p), shd.local(m), shd.local(v)
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g.contiguous()),
                                  _chunks(m), _chunks(v)):
            g32 = gc.to(f32) * scale
            m_new = cfg.b1 * mc.to(f32) + (1 - cfg.b1) * g32
            v_new = cfg.b2 * vc.to(f32) + (1 - cfg.b2) * g32 * g32
            mhat = m_new / bc1
            vhat = v_new / bc2
            p32 = pc.to(f32)
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
            pc.copy_(p32 - cfg.lr * delta)
            mc.copy_(m_new)
            vc.copy_(v_new)

    tree_map(upd, tree, as_tree(grads), state.m, state.v)
    if shd._is_dtensor(state.step):
        step = shd.from_block(step, shd.replicated(shd.mesh_of(state.step)), ())
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm
