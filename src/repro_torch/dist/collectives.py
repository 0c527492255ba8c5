"""The collectives of the LM on a rank mesh (one process per device,
``dist.sharding.make_mesh(..., distributed=True)``): what XLA's
partitioner inserts into the reference's GSPMD step, written out over
``torch.distributed`` (NCCL on the cards, gloo on the CPU).

* ``all_gather`` / ``reduce_scatter`` / ``all_reduce`` over one named
  mesh axis (its ``DeviceMesh`` sub-group).  Every call adds its operand
  bytes (the input of the collective, per device, as an HLO collective's
  operand is counted) to a per-(kind, axis) log: ``counts()`` reads it,
  ``reset_counts()`` clears it.
* ``ShardedLeaf``: a rank's block of one logical parameter inside a
  train step.  Any torch operation on it gathers the whole logical
  tensor first (``gather``, an autograd function: all-gathers in the
  forward; in the backward, a reduce-scatter over every axis the
  gradient is partial over and a slice over the others), so the model
  code runs unchanged on gathered weights: a torch function given the
  leaf (``__torch_function__``), an index, or a tensor method.  Its
  shape, dtype and device are read without a collective.  ``unbind(0)`` of a stacked
  leaf gives one ``ShardedLeaf`` per layer without a collective, so a
  layer loop gathers one layer at a time, inside the layer's
  checkpoint: the recompute gathers again, as FSDP does.
* ``to_model_region`` / ``from_model_region``: the entry and exit of
  the expert-parallel MoE (Megatron's f and g).  The entry is the
  identity forward and sums the gradient over ``model`` backward; the
  exit sums the experts' partial outputs over ``model`` forward (the
  reference's ``psum(yl, "model")``) and is the identity backward.
* ``gather_full``: a ``DTensor`` as its whole logical tensor on every
  rank (a checkpoint's write).

A collective that fails raises; nothing here catches it.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

_LOG: Dict[Tuple[str, str], list] = collections.defaultdict(lambda: [0, 0])


def reset_counts() -> None:
    """Forget every logged collective."""
    _LOG.clear()


def counts() -> Dict[str, dict]:
    """{kind: {"calls", "bytes", "by_axis": {axis: [calls, bytes]}}} of
    the collectives since the last ``reset_counts``; bytes are operand
    bytes on this rank."""
    out: Dict[str, dict] = {}
    for (kind, axis), (calls, nbytes) in sorted(_LOG.items()):
        rec = out.setdefault(kind, {"calls": 0, "bytes": 0, "by_axis": {}})
        rec["calls"] += calls
        rec["bytes"] += nbytes
        rec["by_axis"][axis] = [calls, nbytes]
    return out


def _log(kind: str, axis: str, t: torch.Tensor) -> None:
    rec = _LOG[(kind, axis)]
    rec[0] += 1
    rec[1] += t.numel() * t.element_size()


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``axis``'s group concatenated along ``dim`` in the
    axis's order."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    _log("all-gather", axis, t)
    dist.all_gather(parts, t, group=mesh.group(axis))
    return torch.cat(parts, dim)


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum over ``axis``'s group, split along ``dim``: this rank's
    block (its coordinate on ``axis``)."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    _log("reduce-scatter", axis, src)
    dist.reduce_scatter_tensor(out, src, group=mesh.group(axis))
    return out.movedim(0, dim)


def all_reduce(t: torch.Tensor, mesh, axes: Sequence[str], op=None) -> torch.Tensor:
    """``t`` summed (or reduced by ``op``) in place over the group of
    each of ``axes`` in turn; returns ``t``."""
    for axis in axes:
        if mesh.shape[axis] == 1:
            continue
        _log("all-reduce", axis, t)
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=mesh.group(axis))
    return t


def gather_full(dt) -> torch.Tensor:
    """A ``DTensor`` -> its whole logical tensor on every rank (a plain
    tensor on the rank's device)."""
    from .sharding import mesh_of, placements_to_spec

    mesh = mesh_of(dt)
    spec = placements_to_spec(dt.placements, mesh, dt.dim())
    out = dt.to_local()
    for d, entry in enumerate(spec):
        for axis in reversed(_axes(entry)):
            out = all_gather(out, mesh, axis, d)
    return out


# ---------------------------------------------------------------------------
# a parameter's block inside a rank train step
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """A block -> the logical tensor; the gradient -> the block's."""

    @staticmethod
    def forward(ctx, local, leaf):
        ctx.leaf = leaf
        out = local
        for d, entry in enumerate(leaf.spec):
            for axis in reversed(_axes(entry)):  # minor axis first
                out = all_gather(out, leaf.mesh, axis, d)
        return out

    @staticmethod
    def backward(ctx, g):
        leaf = ctx.leaf
        for d, entry in enumerate(leaf.spec):
            for axis in _axes(entry):  # major axis first
                n = leaf.mesh.shape[axis]
                if n == 1:
                    continue
                if axis in leaf.partial:
                    g = reduce_scatter(g, leaf.mesh, axis, d)
                else:  # every rank of the axis holds the same gradient
                    size = g.shape[d] // n
                    g = g.narrow(d, leaf.mesh.coords[axis] * size, size)
        return g.contiguous(), None


def _gathered(x):
    if isinstance(x, ShardedLeaf):
        return x.gather()
    if isinstance(x, (list, tuple)):
        return type(x)(_gathered(v) for v in x)
    if isinstance(x, dict):
        return {k: _gathered(v) for k, v in x.items()}
    return x


class ShardedLeaf:
    """This rank's block ``local`` of a logical parameter laid out by
    ``spec`` on the rank mesh ``mesh``.  ``partial`` names the mesh axes
    the step's gradient is partial over (the batch axes its rows are
    split over); the gradient of the gathered tensor is summed over
    them where the spec splits the leaf over them (a reduce-scatter) and
    is left partial over the others (the step all-reduces those once per
    step)."""

    __slots__ = ("local", "spec", "mesh", "partial")

    def __init__(self, local: torch.Tensor, spec, mesh, partial: Tuple[str, ...] = ()):
        self.local, self.spec, self.mesh, self.partial = local, tuple(spec), mesh, tuple(partial)

    @property
    def shape(self) -> torch.Size:
        shape = list(self.local.shape)
        for d, entry in enumerate(self.spec):
            shape[d] *= math.prod(self.mesh.shape[a] for a in _axes(entry))
        return torch.Size(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def ndim(self) -> int:
        return self.local.dim()

    def dim(self) -> int:
        return self.local.dim()

    def gather(self) -> torch.Tensor:
        """The logical tensor (differentiable; see the class)."""
        if all(self.mesh.shape[a] == 1 for e in self.spec for a in _axes(e)):
            return self.local
        return _Gather.apply(self.local, self)

    def unbind(self, dim: int = 0):
        """Layer views of a stacked leaf.  A leaf split over its stack dim
        is gathered first (a stacked vector: small)."""
        if dim != 0:
            return self.gather().unbind(dim)
        if self.spec and _axes(self.spec[0]):
            return list(self.gather().unbind(0))
        return [ShardedLeaf(t, self.spec[1:], self.mesh, self.partial)
                for t in self.local.unbind(0)]

    def without_dim0(self) -> "ShardedLeaf":
        """The same block with dim 0 kept local (the expert dim of an EP
        weight): gathering it gathers every other dim."""
        return ShardedLeaf(self.local, (None,) + self.spec[1:], self.mesh, self.partial)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_gathered(args), **_gathered(kwargs or {}))

    def __getattr__(self, name):
        return getattr(self.gather(), name)

    def __getitem__(self, idx):
        return self.gather()[idx]

    def __repr__(self) -> str:
        return f"ShardedLeaf({tuple(self.shape)}, spec={self.spec}, block={tuple(self.local.shape)})"


# ---------------------------------------------------------------------------
# the expert-parallel region (Megatron's f and g over ``model``)
# ---------------------------------------------------------------------------

class _ToModelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.mesh, ("model",)), None


class _FromModelRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        return all_reduce(y.contiguous().clone(), mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_model_region(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (the same on every rank of a ``model`` group) entering a
    region whose ranks each compute a part: the identity, whose gradient
    is summed over ``model``."""
    return _ToModelRegion.apply(x, mesh) if mesh.shape.get("model", 1) > 1 else x


def from_model_region(y: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' partial results summed over ``model`` (the same on
    every rank of the group); the gradient passes through."""
    return _FromModelRegion.apply(y, mesh) if mesh.shape.get("model", 1) > 1 else y
