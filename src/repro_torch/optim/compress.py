"""Gradient compression for the data-parallel all-reduce (int8 + error
feedback), the port of ``repro.optim.compress``.

int8 quantization cuts the all-reduce's bytes 4x vs fp32 (2x vs bf16) at
negligible quality loss when error feedback accumulates the quantization
residual locally (Seide et al. 2014; 1-bit Adam lineage).  ``torch.round``
rounds half to even as ``jnp.round`` does, so the int8 payload and the
scales equal the reference's on the same gradients.

Usage (train loop):
    comp = GradCompressor.init(params)
    grads_q, comp = comp.compress(grads)     # before the reduce
    grads   = comp.decompress(grads_q)       # after the reduce

``compressed_psum`` is the reduce.  Where one process holds every member
of the data axis it takes their ``CompressedGrads`` in axis order; under
``torch.distributed`` each rank passes its own and the axis's process
group (``compressed_psum(cg, group)``): the int8 payloads and scales are
all-gathered and the same fp32 sum is made on every rank, bit-equal to
the list form over the members in rank order.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..tree import as_tree, tree_map


class CompressedGrads(NamedTuple):
    q: Any  # int8 tree
    scale: Any  # fp32 per-leaf scale


class GradCompressor(NamedTuple):
    error: Any  # residual feedback tree (fp32)

    @staticmethod
    def init(params: Any) -> "GradCompressor":
        return GradCompressor(error=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            as_tree(params),
        ))

    @torch.no_grad()
    def compress(self, grads: Any) -> Tuple[CompressedGrads, "GradCompressor"]:
        def one(g, e):
            g32 = g.to(torch.float32) + e
            scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
            q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
            err = g32 - q.to(torch.float32) * scale
            return q, scale, err

        out = tree_map(one, as_tree(grads), self.error)
        q = tree_map(lambda t: t[0], out)
        s = tree_map(lambda t: t[1], out)
        e = tree_map(lambda t: t[2], out)
        return CompressedGrads(q=q, scale=s), GradCompressor(error=e)

    @staticmethod
    def decompress(cg: CompressedGrads) -> Any:
        return tree_map(lambda q, s: q.to(torch.float32) * s, cg.q, cg.scale)


def compressed_psum(members, group=None) -> Any:
    """The all-reduce of the int8 payload (the reference's
    ``compressed_psum`` over an axis): each member's dequantized tree
    ``q * scale``, summed in fp32 in axis order on the first member's
    devices.  Every member of the reference's axis receives this sum.

    ``members`` is the axis's ``CompressedGrads`` in axis order, or this
    rank's own ``CompressedGrads`` with ``group`` the axis's process
    group: the payloads are all-gathered and summed in rank order."""
    if isinstance(members, CompressedGrads):
        return compressed_psum(_gather_members(members, group))
    if group is not None:
        raise ValueError("group= goes with this rank's CompressedGrads, not a list")
    if not members:
        raise ValueError("compressed_psum needs at least one member")
    deq = [GradCompressor.decompress(cg) for cg in members]

    def total(first, *rest):
        out = first.clone()
        for g in rest:
            out.add_(g.to(first.device))
        return out

    return tree_map(total, *deq)


def _gather_members(cg: CompressedGrads, group) -> list:
    """Every rank's ``CompressedGrads`` of ``group``, in rank order."""
    import torch.distributed as dist

    n = dist.get_world_size(group)

    def gather(t):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return parts

    q = tree_map(gather, as_tree(cg.q))
    s = tree_map(gather, as_tree(cg.scale))
    return [CompressedGrads(q=tree_map(lambda parts: parts[r], q),
                            scale=tree_map(lambda parts: parts[r], s))
            for r in range(n)]
