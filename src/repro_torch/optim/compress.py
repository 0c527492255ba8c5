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

``compressed_psum`` is the reduce: one process holds every member of the
data axis, so it takes their ``CompressedGrads`` in axis order.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence, Tuple

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


def compressed_psum(members: Sequence[CompressedGrads]) -> Any:
    """The all-reduce of the int8 payload (the reference's
    ``compressed_psum`` over an axis): each member's dequantized tree
    ``q * scale``, summed in fp32 in axis order on the first member's
    devices.  Every member of the reference's axis receives this sum."""
    if not members:
        raise ValueError("compressed_psum needs at least one member")
    deq = [GradCompressor.decompress(cg) for cg in members]

    def total(first, *rest):
        out = first.clone()
        for g in rest:
            out.add_(g.to(first.device))
        return out

    return tree_map(total, *deq)
