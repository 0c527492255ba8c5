"""Analytic corrections for XLA cost-analysis under-counting, the
port's copy of ``repro.analysis.corrections`` (the same arithmetic, so
the port's records state the reference's correction for every cell).

XLA's ``cost_analysis()`` counts a while-loop body ONCE, not trip_count
times.  The reference recovers the true totals in two ways:

1. **Layer-stack extrapolation** (``launch/dryrun.py``): metrics are
   affine in the unit count u, m(u) = intercept + u * per_unit, so the
   u=1 and u=2 variants extrapolate to the real depth.

2. **Within-layer scan corrections** (this module): loops nested inside
   a single layer body are still counted once.  The offenders and their
   closed-form additions (GLOBAL flops; caller divides by chip count):

   * streaming attention over nB KV blocks (models/common.py):
       add (nB-1)/nB * 4*B*Sq*Skv_pad*Hq*hd per layer application
       (blocks are computed densely -- masked positions are still MACs)
   * mLSTM chunk scan over nC chunks (models/xlstm.py):
       intra-chunk  4*B*S*Q*H*hd  +  state einsums  4*B*S*H*hd^2
   * sLSTM per-token scan (S steps):   (S-1) * (8*B*D^2 + 8*B*H*hd^2)
   * xLSTM prefill per-token scans:    (S-1) * (8*B*D^2 + 6*B*H*hd^2) * 2
   * Mamba2 inter-chunk scan: body is elementwise state decay (~B*H*N*P)
     -- negligible, NOT corrected.

   Training multiplies by MULT_TRAIN = 4 (forward + remat-forward + ~2x
   backward); prefill by 1; decode paths contain no within-layer scans.

**The port records this value and does not add it.**  Its dry run
counts a trace on the ``meta`` device, where every loop is a Python loop
and every trip is counted, so the within-layer loops are already in its
flops; adding the correction would count them twice.  The dry-run
record keeps it as ``scan_correction_flops_per_device`` so the two
packages' records can be compared.
"""

from __future__ import annotations

import math

from ..configs.base import ArchConfig, ShapeSpec
from ..models.common import ATTN_CHUNK, ATTN_CHUNK_THRESHOLD

MULT_TRAIN = 4.0
MLSTM_CHUNK = 256


def _attn_correction(B, Sq, Skv, Hq, hd, n_apps: float, mult: float) -> float:
    if Sq <= 1 or Skv <= ATTN_CHUNK_THRESHOLD:
        return 0.0  # plain path: fully counted
    nB = math.ceil(Skv / ATTN_CHUNK)
    skv_pad = nB * ATTN_CHUNK
    full = 4.0 * B * Sq * skv_pad * Hq * hd
    return n_apps * mult * full * (nB - 1) / nB


def scan_correction_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Additive GLOBAL flops missing from the layer-extrapolated metrics."""
    B = shape.global_batch
    S = shape.seq_len
    mult = MULT_TRAIN if shape.kind == "train" else 1.0
    if shape.kind == "decode":
        return 0.0

    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return _attn_correction(
            B, S, S, cfg.n_heads, cfg.head_dim, cfg.n_layers, mult
        )
    if fam == "encdec":
        # decoder self-attention only (encoder S=1500 and cross-attn use the
        # plain, fully-counted path)
        return _attn_correction(
            B, S, S, cfg.n_heads, cfg.head_dim, cfg.n_layers, mult
        )
    if fam == "hybrid":
        g = cfg.n_layers // cfg.attn_every
        return _attn_correction(B, S, S, cfg.n_heads, cfg.head_dim, g, mult)
    if fam == "ssm_xlstm":
        pairs = cfg.n_layers // 2
        D = cfg.d_model
        H = cfg.n_heads
        hd = D // H
        if shape.kind == "train":
            Q = min(MLSTM_CHUNK, S)
            nC = S // Q
            f_mlstm = 4.0 * B * S * Q * H * hd + 4.0 * B * S * H * hd * hd
            f_slstm = (S - 1.0) * (8.0 * B * D * D + 8.0 * B * H * hd * hd)
            return pairs * mult * (f_mlstm * (nC - 1) / max(nC, 1) + f_slstm)
        # prefill: per-token decode-step scans for both cores
        f_step = (8.0 * B * D * D + 6.0 * B * H * hd * hd) + (
            8.0 * B * D * D + 8.0 * B * H * hd * hd
        )
        return pairs * (S - 1.0) * f_step
    return 0.0
