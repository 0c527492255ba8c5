"""Roofline terms of a dry-run cell on NVIDIA H100 SXM cards, the port
of ``repro.analysis.roofline`` (whose constants are a TPU v5e's).

Hardware constants, one H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU
datasheet; dense rates, no sparsity):

    PEAK_FLOPS       989.4e12  bf16 tensor-core FLOP/s
    PEAK_FP32_FLOPS   67e12    fp32 FLOP/s outside the tensor cores (the
                               highest rate the datasheet gives beside
                               the tensor-core ones; no int32 ALU rate
                               is published, so integer work uses it too)
    PEAK_INT8_OPS   1979e12    int8 tensor-core op/s
    HBM_BW          3.35e12    HBM3 bytes/s
    NVLINK_BW        450e9     NVLink 4 bytes/s per direction per GPU
                               (18 links x 25 GB/s) inside one 8-GPU
                               HGX/DGX node (NVSwitch, all to all)
    NDR_BW            50e9     one 400 Gb/s InfiniBand NDR port per GPU
                               (ConnectX-7) between nodes

The collective term uses the slowest link the mesh crosses
(``link_bw``): NVLink up to ``NVLINK_DOMAIN`` = 8 chips, NDR beyond.

The dry run (``launch.dryrun``) counts the logical program on the
``meta`` device and divides by the chips, so its flops and bytes are per
device, as the reference's per-device SPMD costs are.  The port has no
post-partitioning HLO: ``collective_bytes`` parses the reference's HLO
text (kept for the reference's records and tests), and the dry run takes
per-device collective operand bytes from the sharding rules instead
(``dist.sharding.spec_collective_bytes``); this module only prices them.
Terms (seconds):

    compute    = flops_per_device / PEAK_FLOPS   (integer work: PEAK_FP32_FLOPS)
    memory     = hbm_bytes_per_device / HBM_BW
    collective = collective_operand_bytes_per_device / link_bw(chips)
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, Optional

PEAK_FLOPS = 989.4e12  # bf16 tensor core / card
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores / card
PEAK_INT8_OPS = 1979e12  # int8 tensor core / card
HBM_BW = 3.35e12  # bytes/s / card
NVLINK_BW = 450e9  # bytes/s per direction / card, inside an 8-card node
NDR_BW = 50e9  # bytes/s / card across nodes (one 400 Gb/s NDR port)
NVLINK_DOMAIN = 8  # cards joined by NVLink in one node


def link_bw(chips: int) -> float:
    """Bytes/s per card of the slowest link a mesh of ``chips`` crosses."""
    return NVLINK_BW if chips <= NVLINK_DOMAIN else NDR_BW


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_DEF_RE = re.compile(
    r"^\s*(?:ROOT\s+)?(%[\w.\-]+)\s*=\s*((?:\([^=]*?\)|[\w\[\],{}\/ ]+?))\s+([\w\-]+)\("
)
_TYPE_RE = re.compile(
    r"(pred|bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|u64)\[([0-9,]*)\]"
)
_OPERAND_RE = re.compile(r"\((%[\w.\-]+(?:,\s*%[\w.\-]+)*)?\)")


def cost_analysis_dict(cost) -> Dict[str, float]:
    """A cost (the dry run's ``{"flops", "bytes accessed"}`` dict, or a
    one-element list of one, as jax 0.4.x returned) -> one flat dict of
    floats."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return {k: float(v) for k, v in cost.items()}


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def _types_bytes(type_str: str) -> int:
    return sum(_shape_bytes(t, d) for t, d in _TYPE_RE.findall(type_str))


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum OPERAND bytes of every collective op of an HLO text, per kind
    (per-device).

    Post-partitioning HLO lists operands by name only, so this is a
    two-pass parse: 1) map op name -> result type, 2) resolve collective
    operand names.  ``-start`` async halves are counted; their ``-done``
    halves are not.
    """
    defs: Dict[str, str] = {}
    lines = hlo_text.splitlines()
    for line in lines:
        m = _DEF_RE.match(line)
        if m:
            defs[m.group(1)] = m.group(2)
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for line in lines:
        m = _DEF_RE.match(line)
        if not m:
            continue
        op = m.group(3)
        kind = op[: -len("-start")] if op.endswith("-start") else op
        if kind not in _COLLECTIVES:
            continue
        rest = line[m.end() - 1 :]
        om = _OPERAND_RE.search(rest)
        operands = []
        if om and om.group(1):
            operands = [o.strip() for o in om.group(1).split(",")]
        got = 0
        for name in operands:
            if name in defs:
                got += _types_bytes(defs[name])
        if got == 0:  # fallback: result size (== operand size for all-reduce)
            got = _types_bytes(m.group(2))
        out[kind] += got
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    collective_by_kind: Dict[str, int]
    model_flops_global: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    useful_flops_ratio: float
    peak_fraction: float  # model_flops / (chips * PEAK * t_bound)
    memory_analysis: Dict[str, float]

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)


def build_roofline(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    cost: Dict[str, float],
    hlo_text: str = "",
    model_flops_global: float,
    memory_analysis: Optional[Dict[str, float]] = None,
    collectives: Optional[Dict[str, float]] = None,
    peak_flops: float = PEAK_FLOPS,
) -> Roofline:
    """The roofline of one cell.  Collective bytes per kind come from
    ``collectives`` when given (the dry run's ``spec_collective_bytes``),
    else from parsing ``hlo_text`` as the reference does.  ``t_compute``
    prices the flops at ``peak_flops`` (``dryrun_tm`` gives its integer
    work ``PEAK_FP32_FLOPS``); ``peak_fraction`` is always against
    ``PEAK_FLOPS``, as the reference's and ``report.enrich``'s are."""
    cost = cost_analysis_dict(cost)
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    coll = collectives if collectives is not None else collective_bytes(hlo_text)
    coll_total = float(sum(coll.values()))
    t_c = flops / peak_flops
    t_m = hbm / HBM_BW
    t_x = coll_total / link_bw(chips)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    t_bound = max(t_c, t_m, t_x)
    useful = model_flops_global / (flops * chips) if flops > 0 else 0.0
    peak_frac = (
        model_flops_global / (chips * PEAK_FLOPS * t_bound) if t_bound > 0 else 0.0
    )
    return Roofline(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=flops,
        hbm_bytes_per_device=hbm,
        collective_bytes_per_device=coll_total,
        collective_by_kind={k: int(v) for k, v in coll.items() if v},
        model_flops_global=model_flops_global,
        t_compute=t_c,
        t_memory=t_m,
        t_collective=t_x,
        bottleneck=bottleneck,
        useful_flops_ratio=useful,
        peak_fraction=peak_frac,
        memory_analysis=memory_analysis or {},
    )


def model_flops(cfg, shape, n_params_active: int) -> float:
    """6·N·D for training, 2·N·D for inference steps (dense approximation;
    MoE uses active params)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tokens
    # decode: one token per sequence
    return 2.0 * n_params_active * shape.global_batch
