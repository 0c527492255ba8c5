"""Aggregate the port's dry-run JSONs (``experiments/dryrun_torch/``)
into roofline tables on H100 constants, the port of
``repro.analysis.report``.

Adds the fused-memory lower bound: the dry run's ``bytes accessed``
counts every input and output of every aten op (an UNFUSED upper bound
on HBM traffic, as XLA-CPU's is).  The fused lower bound models perfect
producer-consumer fusion: every live buffer moves once each way,

    bytes_lower ~= argument + output + 2 * temp   (memory_analysis sizes)

The true number lies between; the bottleneck is classified with the
lower bound and both are reported.  Each row also gives the cell's trace
seconds (``lower_s + compile_s``); ``summary`` puts both meshes' bounds
and trace seconds in one row per arch.

    PYTHONPATH=src python -m repro_torch.analysis.report > docs/dryrun_torch.md
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

from ..configs.base import ALL_SHAPES
from .roofline import HBM_BW, PEAK_FLOPS

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
DRYRUN_DIR = os.path.join(HERE, "experiments", "dryrun_torch")

SKIPPED_LONG = [
    ("starcoder2-7b", "full attention is O(S^2); no published sub-quadratic variant"),
    ("stablelm-12b", "full attention"),
    ("deepseek-7b", "full attention"),
    ("stablelm-3b", "full attention"),
    ("llama4-maverick-400b-a17b", "full attention"),
    ("moonshot-v1-16b-a3b", "full attention"),
    ("whisper-medium", "full-attention decoder"),
    ("internvl2-26b", "full attention"),
]


def enrich(d: Dict) -> Dict:
    ma = d.get("memory_analysis", {})
    lower = (
        ma.get("argument_size_in_bytes", 0)
        + ma.get("output_size_in_bytes", 0)
        + 2 * ma.get("temp_size_in_bytes", 0)
    )
    d["t_memory_lower"] = lower / HBM_BW
    d["t_memory_upper"] = d["t_memory"]
    terms = {
        "compute": d["t_compute"],
        "memory": d["t_memory_lower"],
        "collective": d["t_collective"],
    }
    d["bottleneck_fused"] = max(terms, key=terms.get)
    t_bound = max(terms.values())
    mf = d.get("model_flops_global", 0)
    d["peak_fraction_fused"] = (
        mf / (d["chips"] * PEAK_FLOPS * t_bound) if t_bound > 0 and mf > 0 else 0.0
    )
    return d


def load(mesh: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(DRYRUN_DIR, f"*_{mesh}.json"))):
        d = json.load(open(f))
        if "t_compute" not in d:
            continue
        out.append(enrich(d))
    return out


def ms(x: float) -> str:
    return f"{x * 1e3:.1f}"


def table(mesh: str) -> str:
    rows = load(mesh)
    hdr = (
        "| arch | shape | t_comp ms | t_mem ms [fused..unfused] | t_coll ms "
        "| bottleneck | MODEL/HLO flops | peak frac | HBM/dev GB | trace s |\n"
        "|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for d in rows:
        ma = d.get("memory_analysis", {})
        hbm = (ma.get("argument_size_in_bytes", 0)
               + ma.get("temp_size_in_bytes", 0)) / 1e9
        lines.append(
            f"| {d['arch']} | {d['shape']} | {ms(d['t_compute'])} "
            f"| {ms(d['t_memory_lower'])}..{ms(d['t_memory_upper'])} "
            f"| {ms(d['t_collective'])} | {d['bottleneck_fused']} "
            f"| {d.get('useful_flops_ratio', 0):.2f} "
            f"| {100 * d.get('peak_fraction_fused', 0):.1f}% | {hbm:.1f} "
            f"| {d.get('lower_s', 0) + d.get('compile_s', 0):.2f} |"
        )
    skip = "\n".join(
        f"| {a} | long_500k | — | — | — | SKIP ({why}) | — | — | — | — |"
        for a, why in SKIPPED_LONG
    )
    return hdr + "\n".join(lines) + "\n" + skip + "\n"


MESHES = ("pod16x16", "pod2x16x16")


def summary() -> str:
    """One row per arch, one column per shape: each mesh's bound
    ``max(t_compute, t_memory_lower, t_collective)`` in ms with its fused
    bottleneck, then each mesh's trace seconds (``lower_s + compile_s``)."""
    cells = {(d["arch"], d["shape"], m): d for m in MESHES for d in load(m)}
    shapes = [s.name for s in ALL_SHAPES]
    archs = sorted({a for a, sh, _ in cells if sh in shapes})
    skipped = {a for a, _ in SKIPPED_LONG}
    hdr = ("| arch | " + " | ".join(shapes) + " |\n|---|"
           + "---|" * len(shapes) + "\n")
    lines = []
    for a in archs:
        out = []
        for sh in shapes:
            ds = [cells.get((a, sh, m)) for m in MESHES]
            if not any(ds):
                out.append("SKIP" if sh == "long_500k" and a in skipped else "—")
                continue
            bound = " / ".join(
                f"{d['bottleneck_fused'][:4]} "
                f"{1e3 * max(d['t_compute'], d['t_memory_lower'], d['t_collective']):,.2f}"
                if d else "—" for d in ds)
            secs = " / ".join(f"{d.get('lower_s', 0) + d.get('compile_s', 0):,.0f}"
                              if d else "—" for d in ds)
            out.append(f"{bound} ms; {secs} s")
        lines.append(f"| {a} | " + " | ".join(out) + " |")
    return hdr + "\n".join(lines) + "\n"


def main():
    for mesh in MESHES:
        rows = load(mesh)
        if not rows:
            continue
        print(f"\n### Mesh {mesh} ({rows[0]['chips']} chips)\n")
        print(table(mesh))
    print(f"\n### Bounds per cell, {' / '.join(MESHES)}\n")
    print(summary())


if __name__ == "__main__":
    main()
