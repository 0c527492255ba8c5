"""Multi-pod dry run, the port of ``repro.launch.dryrun``: trace every
(arch x shape x mesh) cell on the ``meta`` device and derive roofline
terms from the trace.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-7b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--include-tm] [--skip-existing]

Outputs one JSON per cell under experiments/dryrun_torch/.  ``--all``
traces the cells one after another; the recurrent families' per-token
scans take most of an hour per cell, so run those cells as separate
``--arch/--shape`` processes to overlap them.

PyTorch has no ``lower().compile().cost_analysis()``; what stands in:

* **the program** is the port's own step (``dist.steps.make_train_step``
  with the arch's microbatches, ``make_prefill_step``,
  ``make_decode_step``) run once on ``meta`` tensors shaped like the
  family's ``param_specs`` / ``input_specs`` / ``cache_specs`` (and
  ``optim.adamw.init_specs``), with the production mesh installed as the
  activation mesh, so the hints and the expert-parallel MoE take their
  mesh paths.  The mesh is spec arithmetic (``devices="meta"``): nothing
  is placed on any device and nothing touches CUDA, so the dry run runs
  where there is no card.  A decode step's ``pos`` is the Python int
  ``seq_len - 1`` (a ``meta`` scalar has no value; no count depends on
  it);
* **flops** are ``torch.utils.flop_counter.FlopCounterMode``'s count of
  the trace: matrix products (forward, the checkpointed recompute and
  the backward), no elementwise op.  Every loop of the port is a Python
  loop, so every trip of every loop is counted -- XLA counts a ``while``
  body once, which is what the reference's corrections repair;
* **bytes** are every aten op's input and output bytes (a
  ``TorchDispatchMode``; a broadcast dim counts once; view and
  allocation ops count nothing): the same unfused upper bound as
  XLA-CPU's ``bytes accessed``;
* **memory**: argument, output and alias sizes from the spec trees and
  their shardings (``_memory_of``): the bytes of each leaf's shard,
  donated buffers (a train step's params and optimizer state, a decode
  step's cache) as alias; temp is the peak of the live bytes of the
  storages the trace creates (outputs built in the trace included),
  divided by the chips;
* **collectives**: ``dist.sharding.spec_collective_bytes``, from the
  sharding rules (the port has no HLO).

**Per device.**  The trace is the logical (global) program; its flops,
bytes and temp are divided by the chips.  That is exact for work the
specs shard over every axis.  Work they leave replicated is
under-counted per device: ops on activations sharded over the batch
axes only (norms, elementwise ops, attention under ``attn_tp=False``,
the router) are repeated on every ``model`` tile, and a batch that no
axis divides (``long_500k``'s B = 1) is repeated on every chip.

**Depth.**  ``run_cell`` traces the u = 1 and u = 2 variants of the
cell (``_unit_variant``) and extrapolates the trace's counts to the real
depth, as the reference does; here it only keeps each trace short (the
trace is affine in depth: tests hold u = 3 to the extrapolation).  The
argument, output and alias sizes need no trace and come from the
full-depth spec trees.
``scan_correction_flops_per_device`` is recorded, not added
(``analysis.corrections``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..analysis.corrections import scan_correction_flops
from ..analysis.roofline import build_roofline, cost_analysis_dict, model_flops
from ..configs.base import ShapeSpec, shape_by_name, shapes_for
from ..configs.registry import all_arch_names, get
from ..dist import sharding as shd
from ..dist.steps import make_decode_step, make_prefill_step, make_train_step, opt_config_for
from ..models.api import active_params, family_for
from ..models.common import meta
from ..optim import adamw
from .mesh import make_production_mesh

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# ops that move no bytes: allocation and reinterpretation (views are
# recognised by their schema)
_FREE_OPS = {
    torch.ops.aten.empty.memory_format,
    torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default,
    torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
    torch.ops.aten._unsafe_view.default,
    torch.ops.aten.lift_fresh.default,
}


def _touched_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses: a broadcast (stride 0) dim
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


class _TraceMode(TorchDispatchMode):
    """Counts every aten op's input and output bytes (``nbytes``) and the
    peak of the live bytes of storages created under the mode
    (``peak``).  A storage's life ends when its ``UntypedStorage``
    object is finalized: PyTorch keeps that object alive as long as the
    storage lives, also when only the autograd graph holds it.  Storages
    of ``args`` (the step's arguments) are not counted as live."""

    def __init__(self, args):
        super().__init__()
        self.nbytes = 0
        self.live = 0
        self.peak = 0
        self._args = {t.untyped_storage()._cdata for t in tree_leaves(args)
                      if isinstance(t, torch.Tensor)}
        self._tracked = {}

    def _free(self, key, n):
        if self._tracked.pop(key, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _FREE_OPS or func.is_view:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.nbytes += sum(_touched_bytes(t) for t in tree_leaves((args, kwargs))
                           if isinstance(t, torch.Tensor))
        self.nbytes += sum(_touched_bytes(t) for t in outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._args or key in self._tracked:
                continue
            n = st.nbytes()
            self._tracked[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


def _shard_bytes(specs, shardings) -> float:
    """Bytes of every leaf's shard: its bytes over the product of the
    mesh axes its spec names."""
    if specs is None:
        return 0.0
    if isinstance(specs, torch.Tensor):
        sizes = shd._axis_sizes(shardings.mesh)
        n = math.prod(sizes[a] for e in shardings.spec if e is not None
                      for a in ((e,) if isinstance(e, str) else e))
        return specs.numel() * specs.element_size() / n
    if isinstance(specs, dict):
        return sum(_shard_bytes(specs[k], shardings[k]) for k in specs)
    return sum(_shard_bytes(a, b) for a, b in zip(specs, shardings))


@dataclasses.dataclass
class _MemoryStats:
    """Per-device sizes, the fields of XLA's ``CompiledMemoryStats`` the
    records keep."""

    argument_size_in_bytes: float
    output_size_in_bytes: float
    temp_size_in_bytes: float
    alias_size_in_bytes: float


class _CompiledCell:
    """The analysed cell: ``cost_analysis()`` -> ``{"flops", "bytes
    accessed"}`` per device, ``memory_analysis()`` -> per-device sizes,
    ``collective_bytes()`` -> per-device collective operand bytes by
    kind (in place of the reference's ``as_text()``)."""

    def __init__(self, low):
        chips = low.mesh.size
        self._memory = _MemoryStats(temp_size_in_bytes=low.peak / chips,
                                    **_memory_of(low.cfg, low.shape, low.mesh))
        self._cost = {"flops": low.flops / chips, "bytes accessed": low.nbytes / chips}
        self._coll = shd.spec_collective_bytes(
            low.cfg, low.shape, low.mesh,
            {"params": low.param_specs, "inputs": low.input_specs})

    def cost_analysis(self):
        return cost_analysis_dict(self._cost)

    def memory_analysis(self):
        return self._memory

    def collective_bytes(self):
        return dict(self._coll)


class _LoweredCell:
    """One traced step: its global counts (``flops``, ``nbytes``, the
    ``peak`` of live bytes) and the cell it traced."""

    def __init__(self, **fields):
        self.__dict__.update(fields)

    def compile(self):
        return _CompiledCell(self)


def lower_cell(cfg, shape: ShapeSpec, mesh):
    """Trace this cell's step on ``meta`` tensors (nothing is allocated).

    The activation mesh is installed only for the duration of the trace
    (restored on exit) so repeated dry-run cells -- or anything run later
    in the same process -- never see a stale mesh."""
    prev_mesh = shd._ACTIVATION_MESH
    try:
        return _lower_cell(cfg, shape, mesh)
    finally:
        shd.set_activation_mesh(prev_mesh)


def _lower_cell(cfg, shape: ShapeSpec, mesh):
    shd.set_activation_mesh(mesh)
    fam = family_for(cfg)
    p_specs = fam.param_specs(cfg)
    in_specs = fam.input_specs(cfg, shape)
    if shape.kind == "train":
        opt_cfg = opt_config_for(cfg)
        step = make_train_step(cfg, opt_cfg, microbatches=cfg.train_microbatches,
                               device="meta")
        args = call = (p_specs, adamw.init_specs(opt_cfg, p_specs), in_specs)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg)
        args = call = (p_specs, in_specs)
    else:
        step = make_decode_step(cfg)
        args = (p_specs, fam.cache_specs(cfg, shape), in_specs)
        # a meta scalar has no value: the decode position goes in as an int
        call = (*args[:2], {k: (shape.seq_len - 1 if k == "pos" else v)
                            for k, v in in_specs.items()})
    with FlopCounterMode(display=False) as fc, _TraceMode(args) as tm:
        step(*call)
    return _LoweredCell(cfg=cfg, shape=shape, mesh=mesh, param_specs=p_specs,
                        input_specs=in_specs, flops=fc.get_total_flops(),
                        nbytes=tm.nbytes, peak=tm.peak)


def _unit_count(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm_xlstm":
        return cfg.n_layers // 2
    return cfg.n_layers


def _unit_variant(cfg, u: int):
    """Depth-u analysis variant.  ``analysis_unroll`` is kept for the
    records: the port's layer loops are Python loops already."""
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, n_layers=u * cfg.attn_every, analysis_unroll=True
        )
    if cfg.family == "ssm_xlstm":
        return dataclasses.replace(cfg, n_layers=2 * u, analysis_unroll=True)
    if cfg.family == "encdec":
        return dataclasses.replace(
            cfg, n_layers=u, n_encoder_layers=u, analysis_unroll=True
        )
    return dataclasses.replace(cfg, n_layers=u, analysis_unroll=True)


def _cell_metrics(cfg, shape, mesh) -> dict:
    t0 = time.time()
    lowered = lower_cell(cfg, shape, mesh)
    t1 = time.time()
    compiled = lowered.compile()
    t2 = time.time()
    cost = compiled.cost_analysis()
    return {
        "flops": float(cost.get("flops", 0.0)),
        "bytes": float(cost.get("bytes accessed", 0.0)),
        "temp": compiled.memory_analysis().temp_size_in_bytes,
        "coll": {k: float(v) for k, v in compiled.collective_bytes().items()},
        "lower_s": t1 - t0,
        "compile_s": t2 - t1,
    }


def _memory_of(cfg, shape, mesh) -> dict:
    """Argument, output and alias bytes per device of the cell, from its
    spec trees alone: a train step takes and returns the params and the
    optimizer state (donated) plus the fp32 loss and grad norm; a
    prefill returns the last position's logits ``[B, V]`` (the tied
    readout's rows) and the cache ``cache_specs`` describes; a decode
    step takes and returns the cache (donated) and returns one int32
    token per sequence."""
    fam = family_for(cfg)
    p_specs = fam.param_specs(cfg)
    p_sh = shd.param_shardings(cfg, mesh, p_specs)
    in_specs = fam.input_specs(cfg, shape)
    in_bytes = _shard_bytes(in_specs, shd.input_shardings(cfg, mesh, shape, in_specs))
    params = _shard_bytes(p_specs, p_sh)
    if shape.kind == "train":
        o_specs = adamw.init_specs(opt_config_for(cfg), p_specs)
        state = params + _shard_bytes(o_specs, shd.opt_shardings(cfg, mesh, o_specs, p_sh))
        return {"argument_size_in_bytes": state + in_bytes,
                "output_size_in_bytes": state + 8.0,
                "alias_size_in_bytes": state}
    c_specs = fam.cache_specs(cfg, shape)
    cache = _shard_bytes(c_specs, shd.cache_shardings(cfg, mesh, shape, c_specs))
    if shape.kind == "prefill":
        embed = p_specs["embed"]
        logits = {"logits": meta((shape.global_batch, embed.shape[0]), embed.dtype)}
        out = _shard_bytes(logits, shd.input_shardings(cfg, mesh, shape, logits))
        return {"argument_size_in_bytes": params + in_bytes,
                "output_size_in_bytes": out + cache, "alias_size_in_bytes": 0.0}
    bx = shd.batch_axes(mesh, shape.global_batch) or ()
    tok = 4.0 * shape.global_batch / math.prod(shd._axis_sizes(mesh)[a] for a in bx)
    return {"argument_size_in_bytes": params + cache + in_bytes,
            "output_size_in_bytes": tok + cache, "alias_size_in_bytes": cache}


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True, *,
             shape: ShapeSpec = None, mesh=None, mesh_name: str = None,
             out_dir=OUT_DIR) -> dict:
    """Trace the u=1 / u=2 variants of the cell and extrapolate to the
    real depth (see the module docstring); write the record to
    ``out_dir`` (None: do not write).  ``shape`` / ``mesh`` (with
    ``mesh_name``) replace the named shape and the production mesh."""
    cfg = get(arch)
    shape = shape or shape_by_name(shape_name)
    shape_name = shape.name
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, devices="meta")
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = mesh.size

    # layer-count extrapolation (u=1, u=2)
    units = _unit_count(cfg)
    m1 = _cell_metrics(_unit_variant(cfg, 1), shape, mesh)
    m2 = _cell_metrics(_unit_variant(cfg, 2), shape, mesh)

    def extrap(a, b):
        return a + (units - 1) * (b - a)

    corr = scan_correction_flops(cfg, shape) / chips  # recorded, not added
    flops_x = extrap(m1["flops"], m2["flops"])
    bytes_x = extrap(m1["bytes"], m2["bytes"])
    coll_kinds = {
        k: extrap(m1["coll"].get(k, 0.0), m2["coll"].get(k, 0.0))
        for k in set(m1["coll"]) | set(m2["coll"])
    }
    cost = {"flops": flops_x, "bytes accessed": bytes_x}

    mem = {**_memory_of(cfg, shape, mesh), "temp_size_in_bytes": extrap(m1["temp"], m2["temp"])}

    mf = model_flops(cfg, shape, active_params(cfg))
    rl = build_roofline(
        arch=arch,
        shape=shape_name,
        mesh_name=mesh_name,
        chips=chips,
        cost=cost,
        collectives=coll_kinds,
        model_flops_global=mf,
        memory_analysis=mem,
    )

    rec = json.loads(rl.to_json())
    rec["raw_full_cost"] = {"flops": flops_x, "bytes": bytes_x}
    rec["scan_correction_flops_per_device"] = corr
    rec["lower_s"] = round(m1["lower_s"] + m2["lower_s"], 2)
    rec["compile_s"] = round(m1["compile_s"] + m2["compile_s"], 2)
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        out = out_dir / f"{arch}_{shape_name}_{mesh_name}.json"
        out.write_text(json.dumps(rec, indent=1))
    if verbose:
        ma = rec["memory_analysis"]
        print(
            f"[OK] {arch} x {shape_name} x {mesh_name}: "
            f"trace {rec['lower_s'] + rec['compile_s']:.2f}s  "
            f"args/device {ma.get('argument_size_in_bytes', 0)/1e9:.2f} GB  "
            f"temp/device {ma.get('temp_size_in_bytes', 0)/1e9:.2f} GB  "
            f"t_comp {rl.t_compute*1e3:.2f}ms t_mem {rl.t_memory*1e3:.2f}ms "
            f"t_coll {rl.t_collective*1e3:.2f}ms -> {rl.bottleneck}",
            flush=True,
        )
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-tm", action="store_true",
                    help="also dry-run the TM (paper) sharded configs")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    cells = []
    if args.all:
        for name in all_arch_names():
            cfg = get(name)
            for s in shapes_for(cfg):
                cells.append((name, s.name))
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        cells = [(args.arch, args.shape)]

    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    failures = []
    for arch, sname in cells:
        if args.skip_existing and (OUT_DIR / f"{arch}_{sname}_{mesh_name}.json").exists():
            print(f"[SKIP] {arch} x {sname} (exists)", flush=True)
            continue
        try:
            run_cell(arch, sname, args.multi_pod)
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, sname, repr(e)))
            print(f"[FAIL] {arch} x {sname}: {e!r}", flush=True)

    if args.include_tm:
        from ..dist.tm_sharded import dryrun_tm

        for tm_name in ("tm-paper", "tm-xl"):
            try:
                rec = dryrun_tm(tm_name, multi_pod=args.multi_pod, out_dir=OUT_DIR)
                print(f"[OK] {tm_name}: {rec['bottleneck']}", flush=True)
            except Exception as e:
                failures.append((tm_name, "-", repr(e)))
                print(f"[FAIL] {tm_name}: {e!r}", flush=True)

    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", *f)
        sys.exit(1)
    print(f"\nall {len(cells)} cells OK")


if __name__ == "__main__":
    main()
