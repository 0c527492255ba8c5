"""Mesh-sharded compressed-TM inference, the port of
``repro.dist.tm_sharded``: the paper's multi-core class split (Fig 7) on a
(data, model) mesh of the port (``dist.sharding.Mesh``).

Layout (one fixed layout per deployment, as in the reference):

  * classes shard over ``model``: each tile holds the clause tables of its
    class slice only;
  * the batch shards over the non-model axes (``sharding.batch_axes``);
  * each tile computes its disjoint [B_l, M_l] block of the global [B, M]
    class sums, so assembling the output needs no collective.

One process drives every tile; a tile runs on its mesh device, and the
blocks are assembled on the mesh's first device.  On a CUDA device a tile
is one launch of the hand-written ``clause_table`` kernel over the tile's
literals packed to 32-bit words with an all-ones row; on the CPU, its
plain twin.

The three local executors over ``decode_to_plan`` output are plain
PyTorch, equal to the reference's on the same operands:

  _local_plan_executor             include-major over CHUNK-sized blocks
                                   of the include list, scatter-min clause
                                   accumulation (clauses may span chunks)
  _local_plan_executor_packed      the same stream over pack_literals
                                   words, a running AND emitted at
                                   seg_last, carried across chunks
  _local_plan_executor_clausemajor clause-major padded include table, an
                                   AND over each row's slots
                                   (``kernels.clause_table.ref``)

``dryrun_tm`` is the ``--include-tm`` path of ``launch.dryrun``: the
roofline of the executor on the production mesh, from the config's
capacities (no trace: its work is integer ANDs, which
``FlopCounterMode`` does not count).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..core.bits import segmented_and_scan
from ..core.tm import literals, pack_columns, unpack_bits
from ..kernels.clause_table import clause_major_sums, clause_table, scatter_classes_
from .sharding import _axis_sizes, _pad_to, batch_axes, batch_shards

# Includes processed per streaming step of the include-major executors
# (tests shrink it to force chunk-spanning clauses).
CHUNK = 512


def _chunk_of(I_cap: int) -> int:
    chunk = min(CHUNK, I_cap)
    if chunk and I_cap % chunk:
        raise ValueError(f"include capacity {I_cap} is not a multiple of the "
                         f"chunk {chunk}")
    return max(chunk, 1)


# ---------------------------------------------------------------------------
# local (single-shard) plan executors
# ---------------------------------------------------------------------------

def _local_plan_executor(lit_idx, cid, clause_class, clause_pol, lits):
    """Include-major executor over an unpacked literal matrix.

    lit_idx      int32[I_cap]  absolute literal slots, padded with 0
    cid          int32[I_cap]  global clause id; padded slots -> NCL (sink)
    clause_class int32[NCL]    class of each clause
    clause_pol   int32[NCL]    +1 / -1
    lits         {0,1}[B, 2F]  interleaved literal matrix
    -> int32[NCL, B] class sums (rows >= n_classes are zero)

    Streams the include list in CHUNK-sized blocks; each block
    scatter-mins into a clause accumulator, so clauses spanning block
    boundaries combine.  Clauses that never receive an include output 0."""
    lits = torch.as_tensor(lits)
    dev = lits.device
    lit_idx = torch.as_tensor(lit_idx, device=dev).to(torch.int64)
    cid = torch.as_tensor(cid, device=dev).to(torch.int64)
    pol = torch.as_tensor(clause_pol, device=dev).to(torch.int32)
    B = lits.shape[0]
    NCL = pol.shape[0]
    chunk = _chunk_of(lit_idx.shape[0])
    lt = lits.to(torch.int32).T  # [2F, B]
    acc = torch.ones((NCL + 1, B), dtype=torch.int32, device=dev)
    cnt = torch.zeros(NCL + 1, dtype=torch.int64, device=dev)
    for c0 in range(0, lit_idx.shape[0], chunk):
        c = cid[c0:c0 + chunk]
        c = torch.where((c < 0) & (c >= -(NCL + 1)), c + NCL + 1, c)
        keep = (c >= 0) & (c <= NCL)  # the reference's scatter drops the rest
        c, s = c[keep], lt[lit_idx[c0:c0 + chunk][keep]]
        acc.scatter_reduce_(0, c[:, None].expand(-1, B), s, "amin")
        cnt.index_add_(0, c, torch.ones_like(c))
    clause_out = torch.where(cnt[:NCL, None] > 0, acc[:NCL], 0)
    out = torch.zeros((NCL, B), dtype=torch.int32, device=dev)
    return scatter_classes_(out, clause_out * pol[:, None], clause_class)


def _local_plan_executor_packed(lit_idx, seg_last, clause_class, clause_pol,
                                packed):
    """Include-major executor over pack_literals words (32 points/word).

    lit_idx   int32[I_cap]   absolute literal slots, padded with 0
    seg_last  int32[I_cap]   1 at the last include of each clause, else 0
    packed    int32[2F, W]   pack_literals output (bit b = datapoint w*32+b)
    -> int32[NCL, W*32] class sums

    A running AND accumulates the current clause; at seg_last it is
    emitted to the clause's output row and resets.  Each CHUNK-sized block
    is one segmented AND scan whose first segment takes the running AND
    carried in from the blocks before."""
    packed = torch.as_tensor(packed)
    dev = packed.device
    lit_idx = torch.as_tensor(lit_idx, device=dev).to(torch.int64)
    last = torch.as_tensor(seg_last, device=dev) == 1
    pol = torch.as_tensor(clause_pol, device=dev).to(torch.int32)
    NCL = pol.shape[0]
    W = packed.shape[1]
    chunk = _chunk_of(lit_idx.shape[0])
    out = torch.zeros((NCL + 1, W), dtype=torch.int32, device=dev)
    carry = torch.full((W,), -1, dtype=torch.int32, device=dev)
    c = 0  # clauses emitted so far
    for c0 in range(0, lit_idx.shape[0], chunk):
        words = packed[lit_idx[c0:c0 + chunk]]  # [chunk, W]
        lst = last[c0:c0 + chunk]
        start = torch.zeros_like(lst)
        start[1:] = lst[:-1]
        # the instructions before the block's first reset continue the
        # clause the carry holds
        first_seg = torch.cumsum(start.to(torch.int64), 0) == 0
        words = torch.where(first_seg[:, None], words & carry, words)
        acc = segmented_and_scan(words, start)
        rows = c + torch.cumsum(lst.to(torch.int64), 0) - lst.to(torch.int64)
        emit = lst & (rows <= NCL)  # the reference's scatter drops the rest
        out[rows[emit]] = acc[emit]
        c += int(lst.sum())
        carry = torch.full_like(carry, -1) if bool(lst[-1]) else acc[-1]
    bits = unpack_bits(out[:NCL])  # [NCL, W*32]
    sums = torch.zeros((NCL, W * 32), dtype=torch.int32, device=dev)
    return scatter_classes_(sums, bits * pol[:, None], clause_class)


def _local_plan_executor_clausemajor(pad_idx, clause_class, clause_pol,
                                     packed1):
    """Clause-major executor: padded include table, bitpacked datapoints.

    pad_idx  int32[NCL, Lc]   per-clause literal slots, padded with the
                              index of the all-ones row of ``packed1``
    packed1  int32[2F+1, W]   pack_literals output + one all-ones row
    -> int32[NCL, W*32] class sums

    One AND over each clause's slots, parallel over clauses and
    datapoints (``kernels.clause_table.ref.clause_major_sums``, in row
    chunks)."""
    packed1 = torch.as_tensor(packed1)
    dev = packed1.device
    pad_idx = torch.as_tensor(pad_idx, device=dev)
    return clause_major_sums(
        pad_idx, torch.as_tensor(clause_class, device=dev),
        torch.as_tensor(clause_pol, device=dev), packed1, pad_idx.shape[0],
    )


# ---------------------------------------------------------------------------
# sharded executor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TMShardedConfig:
    """A deployed multi-core TM: model dims + executor capacity plan."""

    name: str
    n_classes: int
    n_clauses: int      # clauses per class
    n_features: int
    batch: int          # global batch (multiple of 32: bitpacked words)
    include_cap: int = 0  # max includes per clause (0 -> density estimate)
    density: float = 0.05

    @property
    def lc_cap(self) -> int:
        if self.include_cap:
            return self.include_cap
        est = int(2 * self.n_features * self.density * 2)
        return max(8, -(-est // 8) * 8)


TM_CONFIGS: Dict[str, TMShardedConfig] = {
    # the paper's MNIST-scale machine, batch-scaled for mesh serving
    "tm-paper": TMShardedConfig(
        name="tm-paper", n_classes=10, n_clauses=128, n_features=784,
        batch=8192, density=0.05,
    ),
    "tm-xl": TMShardedConfig(
        name="tm-xl", n_classes=64, n_clauses=512, n_features=4096,
        batch=32768, density=0.02,
    ),
}


@dataclasses.dataclass(frozen=True)
class OperandSpec:
    """Shape, dtype and partition spec of one operand of
    ``build_tm_sharded``'s ``fn``: per dimension a mesh axis, a tuple of
    axes, or None (replicated)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Tuple


def _on(device: torch.device):
    """Make ``device`` current while a tile runs (CUDA only)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class TMShardedFn:
    """``fn`` of ``build_tm_sharded``: the class x batch split of one
    configuration on one mesh.

    ``fn(idx, pol, lits)`` is the reference's operand contract (class
    sums ``int32[Bp, Mp]`` on the mesh's first device).  ``place(idx,
    pol)`` puts each class slice's tables on its tiles' devices once, and
    ``packed(tables, packed1)`` runs those tables over literals already
    packed to words (``int32[2F+1, W]``, the last row all ones), split
    over the batch shards by words: the serving engine's route."""

    def __init__(self, cfg: TMShardedConfig, mesh):
        sizes = _axis_sizes(mesh)
        self.cfg, self.mesh = cfg, mesh
        self.n_model = sizes.get("model", 1)
        self.Mp = _pad_to(cfg.n_classes, self.n_model)
        self.M_l = self.Mp // self.n_model
        self.Bp = cfg.batch
        self.bx = batch_axes(mesh, self.Bp)
        self.shards = batch_shards(mesh, self.Bp)

    def tile_device(self, coords: dict, m: int) -> torch.device:
        return self.mesh.device_at({**coords, "model": m})

    def place(self, idx, pol) -> Dict[Tuple[int, torch.device], tuple]:
        """(class slice, device) -> (idx_l int32[M_l, C, Lc], pol_l
        int32[M_l, C]) on that device, for every tile's slice."""
        idx, pol = torch.as_tensor(idx), torch.as_tensor(pol)
        cfg = self.cfg
        want = ((self.Mp, cfg.n_clauses, cfg.lc_cap), (self.Mp, cfg.n_clauses))
        if (tuple(idx.shape), tuple(pol.shape)) != want:
            raise ValueError(f"idx/pol shapes {tuple(idx.shape)}, "
                             f"{tuple(pol.shape)}; expected {want[0]}, {want[1]}")
        tables = {}
        for coords, _ in self.shards:
            for m in range(self.n_model):
                d = self.tile_device(coords, m)
                if (m, d) not in tables:
                    sl = slice(m * self.M_l, (m + 1) * self.M_l)
                    tables[m, d] = (
                        idx[sl].to(device=d, dtype=torch.int32).contiguous(),
                        pol[sl].to(device=d, dtype=torch.int32).contiguous(),
                    )
        return tables

    def packed(self, tables, packed1: torch.Tensor) -> torch.Tensor:
        """int32[W*32, Mp] class sums of ``packed1 int32[2F+1, W]``."""
        F2 = 2 * self.cfg.n_features
        if packed1.dim() != 2 or packed1.shape[0] != F2 + 1:
            raise ValueError(f"packed1 must be [{F2 + 1}, W], got "
                             f"{tuple(packed1.shape)}")
        W = packed1.shape[1]
        first = self.mesh.first_device
        out = torch.empty((W * 32, self.Mp), dtype=torch.int32, device=first)
        n_batch = len(self.shards)
        for coords, i in self.shards:
            w0, w1 = i * W // n_batch, (i + 1) * W // n_batch
            if w0 == w1:
                continue
            words = {}  # the shard's words on each of its devices
            for m in range(self.n_model):
                d = self.tile_device(coords, m)
                if d not in words:
                    words[d] = packed1[:, w0:w1].to(d).contiguous()
                with _on(d):
                    sums = clause_table(*tables[m, d], words[d])
                    out[w0 * 32:w1 * 32, m * self.M_l:(m + 1) * self.M_l] = (
                        sums.T.to(first))
        return out

    def __call__(self, idx, pol, lits) -> torch.Tensor:
        lits = torch.as_tensor(lits)
        want = (self.Bp, 2 * self.cfg.n_features + 1)
        if tuple(lits.shape) != want:
            raise ValueError(f"lits shape {tuple(lits.shape)}; expected {want}")
        first = self.mesh.first_device
        packed1 = pack_columns(lits.to(first))
        return self.packed(self.place(idx, pol), packed1)[: self.Bp]


def build_tm_sharded(cfg: TMShardedConfig, mesh) -> Tuple[Callable, tuple]:
    """-> (fn, specs): the class x batch sharded executor.

    fn(idx, pol, lits) -> int32[Bp, Mp] class sums, where
      idx  int32[Mp, C, Lc]  per-class clause-major include tables (padded
                             entries point at the trailing all-ones column)
      pol  int32[Mp, C]      weight x polarity, 0 for padded clauses/classes
      lits int8[Bp, 2F+1]    interleaved literals + all-ones pad column

    Classes shard over ``model`` (Mp is padded up to divide), the batch
    over the non-model axes; each tile computes its disjoint [B_l, M_l]
    block on its device.  ``specs`` are ``OperandSpec``s of the three
    operands (build real ones with ``operands_from_plan``)."""
    fn = TMShardedFn(cfg, mesh)
    C, Lc, F2 = cfg.n_clauses, cfg.lc_cap, 2 * cfg.n_features
    specs = (
        OperandSpec((fn.Mp, C, Lc), torch.int32, ("model", None, None)),
        OperandSpec((fn.Mp, C), torch.int32, ("model", None)),
        OperandSpec((fn.Bp, F2 + 1), torch.int8, (fn.bx, None)),
    )
    return fn, specs


def fill_clause_tables(plan, Mp: int, C: int, Lc: int, F2: int):
    """DecodedPlan -> clause-major (idx int32[Mp, C, Lc], pol int32[Mp, C]),
    numpy, as the reference fills them.

    Padded idx entries point at the all-ones literal column ``F2``; padded
    pol entries are 0 so they contribute nothing.  Clause weights fold
    into the polarity table (``pol = weight * polarity``), so weighted
    models run the same executor, bit-identical at weight 1.  Raises when
    the plan exceeds the (C, Lc) capacity plan."""
    idx = np.full((Mp, C, Lc), F2, np.int32)
    pol = np.zeros((Mp, C), np.int32)
    next_slot = np.zeros(Mp, np.int64)
    wpol = plan.weighted_pol
    # clause_id is sorted (decode_to_plan emits stream order), so one
    # searchsorted gives every clause's include span
    bounds = np.searchsorted(
        plan.clause_id, np.arange(plan.n_clauses_total + 1)
    )
    for c in range(plan.n_clauses_total):
        m = int(plan.clause_class[c])
        j = int(next_slot[m])
        next_slot[m] += 1
        if j >= C:
            raise ValueError(f"class {m} exceeds clause capacity {C}")
        ks = plan.lit_idx[bounds[c] : bounds[c + 1]]
        if ks.size > Lc:
            raise ValueError(
                f"clause {c} has {ks.size} includes; capacity {Lc}"
            )
        idx[m, j, : ks.size] = ks
        pol[m, j] = int(wpol[c])
    return idx, pol


def operands_from_plan(cfg: TMShardedConfig, plan, X, mesh):
    """DecodedPlan + raw features {0,1}[B, F] -> (idx, pol, lits1) tensors
    on the mesh's first device, matching ``build_tm_sharded``.  Raises if
    the plan exceeds the config's capacity plan or B is not the config's
    batch."""
    Mp = _pad_to(cfg.n_classes, _axis_sizes(mesh).get("model", 1))
    C, Lc, F2 = cfg.n_clauses, cfg.lc_cap, 2 * cfg.n_features
    idx, pol = fill_clause_tables(plan, Mp, C, Lc, F2)
    X = torch.as_tensor(np.asarray(X))
    B = X.shape[0]
    if B != cfg.batch:
        raise ValueError(f"batch {B} != configured {cfg.batch}")
    dev = mesh.first_device
    lits = literals(X.to(dev)).to(torch.int8)
    lits1 = torch.cat([lits, torch.ones((B, 1), dtype=torch.int8, device=dev)], 1)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(pol).to(dev), lits1


def dryrun_tm(name: str, *, multi_pod: bool = False, out_dir=None, mesh=None,
              mesh_name: str = None) -> dict:
    """The roofline record of ``TM_CONFIGS[name]`` on the production mesh
    (or ``mesh``, named ``mesh_name``), written to ``out_dir`` as
    ``<name>_<mesh>.json`` when given.  The counts come from the config's
    capacities, not a trace (``FlopCounterMode`` counts 0 for AND and
    popcount); per device they are the global count over the chips.

    Work: the clause-major executor's integer operations at capacity, as
    the reference's gather + AND-reduce performs them -- every slot of
    every clause row ANDed once per 32-datapoint word (``Mp x C x lc_cap
    x ceil(B/32)``), then per (clause, datapoint) the bit's unpack, the
    polarity product and the class sum (``3 x Mp x C x B``), priced at
    ``PEAK_FP32_FLOPS`` (no int32 rate is published; this one is the
    highest candidate).  A kernel that skips padded slots or stops a row
    once its AND is zero (``clause_table``) needs less, so ``t_compute``
    is the executor's cost when the tables fill, not a lower bound for
    every input.  Bytes: the executor's operands read once and its sums
    written once -- the clause tables ``int32[Mp, C, lc_cap]`` and
    ``int32[Mp, C]``, the literals packed to 32-bit words with their
    all-ones row ``int32[2F+1, B/32]``, the sums ``int32[B, Mp]`` --
    which every executor moves, so ``t_memory`` is a lower bound.  No
    collective: each tile writes a disjoint block.  Useful work, as the
    reference: ``2 x includes x batch`` with ``includes = n_classes x
    n_clauses x lc_cap``, bit operations per datapoint (one integer AND
    does 32 of them), so ``peak_fraction`` can exceed 1."""
    from ..analysis.roofline import PEAK_FP32_FLOPS, build_roofline
    from ..launch.mesh import make_production_mesh

    cfg = TM_CONFIGS[name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, devices="meta")
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    chips = mesh.size
    Mp = _pad_to(cfg.n_classes, _axis_sizes(mesh).get("model", 1))
    C, Lc, B = cfg.n_clauses, cfg.lc_cap, cfg.batch
    W = -(-B // 32)
    flops = float(Mp * C * Lc * W + 3 * Mp * C * B)
    nbytes = float(4 * (Mp * C * Lc + Mp * C + (2 * cfg.n_features + 1) * W + B * Mp))
    includes = cfg.n_classes * cfg.n_clauses * cfg.lc_cap
    mf = 2.0 * includes * cfg.batch
    rl = build_roofline(
        arch=name, shape=f"batch{cfg.batch}", mesh_name=mesh_name, chips=chips,
        cost={"flops": flops / chips, "bytes accessed": nbytes / chips},
        collectives={}, model_flops_global=mf, peak_flops=PEAK_FP32_FLOPS,
    )
    rec = json.loads(rl.to_json())
    if out_dir is not None:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{name}_{mesh_name}.json").write_text(json.dumps(rec, indent=1))
    return rec


__all__ = [
    "CHUNK",
    "OperandSpec",
    "TMShardedConfig",
    "TMShardedFn",
    "TM_CONFIGS",
    "build_tm_sharded",
    "dryrun_tm",
    "fill_clause_tables",
    "operands_from_plan",
]
