"""The port's dry run (``repro_torch.launch.dryrun``,
``repro_torch.dist.tm_sharded.dryrun_tm``): smoke cells traced on the
``meta`` device on (1, 1), (4, 2) and (2, 2, 2) meshes with nothing
allocated anywhere; the trace affine in depth (u = 3 equals the u = 1 /
u = 2 extrapolation, exactly); one streaming-attention application
counted as the reference's ``_attn_correction`` says the full blocks
cost; a step's count on the CPU equal to its count on ``meta``; each
rule of ``spec_collective_bytes`` on a hand-computed case, and the
pattern each leaf's rule names; the memory sizes of the spec trees equal
to what the steps take and return; the TM record's useful work equal to
the reference's formula, its work counted per 32-bit word at the fp32
rate and its bytes what the executor's kernel reads and writes; the
record's keys the reference's; ``resolve_device(None)`` still raising
without a card."""

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis.corrections import _attn_correction as ref_attn_correction
from repro.analysis.roofline import Roofline as RefRoofline
from repro.dist.tm_sharded import TM_CONFIGS as REF_TM_CONFIGS
from repro_torch.analysis.roofline import HBM_BW, PEAK_FP32_FLOPS
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.configs.registry import get
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist import tm_sharded
from repro_torch.dist.sharding import spec_collective_bytes
from repro_torch.dist.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.dist.steps import opt_config_for
from repro_torch.dist.tm_sharded import TM_CONFIGS, TMShardedConfig, dryrun_tm
from repro_torch.launch import dryrun
from repro_torch.models import common as cm
from repro_torch.models.api import family_for
from repro_torch.models.common import meta
from repro_torch.optim import adamw

MESHES = {"1x1": ((1, 1), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ARCHS = ("stablelm-3b-smoke", "xlstm-125m-smoke")
KINDS = ("train", "prefill", "decode")


@pytest.fixture(autouse=True)
def _no_activation_mesh():
    shd.set_activation_mesh(None)
    yield
    shd.set_activation_mesh(None)


def _mesh(name):
    shape, axes = MESHES[name]
    return shd.make_mesh(shape, axes, devices="meta")


class _Devices(TorchDispatchMode):
    """Every device an op's inputs or outputs of one element or more lie
    on (a 0-dim CPU tensor is a host constant, as ``xlstm._key_scale``
    rounds one)."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor) and (t.dim() or t.device.type != "cpu"):
                self.seen.add(t.device.type)
        return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_trace_on_meta(arch, mesh_name):
    mesh = _mesh(mesh_name)
    with _Devices() as seen:
        for kind in KINDS:
            c = dryrun.lower_cell(get(arch), ShapeSpec("t", 64, 8, kind), mesh).compile()
            cost, mem = c.cost_analysis(), c.memory_analysis()
            assert cost["flops"] > 0 and cost["bytes accessed"] > 0
            assert mem.argument_size_in_bytes > 0 and mem.temp_size_in_bytes > 0
            assert set(c.collective_bytes()) == {
                "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute"}
            if mesh.size == 1:  # no collective on one chip
                assert not any(c.collective_bytes().values())
            if kind == "train":  # donated params and moments
                assert mem.alias_size_in_bytes == mem.output_size_in_bytes - 8
    assert seen.seen == {"meta"}
    assert not torch.cuda.is_initialized()
    assert shd.activation_mesh() is None  # restored on exit
    if mesh_name == "2x2x2":
        assert shd.batch_axes(mesh, 8) == ("pod", "data")


def test_per_device_counts_divide_the_global_count():
    cfg, shape = get("stablelm-3b-smoke"), ShapeSpec("t", 64, 8, "prefill")
    one = dryrun.lower_cell(cfg, shape, _mesh("1x1")).compile()
    eight = dryrun.lower_cell(cfg, shape, _mesh("4x2")).compile()
    assert eight.cost_analysis()["flops"] * 8 == one.cost_analysis()["flops"]
    assert eight.memory_analysis().argument_size_in_bytes < \
        one.memory_analysis().argument_size_in_bytes


@pytest.mark.parametrize("arch,kind", [("stablelm-3b-smoke", "train"),
                                       ("stablelm-3b-smoke", "prefill"),
                                       ("stablelm-3b-smoke", "decode"),
                                       ("xlstm-125m-smoke", "prefill"),
                                       ("xlstm-125m-smoke", "decode"),
                                       ("zamba2-2.7b-smoke", "decode"),
                                       ("whisper-medium-smoke", "prefill")])
def test_trace_is_affine_in_depth(arch, kind):
    cfg, shape, mesh = get(arch), ShapeSpec("t", 64, 8, kind), _mesh("4x2")
    m = [dryrun._cell_metrics(dryrun._unit_variant(cfg, u), shape, mesh)
         for u in (1, 2, 3)]
    assert m[2]["flops"] == m[0]["flops"] + 2 * (m[1]["flops"] - m[0]["flops"])
    assert m[1]["flops"] > m[0]["flops"]
    bytes_x = m[0]["bytes"] + 2 * (m[1]["bytes"] - m[0]["bytes"])
    if arch.startswith("whisper"):
        # the cross-KV einsum ("bsd,ldh->lbsh") takes another path at
        # l = 1: the line through u = 1, 2 misses u = 3 by 4 KiB of 7.2 MB
        assert bytes_x - m[2]["bytes"] == 4096
    else:
        assert m[2]["bytes"] == bytes_x
    for k in m[0]["coll"]:
        assert m[2]["coll"][k] == m[0]["coll"][k] + 2 * (m[1]["coll"][k] - m[0]["coll"][k])


def test_streaming_attention_counts_every_block():
    B, Sq, Hq, Hkv, hd = 2, 2100, 4, 2, 8  # Skv > ATTN_CHUNK_THRESHOLD: 3 blocks
    assert Sq > cm.ATTN_CHUNK_THRESHOLD
    q = meta((B, Sq, Hq, hd), torch.float32)
    k = v = meta((B, Sq, Hkv, hd), torch.float32)
    with FlopCounterMode(display=False) as fc:
        cm.gqa_attention(q, k, v, causal=True)
    nB = math.ceil(Sq / cm.ATTN_CHUNK)
    assert fc.get_total_flops() == 4 * B * Sq * (nB * cm.ATTN_CHUNK) * Hq * hd
    assert fc.get_total_flops() == pytest.approx(
        ref_attn_correction(B, Sq, Sq, Hq, hd, 1.0, 1.0) * nB / (nB - 1), rel=1e-15)


def _cpu_flops(cfg, shape):
    """FlopCounterMode's count of one real step on the CPU."""
    fam = family_for(cfg)
    params = fam.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    B, S = shape.global_batch, shape.seq_len
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            opt = opt_config_for(cfg)
            step = make_train_step(cfg, opt, microbatches=cfg.train_microbatches,
                                   device="cpu")
            step(params, adamw.init(opt, params),
                 {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)})
        elif shape.kind == "prefill":
            make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(
                rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))})
        else:
            cache = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in
                     fam.cache_specs(cfg, shape).items()}
            make_decode_step(cfg)(params, cache, {
                "token": torch.zeros((B, 1), dtype=torch.int32), "pos": S - 1})
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,kind", [("stablelm-3b-smoke", "train"),
                                       ("stablelm-3b-smoke", "prefill"),
                                       ("stablelm-3b-smoke", "decode"),
                                       ("xlstm-125m-smoke", "prefill")])
def test_cpu_step_counts_what_the_meta_trace_counts(arch, kind):
    cfg, shape = get(arch), ShapeSpec("t", 64, 4, kind)
    traced = dryrun.lower_cell(cfg, shape, _mesh("1x1")).compile()
    assert _cpu_flops(cfg, shape) == traced.cost_analysis()["flops"]


def _cfg(**kw):
    base = dict(name="hand", family="dense", n_layers=2, d_model=8, n_heads=2,
                n_kv_heads=2, d_ff=16, vocab=256, fsdp=True)
    return ArchConfig(**{**base, **kw})


def _inputs(B, S):
    return {"tokens": meta((B, S), torch.int32)}


# (cfg, params, kind, mesh, expected per-device bytes) on B = 4, S = 8:
# 16 tokens per batch shard of a (2, 2) mesh
CASES = {
    # [L, in 16, out 8]: in over model (row-parallel), out over data (FSDP).
    # shard 2*16*8*2 B / 4 = 128; all-gather fwd + recompute 2 * 128; the
    # gradient's reduce-scatter 128 * 2; all-reduce 16 tok * 8 * 2 B * 2
    # layers * 3 passes = 1536
    "fsdp row-parallel, train": (
        _cfg(), {"layers": {"mlp": {"w_down": meta((2, 16, 8))}}}, "train", (2, 2),
        {"all-gather": 256.0, "reduce-scatter": 256.0, "all-reduce": 1536.0}),
    # the same leaf served: one all-gather, one pass
    "fsdp row-parallel, prefill": (
        _cfg(), {"layers": {"mlp": {"w_down": meta((2, 16, 8))}}}, "prefill", (2, 2),
        {"all-gather": 128.0, "all-reduce": 512.0}),
    # [L, in 8, out 16]: out over model (column-parallel, no all-reduce)
    "fsdp column-parallel, train": (
        _cfg(), {"layers": {"mlp": {"w_up": meta((2, 8, 16))}}}, "train", (2, 2),
        {"all-gather": 256.0, "reduce-scatter": 256.0}),
    # no FSDP: the gradient (shard 2*16*8*2 / 2 = 256 B) all-reduced over
    # data; decode: 4 tokens / 2 shards * 8 * 2 B * 2 layers = 64
    "data-parallel gradient, train": (
        _cfg(fsdp=False), {"layers": {"mlp": {"w_down": meta((2, 16, 8))}}}, "train",
        (2, 2), {"all-reduce": 256.0 + 1536.0}),
    "row-parallel, decode": (
        _cfg(fsdp=False), {"layers": {"mlp": {"w_down": meta((2, 16, 8))}}}, "decode",
        (2, 2), {"all-reduce": 64.0}),
    # EP experts [L, E 4, F 16, D 8]: the psum of [16 tok, 8] bf16 per
    # layer and pass: 256 * 2 * 3 = 1536, plus the gradient over data
    # (shard 2*4*16*8*2 B / 2 = 1024)
    "expert-parallel psum, train": (
        _cfg(family="moe", n_experts=4, top_k=1, fsdp=False),
        {"layers": {"moe": {"w_down": meta((2, 4, 16, 8))}}}, "train", (2, 2),
        {"all-reduce": 1536.0 + 1024.0}),
    # the vocab over model: the lookup's partial rows summed, 16 tok * 8 * 2 B
    "embedding lookup, prefill": (
        _cfg(fsdp=False), {"embed": meta((256, 8))}, "prefill", (2, 2),
        {"all-reduce": 256.0}),
    # one chip: nothing moves
    "one chip": (
        _cfg(), {"layers": {"mlp": {"w_down": meta((2, 16, 8))}}}, "train", (1, 1), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_collective_bytes_rules(case):
    cfg, params, kind, mesh_shape, want = CASES[case]
    B, S = 4, 8
    shape = ShapeSpec("t", S, B, kind)
    inputs = (_inputs(B, S) if kind != "decode"
              else {"token": meta((B, 1), torch.int32), "pos": meta((), torch.int32)})
    mesh = shd.make_mesh(mesh_shape, devices="meta")
    got = spec_collective_bytes(cfg, shape, mesh, {"params": params, "inputs": inputs})
    assert {k: v for k, v in got.items() if v} == want


@pytest.mark.parametrize("arch", ["stablelm-3b-smoke", "moonshot-v1-16b-a3b-smoke"])
def test_param_rule_names_the_pattern_of_each_leaf(arch):
    from repro_torch.tree import flatten

    cfg, mesh = get(arch), _mesh("4x2")
    specs = family_for(cfg).param_specs(cfg)
    shardings = dict(flatten(shd.param_shardings(cfg, mesh, specs)))
    got = {}
    for path, leaf in flatten(specs):
        spec, got[path] = shd._param_rule(cfg, mesh, tuple(path.split(".")), leaf)
        assert spec == shardings[path].spec
    assert got["embed"] == "embed" and got["final_norm"] == "vector"
    if cfg.is_moe:
        assert {got[f"layers.moe.{w}"] for w in ("w_gate", "w_up", "w_down")} == {"expert"}
        assert got["layers.moe.router"] == "router" and got["layers.attn.wq"] == "attn_dp"
    else:
        assert got["layers.mlp.w_down"] == got["layers.attn.wq"] == "matrix"


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("arch,kind", [("stablelm-3b-smoke", "train"),
                                       ("stablelm-3b-smoke", "prefill"),
                                       ("stablelm-3b-smoke", "decode"),
                                       ("xlstm-125m-smoke", "prefill"),
                                       ("zamba2-2.7b-smoke", "decode"),
                                       ("whisper-medium-smoke", "prefill")])
def test_memory_sizes_are_what_the_step_takes_and_returns(arch, kind):
    cfg, shape = get(arch), ShapeSpec("t", 64, 8, kind)
    fam = family_for(cfg)
    p, inputs = fam.param_specs(cfg), fam.input_specs(cfg, shape)
    if kind == "train":
        opt = opt_config_for(cfg)
        args = (p, adamw.init_specs(opt, p), inputs)
        donated = args[:2]
        out = make_train_step(cfg, opt, microbatches=cfg.train_microbatches,
                              device="meta")(*args)
    elif kind == "prefill":
        args, donated = (p, inputs), ()
        out = make_prefill_step(cfg)(*args)
    else:
        cache = fam.cache_specs(cfg, shape)
        args, donated = (p, cache, inputs), (cache,)
        out = make_decode_step(cfg)(p, cache, {**inputs, "pos": shape.seq_len - 1})
    mem = dryrun._memory_of(cfg, shape, _mesh("1x1"))
    assert mem == {"argument_size_in_bytes": _nbytes(args),
                   "output_size_in_bytes": _nbytes(out),
                   "alias_size_in_bytes": _nbytes(donated)}


@pytest.mark.parametrize("name", sorted(TM_CONFIGS))
def test_dryrun_tm_useful_work_is_the_reference_formula(name, tmp_path):
    ref = REF_TM_CONFIGS[name]
    rec = dryrun_tm(name, out_dir=tmp_path)
    assert rec["model_flops_global"] == 2.0 * (ref.n_classes * ref.n_clauses
                                              * ref.lc_cap) * ref.batch
    assert rec["chips"] == 256 and rec["collective_bytes_per_device"] == 0.0
    assert (tmp_path / f"{name}_pod16x16.json").exists()
    one = dryrun_tm(name, mesh=_mesh("1x1"), mesh_name="1x1")
    # one AND per slot and 32-datapoint word, then unpack, polarity and
    # class sum per (clause, datapoint), priced at the fp32 rate
    M, C, lc, B = ref.n_classes, ref.n_clauses, ref.lc_cap, ref.batch
    assert one["flops_per_device"] == M * C * lc * -(-B // 32) + 3 * M * C * B
    assert one["t_compute"] == one["flops_per_device"] / PEAK_FP32_FLOPS
    assert dataclasses.asdict(RefRoofline(**one)).keys() == one.keys()


def test_dryrun_tm_bytes_are_what_the_executor_moves(monkeypatch):
    """On one tile the record's bytes are the tables, packed words and
    sums the executor's ``clause_table`` call reads and writes."""
    cfg = TMShardedConfig(name="tm-tiny", n_classes=3, n_clauses=4, n_features=16,
                          batch=256, include_cap=8)
    monkeypatch.setitem(tm_sharded.TM_CONFIGS, "tm-tiny", cfg)
    moved = []
    plain = tm_sharded.clause_table

    def counted(idx, pol, packed1):
        out = plain(idx, pol, packed1)
        moved.append(sum(t.numel() * t.element_size() for t in (idx, pol, packed1, out)))
        return out

    monkeypatch.setattr(tm_sharded, "clause_table", counted)
    fn, specs = tm_sharded.build_tm_sharded(cfg, shd.make_mesh((1, 1), devices="cpu"))
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 2 * cfg.n_features + 1, specs[0].shape)
                           .astype(np.int32))
    pol = torch.from_numpy(rng.choice([-1, 1], specs[1].shape).astype(np.int32))
    lits = torch.from_numpy(rng.integers(0, 2, specs[2].shape).astype(np.int8))
    fn(idx, pol, lits)
    rec = dryrun_tm("tm-tiny", mesh=_mesh("1x1"), mesh_name="1x1")
    assert len(moved) == 1 and rec["hbm_bytes_per_device"] == moved[0]
    assert rec["t_memory"] == rec["hbm_bytes_per_device"] / HBM_BW


def test_run_cell_record_has_the_reference_keys(tmp_path):
    rec = dryrun.run_cell("stablelm-3b-smoke", None, False, verbose=False,
                          shape=ShapeSpec("t", 64, 8, "prefill"), mesh=_mesh("4x2"),
                          mesh_name="4x2", out_dir=tmp_path)
    ref_keys = {f.name for f in dataclasses.fields(RefRoofline)}
    assert set(rec) == ref_keys | {"raw_full_cost", "scan_correction_flops_per_device",
                                   "lower_s", "compile_s"}
    assert (tmp_path / "stablelm-3b-smoke_t_4x2.json").exists()
    assert rec["raw_full_cost"]["flops"] == rec["flops_per_device"]
    one = dryrun.lower_cell(get("stablelm-3b-smoke"), ShapeSpec("t", 64, 8, "prefill"),
                            _mesh("4x2")).compile()
    assert rec["flops_per_device"] == one.cost_analysis()["flops"]  # full depth, exact
    assert set(rec["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
        "alias_size_in_bytes"}


def test_resolve_device_none_still_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("meta") == torch.device("meta")
