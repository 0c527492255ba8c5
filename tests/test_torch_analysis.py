"""The port's roofline analysis (``repro_torch.analysis``) against the
reference's ``repro.analysis`` on the same inputs: the HLO collective
parser, ``model_flops`` and ``scan_correction_flops`` for every arch x
shape (exact: the same arithmetic), ``build_roofline`` (flops, bytes,
collective bytes and the useful-flops ratio equal; each time term the
reference's times the ratio of the two packages' constants, to 1e-12
relative) and ``report.enrich`` (the same rule on H100 constants)."""

import dataclasses

import pytest

from repro.analysis import corrections as ref_corr
from repro.analysis import report as ref_report
from repro.analysis import roofline as ref_rl
from repro.configs import registry as ref_registry
from repro.configs.base import shapes_for as ref_shapes_for
from repro.models.api import active_params as ref_active_params
from repro_torch.analysis import corrections, report, roofline
from repro_torch.configs import registry
from repro_torch.configs.base import shapes_for
from repro_torch.models.api import active_params

REL = 1e-12

HLO = {
    "async pair": """
  %p0 = bf16[256,512]{1,0} parameter(0)
  %ar-start = bf16[256,512]{1,0} all-reduce-start(%p0), channel_id=1
  %ar-done = bf16[256,512]{1,0} all-reduce-done(%ar-start)
""",
    "tuple all-reduce": """
  %a = f32[16,16]{1,0} parameter(0)
  %b = f32[8]{0} parameter(1)
  %ar = (f32[16,16]{1,0}, f32[8]{0}) all-reduce(%a, %b), channel_id=3
""",
    "operands resolved": """
  %p = f32[128,64]{1,0} parameter(0)
  %fusion.1 = f32[128,64]{1,0} fusion(%p), kind=kLoop
  %all-reduce.1 = f32[128,64]{1,0} all-reduce(%fusion.1), channel_id=1
  %ag = f32[512,64]{1,0} all-gather(%fusion.1), dims={0}
  ROOT %all-reduce.2 = f32[] all-reduce(%all-reduce.1), channel_id=2
""",
    "result fallback": "%ar = f32[1000]{0} all-reduce(%ar)",
    "every kind": """
  %x = s32[4,4]{1,0} parameter(0)
  %rs = s32[1,4]{1,0} reduce-scatter(%x), dimensions={0}
  %a2a = s32[4,4]{1,0} all-to-all(%x), dimensions={0}
  %cp-start = (s32[4,4]{1,0}, s32[4,4]{1,0}) collective-permute-start(%x)
  %cp-done = s32[4,4]{1,0} collective-permute-done(%cp-start)
  %ag-start = (u8[16]{0}, u8[64]{0}) all-gather-start(%y)
""",
}

CELLS = [(name, s) for name in ref_registry.all_arch_names()
         for s in ref_shapes_for(ref_registry.get(name))]


@pytest.mark.parametrize("case", sorted(HLO))
def test_collective_bytes_equal_the_reference(case):
    assert roofline.collective_bytes(HLO[case]) == ref_rl.collective_bytes(HLO[case])


def test_arch_and_shape_grids_match():
    assert registry.all_arch_names() == ref_registry.all_arch_names()
    for name in registry.all_arch_names():
        assert ([s.name for s in shapes_for(registry.get(name))]
                == [s.name for s in ref_shapes_for(ref_registry.get(name))])


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s.name}" for a, s in CELLS])
def test_model_flops_and_scan_corrections_equal_the_reference(arch, shape):
    cfg, ref_cfg = registry.get(arch), ref_registry.get(arch)
    port_shape = next(s for s in shapes_for(cfg) if s.name == shape.name)
    n = active_params(cfg)
    assert n == ref_active_params(ref_cfg)
    assert roofline.model_flops(cfg, port_shape, n) == ref_rl.model_flops(ref_cfg, shape, n)
    assert (corrections.scan_correction_flops(cfg, port_shape)
            == ref_corr.scan_correction_flops(ref_cfg, shape))
    assert corrections.MULT_TRAIN == ref_corr.MULT_TRAIN
    assert corrections.MLSTM_CHUNK == ref_corr.MLSTM_CHUNK


@pytest.mark.parametrize("chips", [1, 8, 256, 512])
@pytest.mark.parametrize("case", ["operands resolved", "result fallback", "every kind"])
def test_build_roofline_equals_the_reference_up_to_the_constants(chips, case):
    kw = dict(arch="x", shape="train_4k", mesh_name="m", chips=chips,
              cost={"flops": 1e12, "bytes accessed": 3e9}, hlo_text=HLO[case],
              model_flops_global=2.56e14, memory_analysis={"temp_size_in_bytes": 7.0})
    ref, port = ref_rl.build_roofline(**kw), roofline.build_roofline(**kw)
    assert port.flops_per_device == ref.flops_per_device
    assert port.hbm_bytes_per_device == ref.hbm_bytes_per_device
    assert port.collective_bytes_per_device == ref.collective_bytes_per_device
    assert port.collective_by_kind == ref.collective_by_kind
    assert port.useful_flops_ratio == ref.useful_flops_ratio
    assert port.memory_analysis == ref.memory_analysis
    assert [f.name for f in dataclasses.fields(port)] == [
        f.name for f in dataclasses.fields(ref)]
    link = roofline.link_bw(chips)
    assert link == (roofline.NVLINK_BW if chips <= 8 else roofline.NDR_BW)
    for term, ratio in (("t_compute", ref_rl.PEAK_FLOPS / roofline.PEAK_FLOPS),
                        ("t_memory", ref_rl.HBM_BW / roofline.HBM_BW),
                        ("t_collective", ref_rl.ICI_BW / link)):
        assert getattr(port, term) == pytest.approx(getattr(ref, term) * ratio, rel=REL)
    terms = {"compute": port.t_compute, "memory": port.t_memory,
             "collective": port.t_collective}
    assert port.bottleneck == max(terms, key=terms.get)
    assert port.peak_fraction == pytest.approx(
        2.56e14 / (chips * roofline.PEAK_FLOPS * max(terms.values())), rel=REL)


def test_build_roofline_takes_collectives_in_place_of_hlo():
    coll = {"all-reduce": 100.0, "all-gather": 0.0, "reduce-scatter": 28.0}
    rl = roofline.build_roofline(
        arch="x", shape="s", mesh_name="m", chips=16, cost={"flops": 1.0},
        collectives=coll, model_flops_global=1.0)
    assert rl.collective_bytes_per_device == 128.0
    assert rl.collective_by_kind == {"all-reduce": 100, "reduce-scatter": 28}
    assert rl.t_collective == 128.0 / roofline.NDR_BW


def test_cost_analysis_dict_normalises():
    assert roofline.cost_analysis_dict({"flops": 3}) == {"flops": 3.0}
    assert roofline.cost_analysis_dict([{"flops": 3, "bytes accessed": 2}]) == {
        "flops": 3.0, "bytes accessed": 2.0}
    assert roofline.cost_analysis_dict([]) == {}


@pytest.mark.parametrize("bytes_", [1e6, 1e9, 1e12])
def test_report_enrich_follows_the_reference_rule(bytes_):
    kw = dict(arch="x", shape="train_4k", mesh_name="pod16x16", chips=256,
              cost={"flops": 5e11, "bytes accessed": 4e10}, hlo_text=HLO["every kind"],
              model_flops_global=1e14,
              memory_analysis={"argument_size_in_bytes": bytes_,
                               "output_size_in_bytes": bytes_ / 2,
                               "temp_size_in_bytes": 3 * bytes_})
    ref = ref_report.enrich(dataclasses.asdict(ref_rl.build_roofline(**kw)))
    port = report.enrich(dataclasses.asdict(roofline.build_roofline(**kw)))
    lower = bytes_ + bytes_ / 2 + 2 * 3 * bytes_
    assert port["t_memory_lower"] == lower / roofline.HBM_BW
    assert port["t_memory_lower"] == pytest.approx(
        ref["t_memory_lower"] * ref_rl.HBM_BW / roofline.HBM_BW, rel=REL)
    assert port["t_memory_upper"] == pytest.approx(
        ref["t_memory_upper"] * ref_rl.HBM_BW / roofline.HBM_BW, rel=REL)
    terms = {"compute": port["t_compute"], "memory": port["t_memory_lower"],
             "collective": port["t_collective"]}
    assert port["bottleneck_fused"] == max(terms, key=terms.get)
    assert port["peak_fraction_fused"] == pytest.approx(
        1e14 / (256 * roofline.PEAK_FLOPS * max(terms.values())), rel=REL)
    assert report.SKIPPED_LONG == ref_report.SKIPPED_LONG
    assert report.DRYRUN_DIR.endswith("dryrun_torch")


def test_report_table_reads_records(tmp_path, monkeypatch):
    rec = dataclasses.asdict(roofline.build_roofline(
        arch="stablelm-3b", shape="train_4k", mesh_name="pod16x16", chips=256,
        cost={"flops": 1e12, "bytes accessed": 1e10}, collectives={"all-reduce": 1e8},
        model_flops_global=1e14,
        memory_analysis={"argument_size_in_bytes": 1e9, "temp_size_in_bytes": 2e9}))
    rec.update(lower_s=1.5, compile_s=0.25)
    import json

    (tmp_path / "stablelm-3b_train_4k_pod16x16.json").write_text(json.dumps(rec))
    monkeypatch.setattr(report, "DRYRUN_DIR", str(tmp_path))
    table = report.table("pod16x16")
    row = next(line for line in table.splitlines() if line.startswith("| stablelm-3b"))
    assert row.endswith("| 3.0 | 1.75 |")
    assert len([line for line in table.splitlines() if "SKIP" in line]) == len(
        report.SKIPPED_LONG)
    # the cross-mesh summary: t_collective 1e8 B / 50e9 B/s = 2 ms bounds it
    assert "| stablelm-3b | coll 2.00 / — ms; 2 / — s | — | — | SKIP |" in report.summary()
