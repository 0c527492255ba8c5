"""The integer-weighted MNIST configuration (``iwtm-mnist-2k``), its cell
``iwtm-mnist-bulk``, and the readers of the weight planes x clause chunks
each batch walked: ``plane_chunks_per_batch`` and
``compute_ns_per_plane_chunk``."""

import json
from types import SimpleNamespace

import pytest

from tmbench import harness
from tmbench.trace import DeviceEvent
from tmbench.weights import clause_weights, weight_spec
from tmbench.work import inference_work, n_includes

from .conftest import REPO
from .test_tmbench_spans import MS, _dev, _span_log

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "iwtm-mnist-bulk"
CONFIG = json.loads((REPO / "tmbench" / "configs" / "iwtm-mnist-2k.json").read_text())


@pytest.mark.parametrize("seed", [11, 2**31 + 23])
def test_the_configuration_is_weighted_with_eight_planes(seed):
    spec = weight_spec(CONFIG)
    assert spec == {"dist": "log_uniform", "min": 1, "max": 255}
    assert n_includes(CONFIG) == 170_000
    w = clause_weights(CONFIG, seed)
    assert tuple(w.shape) == (10, 2000)
    assert int(w.min()) >= 1 and int(w.max()).bit_length() == 8
    # the sums stay exact in int32: ceil(2000 / 2) x 255
    assert -(-int(CONFIG["n_clauses"]) // 2) * int(w.max()) == 255_000 < 2**31
    assert CONFIG["reduced"] == []


def test_the_work_of_a_row_is_operations_bound_at_128_bytes():
    work = inference_work(CONFIG, 1)
    assert work["bytes"] == 98 + 10 * 3  # 784 bits; 2,000 x 255 + 1 sum values in 3 bytes
    assert work["ops"] == 170_000 / 32
    assert work["bound"] == "operations"


def test_the_cell_is_listed_and_every_metric_of_it_has_a_reader():
    cells = {c["name"]: c for c in BENCH["workloads"]}
    cell = cells[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("iwtm-mnist-2k", "bulk", 1)
    entry = next(c for c in BENCH["configs"] if c["name"] == "iwtm-mnist-2k")
    assert entry["file"] == "tmbench/configs/iwtm-mnist-2k.json" and entry["reduced"] == []
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert CELL in e2e["compute_ms_per_mrow"]["workloads"]
    assert [n for n, m in e2e.items() if harness.applies(m, cell)] == [
        "compute_ms_per_mrow", "setup_s"]
    layer = [m for m in BENCH["per_layer"] if harness.applies(m, cell)]
    assert {m["name"] for m in layer} == {
        "plane_chunks_per_batch", "compute_ns_per_plane_chunk", "engine_roofline.iwtm",
        "device_idle.iwtm", "ops_per_batch.iwtm", "batch_fill.iwtm",
        "engine_ms_per_batch.iwtm"}
    for m in layer:
        assert m["moves"] == "compute_ms_per_mrow"
        assert callable(harness.reader("layer_metrics", m["name"])), m["name"]


def _launched(m, seq, t0_ms, arg):
    """A batch at ``t0_ms`` whose ``batch.launch`` child carries ``arg``."""
    from repro_torch.serve_tm.metrics import Span

    b = m.record_span(Span.BATCH, (t0_ms * MS, 0), ((t0_ms + 10) * MS, 0), tag=seq)
    m.record_span(Span.LAUNCH, ((t0_ms + 2) * MS, 0), ((t0_ms + 4) * MS, 0),
                  parent=b, tag=seq, arg=arg)


def _run(args, batch_words=4):
    """Batches at 500 ms (before the window [1 s, 2 s]), 1,120 and
    1,200 ms with launch args ``args``; the trace's steady slice is
    [1.1 s, 1.9 s], with 3 ms of compute and a copy in it."""
    m = _span_log()
    for seq, (t0, arg) in enumerate(zip((500, 1120, 1200), args)):
        _launched(m, seq, t0, arg)
    copy = _dev(1121, 1124)
    events = [_dev(1000, 1001), _dev(1125, 1126), _dev(1208, 1210),
              DeviceEvent("Memcpy HtoD (Pinned -> Device)", copy.start, copy.end),
              _dev(1999, 2000)]
    return SimpleNamespace(start=1.0, end=2.0, events=events,
                           traffic={"batch_words": batch_words},
                           clients=SimpleNamespace(acc=SimpleNamespace(metrics=m)))


def _read(name, run):
    return harness.reader("layer_metrics", name)(run)


def test_plane_chunks_per_batch_is_the_mean_launch_arg_in_the_window():
    assert _read("plane_chunks_per_batch", _run((7, 5000, 5000))) == 5000.0
    assert _read("plane_chunks_per_batch", _run((7, 63, 5000))) == 2531.5


def test_compute_ns_per_plane_chunk_counts_compute_of_the_steady_slice():
    # 3 ms of compute over 2 batches x 4 words x 5,000 plane chunks
    got = _read("compute_ns_per_plane_chunk", _run((1, 5000, 5000)))
    assert got == pytest.approx(3e6 / (2 * 4 * 5000), rel=1e-9)
    got = _read("compute_ns_per_plane_chunk", _run((1, 63, 63), batch_words=1024))
    assert got == pytest.approx(3e6 / (2 * 1024 * 63), rel=1e-9)


def test_a_program_that_records_no_product_reads_nothing():
    """A program whose launches carry 0 (one that predates the product)
    leaves both metrics out, as does a run with no spans or no trace."""
    for name in ("plane_chunks_per_batch", "compute_ns_per_plane_chunk"):
        assert _read(name, _run((0, 0, 0))) is None
        untraced = _run((1, 63, 63))
        untraced.events = None
        assert _read("compute_ns_per_plane_chunk", untraced) is None
        no_log = SimpleNamespace(start=1.0, end=2.0, events=[], clients=None,
                                 traffic={"batch_words": 4})
        assert _read(name, no_log) is None
