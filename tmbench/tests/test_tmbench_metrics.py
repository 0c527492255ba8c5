"""The metrics of ``BENCHMARK.json``: each found by its name, each
reported only where its end-to-end metric is, and the card's time per
row counted from the trace."""

import json
from types import SimpleNamespace

from tmbench import harness
from tmbench.trace import DeviceEvent

from .conftest import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = {c["name"]: c for c in BENCH["workloads"]}


def test_every_metric_has_a_reader():
    for kind, key in (("end_to_end", "end_to_end"), ("layer_metrics", "per_layer")):
        for m in BENCH[key]:
            assert callable(harness.reader(kind, m["name"])), m["name"]


def test_a_split_name_reads_the_quantity():
    run = SimpleNamespace(done=[SimpleNamespace(n=30), SimpleNamespace(n=10)], seconds=2.0)
    assert harness.reader("layer_metrics", "rows_per_s.bulk")(run) == 20.0


def test_per_layer_metrics_go_with_their_end_to_end_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for cell in CELLS.values():
        reported = [m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell)]
        assert "setup_s" in reported and len(reported) >= 2, cell["name"]
        layer = [m for m in BENCH["per_layer"] if harness.applies(m, cell)]
        assert layer, cell["name"]
        for m in layer:
            assert harness.applies(e2e[m["moves"]], cell), (cell["name"], m["name"])


def test_compute_ms_per_mrow_leaves_out_copies():
    events = [DeviceEvent("Memcpy HtoD (Pinned -> Device)", 0.0, 0.002),
              DeviceEvent("k", 0.002, 0.003), DeviceEvent("k", 0.010, 0.012)]
    read = harness.reader("end_to_end", "compute_ms_per_mrow")
    run = SimpleNamespace(events=events, served={"rows": 2_000_000})
    assert abs(read(run) - 3e-3 * 1e3 / 2) < 1e-12
    assert read(SimpleNamespace(events=None, served={"rows": 5})) is None
    assert read(SimpleNamespace(events=events, served={"rows": 0})) is None
    assert read(SimpleNamespace(events=events[:1], served={"rows": 5})) is None
