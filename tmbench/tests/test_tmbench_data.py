"""A configuration, a traffic mix, a cell and a metric are added as new
files alone; the harness finds them and runs the cell on the CPU."""

import json
import subprocess
import sys

from .conftest import SRC, add_cell, last_json, run_python

NEW_METRIC = '''
"""Requests completed inside the window."""


def read(run):
    return len(run.done)
'''

RUN = "from tmbench import harness; harness.execute('.', '{cell}', {seed}, 0.5, {trace}, 'cpu')"


def contract_shape(line, metrics):
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == set(metrics)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for c in line["checks"].values():
        assert c == {"value": 0, "limit": 0}


def test_new_files_make_a_new_cell(tiny_copy):
    config = {"name": "tm-other", "dataset": "emg", "n_classes": 3, "n_clauses": 10,
              "n_raw_features": 8, "thermometer_bits": 2, "n_features": 16,
              "include_density": 0.06, "pool_rows": 2048, "reduced": []}
    traffic = {"clients": 2,
               "rows": {"dist": "log_uniform", "min": 4, "max": 300},
               "batch_words": 4, "warmup": 1, "check_share": 1.0}
    add_cell(tiny_copy, "other-cell", config, "other", traffic)
    (tiny_copy / "tmbench" / "layer_metrics" / "requests_done.py").write_text(NEW_METRIC)
    bench = json.loads((tiny_copy / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "requests_done", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "scheduler and batcher",
        "moves": "rows_per_s"})
    (tiny_copy / "BENCHMARK.json").write_text(json.dumps(bench))

    untraced = run_python(tiny_copy, RUN.format(cell="other-cell", seed=2**31 + 1, trace=False))
    assert untraced.returncode == 0, untraced.stderr[-3000:]
    contract_shape(last_json(untraced.stdout), ["rows_per_s", "setup_s"])
    assert untraced.stderr.strip().splitlines()[-1] == "check rows_wrong_class 0 limit 0"

    traced = run_python(tiny_copy, RUN.format(cell="other-cell", seed=5, trace=True))
    assert traced.returncode == 0, traced.stderr[-3000:]
    # the device metrics have nothing to read on the CPU and are left out
    contract_shape(last_json(traced.stdout),
                   ["batch_fill", "req_p95_ms", "engine_ms_per_batch", "requests_done"])

    # a metric is read in every cell: the tiny cell reports it too
    tiny = run_python(tiny_copy, RUN.format(cell="tiny", seed=5, trace=True))
    assert tiny.returncode == 0, tiny.stderr[-3000:]
    assert "requests_done" in last_json(tiny.stdout)["metrics"]


def test_run_refuses_without_the_port_and_without_a_card(tiny_copy):
    cmd = [sys.executable, "tmbench/run.py", "--workload", "tiny", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    bare = subprocess.run(cmd, cwd=tiny_copy, capture_output=True, text=True, timeout=120)
    assert bare.returncode != 0 and bare.stdout == ""
    (tiny_copy / "src").symlink_to(SRC)
    cpu = subprocess.run(cmd, cwd=tiny_copy, capture_output=True, text=True, timeout=120,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert cpu.returncode != 0 and cpu.stdout == ""
