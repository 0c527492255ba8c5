"""Fixtures of the benchmark's own tests (``python -m pytest tmbench/tests``).

Tests that need the card are marked ``cuda`` and skip themselves inside
the ``card`` fixture, never while a module is imported.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SRC = REPO / "src"

TINY_CONFIG = {
    "name": "tm-tiny", "dataset": "gas", "n_classes": 4, "n_clauses": 12,
    "n_raw_features": 10, "thermometer_bits": 3, "n_features": 30,
    "include_density": 0.05, "pool_rows": 4096, "reduced": [],
}
TINY_TRAFFIC = {
    "clients": 3,
    "rows": {"dist": "uniform", "min": 1, "max": 100},
    "batch_words": 2, "warmup": 1, "check_share": 0.5,
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; the test skips itself when there is none",
    )


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def add_cell(root: Path, name: str, config: dict, traffic_name: str, traffic: dict):
    """Add a configuration, a traffic mix and a cell as new files and a new
    entry of ``BENCHMARK.json``, as a later change would, the cell named
    among the cells of ``rows_per_s`` and of the metrics that move it."""
    (root / "tmbench" / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    (root / "tmbench" / "traffic" / f"{traffic_name}.json").write_text(json.dumps(traffic))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": config["name"], "source": "https://arxiv.org/abs/2502.07823",
        "file": f"tmbench/configs/{config['name']}.json", "reduced": [],
        "why": "a tiny machine for the CPU tests"})
    bench["workloads"].append({
        "name": name, "config": config["name"], "traffic": traffic_name,
        "chips": 1, "why": "a tiny cell for the CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:  # reports rows_per_s
        if "workloads" in m and "rows_per_s" in (m["name"], m.get("moves")):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture
def tiny_copy(tmp_path):
    """A copy of the benchmark (``BENCHMARK.json`` and ``tmbench/``, no
    program) with a tiny cell ``tiny`` added."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "tmbench", tmp_path / "tmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_cell(tmp_path, "tiny", TINY_CONFIG, "tiny", TINY_TRAFFIC)
    return tmp_path


def run_python(root: Path, code: str, timeout: float = 240):
    """Run ``code`` in a fresh interpreter in ``root`` (the copy's
    ``tmbench`` first on the path, the port after it)."""
    return subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
        timeout=timeout, env={**os.environ, "PYTHONPATH": f"{root}:{SRC}"},
    )


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
