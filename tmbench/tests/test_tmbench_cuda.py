"""One short run of a cell on the card (``python -m pytest -q -m cuda
tmbench/tests``); skips without one."""

import subprocess
import sys

import pytest

from .conftest import REPO, last_json

pytestmark = pytest.mark.cuda


def test_mnist_bulk_runs_correct_on_the_card(card):
    proc = subprocess.run(
        [sys.executable, "tmbench/run.py", "--workload", "mnist-bulk", "--seed",
         str(2**31 + 21), "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_json(proc.stdout)
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert 0 < line["metrics"]["engine_roofline"]["value"] <= 100
    assert line["device"]["busy_s"] > 0
