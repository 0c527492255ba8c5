"""``correct`` on the CPU at a tiny size: true for the program, false
for the tie-rule control and for each fault planted under the scheduler;
the narrower integer controls compute the same sums."""

import json

from .conftest import run_python

PROBE = r"""
import json
from tmbench import control
for seed in (7, 2**31 + 11):
    for variant, res in control.readings(".", "tiny", seed, 0.5, "cpu", True):
        print(json.dumps({"variant": variant, "correct": res["correct"],
                          **{k: v["value"] for k, v in res["checks"].items()}}))
"""


def test_control_and_faults_fail_the_program_passes(tiny_copy):
    proc = run_python(tiny_copy, PROBE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert len(lines) == 2 * 6
    for line in lines:
        if line["variant"] in ("program", "int16", "int8"):
            assert line["correct"], line
        else:
            assert not line["correct"], line
        if line["variant"] == "tie_high":
            assert line["rows_wrong_class"] > 0 and line["rows_wrong_sums"] == 0
        if line["variant"] in ("answer_altered", "half_batch_left_out"):
            assert line["rows_wrong_sums"] > 0
