"""A tiny run on the CPU loads neither JAX nor the JAX package, and
opens nothing under ``benchmarks/``."""

import json

from .conftest import run_python

STUB = '''"""A stand-in for the JAX package: only its name counts."""
'''

READER_THAT_LOADS_IT = '''
import repro  # noqa: F401


def read(run):
    return 1.0
'''

PROBE = r"""
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args and isinstance(args[0], str) else None)
from tmbench import harness
from tmbench import control
harness.execute(".", "tiny", 2**31 + 3, 0.5, True, "cpu", out=sys.stderr)
print(json.dumps({"modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": opened}))
"""


def test_no_jax_and_no_benchmarks_folder(tiny_copy):
    proc = run_python(tiny_copy, PROBE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    tops = set(seen["modules"])
    assert "repro_torch" in tops and "tmbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops & {"jax", "jaxlib", "flax", "repro"}
    assert not [p for p in seen["opened"] if "/benchmarks/" in p or p.startswith("benchmarks")]


def test_a_reader_that_loads_the_jax_package_gets_no_result(tiny_copy):
    """The gate runs after every reader: one that loads the JAX package
    (here a stub under its name) leaves the run with no result line."""
    (tiny_copy / "repro.py").write_text(STUB)
    (tiny_copy / "tmbench" / "layer_metrics" / "loads_repro.py").write_text(READER_THAT_LOADS_IT)
    bench = json.loads((tiny_copy / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "loads_repro", "unit": "ratio", "better": "higher",
        "source": "host_clock", "layer": "device", "moves": "rows_per_s"})
    (tiny_copy / "BENCHMARK.json").write_text(json.dumps(bench))
    proc = run_python(tiny_copy, "from tmbench import harness; "
                      "harness.execute('.', 'tiny', 7, 0.5, True, 'cpu')")
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "the run loaded repro" in proc.stderr
