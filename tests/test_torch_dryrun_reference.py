"""The port's dry run beside the reference's compiled cells.

The reference's ``lower_cell`` is compiled in a subprocess with 8 host
devices on meshes of ``AxisType.Auto`` axes (``jax.make_mesh``'s
default Explicit axes make its ``hint`` raise on jax 0.9.0), for the
dense and xLSTM smoke archs, train / prefill / decode at 8 x 64, on
(1, 1) and (4, 2).  The port's argument bytes (from the spec trees) and
alias bytes (the donated buffers) equal XLA's ``memory_analysis`` on
every cell but one: XLA drops the ``pos`` argument the xLSTM decode
never reads (4 B).  Flops, bytes and collectives are counted
differently by design (XLA: elementwise ops too, a ``while`` body once;
the port: products only, every trip; see ``launch.dryrun``), so they are
printed side by side (``-s``), not compared."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("stablelm-3b-smoke", "xlstm-125m-smoke")
MESHES = ((1, 1), (4, 2))
KINDS = ("train", "prefill", "decode")

_REFERENCE = """
import json
import jax
from jax.sharding import AxisType
from repro.analysis.roofline import collective_bytes
from repro.configs.base import ShapeSpec
from repro.configs.registry import get
from repro.dist import sharding as shd
from repro.launch.dryrun import lower_cell
for arch in {archs}:
    for ms in {meshes}:
        mesh = jax.make_mesh(ms, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        for kind in {kinds}:
            c = lower_cell(get(arch), ShapeSpec("t", 64, 8, kind), mesh).compile()
            cost, mem = c.cost_analysis(), c.memory_analysis()
            print(json.dumps({{
                "cell": [arch, list(ms), kind], "flops": float(cost["flops"]),
                "bytes": float(cost["bytes accessed"]),
                "coll": {{k: v for k, v in collective_bytes(c.as_text()).items() if v}},
                "argument": float(mem.argument_size_in_bytes),
                "alias": float(mem.alias_size_in_bytes)}}))
    shd.set_activation_mesh(None)
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["DRYRUN_XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    code = _REFERENCE.format(archs=ARCHS, meshes=MESHES, kinds=KINDS)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    recs = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    return {(r["cell"][0], tuple(r["cell"][1]), r["cell"][2]): r for r in recs}


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_and_alias_bytes_equal_the_reference(arch, reference):
    for ms in MESHES:
        mesh = shd.make_mesh(ms, devices="meta")
        for kind in KINDS:
            ref = reference[arch, ms, kind]
            c = dryrun.lower_cell(get(arch), ShapeSpec("t", 64, 8, kind), mesh).compile()
            cost, mem = c.cost_analysis(), c.memory_analysis()
            coll = {k: v for k, v in c.collective_bytes().items() if v}
            print(f"{arch} {ms} {kind}: flops port {cost['flops']:.0f} / reference "
                  f"{ref['flops']:.0f}; bytes {cost['bytes accessed']:.0f} / "
                  f"{ref['bytes']:.0f}; collectives {coll} / {ref['coll']}; arguments "
                  f"{mem.argument_size_in_bytes:.0f} / {ref['argument']:.0f}")
            unread_pos = 4.0 if (arch.startswith("xlstm") and kind == "decode") else 0.0
            assert mem.argument_size_in_bytes == ref["argument"] + unread_pos
            assert mem.alias_size_in_bytes == ref["alias"]
