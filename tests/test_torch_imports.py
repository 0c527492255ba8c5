"""The port neither leaks into the reference nor falls back on its own:
it imports no JAX and nothing of ``repro``; its entry points refuse to
run without a CUDA card unless ``device="cpu"`` is asked for; and the
``tm_popcount`` wrapper sends a CUDA tensor to the kernel, never to the
plain twin.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.accel import Accelerator, CapacityPlan, make_engine
from repro_torch.core import compress, tm
from repro_torch.core.bits import from_u32
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.tm_popcount import kernel, ops
from repro_torch.serve_tm import TMServer

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaks = sorted(m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "jaxlib"))
               or m == "repro" or m.startswith("repro."))
print(len(names), leaks)
"""


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(SRC)},
    )
    assert out.returncode == 0, out.stderr
    n_modules, leaks = out.stdout.split(maxsplit=1)
    assert int(n_modules) >= 20
    assert leaks.strip() == "[]"


def _model():
    rng = np.random.default_rng(0)
    cfg = tm.TMConfig(3, 4, 10)
    return compress.encode(cfg, rng.random((3, 4, 20)) < 0.2)


@pytest.mark.parametrize("entry", ["Accelerator", "for_models", "TMServer",
                                   "make_engine", "resolve_device"])
def test_entry_points_refuse_to_fall_back_to_the_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    plan = CapacityPlan.for_models([_model()])
    calls = {
        "Accelerator": lambda: Accelerator(plan),
        "for_models": lambda: Accelerator.for_models([_model()]),
        "TMServer": lambda: TMServer(plan),
        "make_engine": lambda: make_engine("popcount", plan),
        "resolve_device": lambda: resolve_device(),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    assert Accelerator(plan, device="cpu").engine.device.type == "cpu"


def test_resolve_device_rejects_other_devices():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def _operands(device):
    plan = compress.decode_to_plan(_model())
    li, last, mp, mn = ops.plan_to_popcount_operands(plan, 64, 3)
    x = np.random.default_rng(1).integers(0, 2, (64, 10), dtype=np.uint8)
    return (
        torch.from_numpy(li).to(device), torch.from_numpy(last).to(device),
        from_u32(mp, device), from_u32(mn, device),
        tm.pack_literals(torch.from_numpy(x)).to(device),
    )


def test_wrapper_raises_on_a_device_it_has_no_kernel_for():
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        kernel.tm_popcount(*_operands("meta"))


def test_cpu_tensors_run_the_plain_twin_and_count_no_launch():
    before = kernel.launches
    args = _operands("cpu")
    assert torch.equal(kernel.tm_popcount(*args), kernel.tm_popcount_plain(*args))
    assert kernel.launches == before


def test_build_without_nvcc_raises_clearly(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(SRC / "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    assert _build.kernel_names() == ["tm_popcount"]


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernel_not_the_twin(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _operands("cuda")

    def no_twin(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain twin")

    want = kernel.tm_popcount_plain(*args)
    monkeypatch.setattr(kernel, "tm_popcount_plain", no_twin)
    before = kernel.launches
    got = kernel.tm_popcount(*args)
    assert kernel.launches == before + 2
    assert torch.equal(got, want)
