"""The port neither leaks into the reference nor falls back on its own:
it imports no JAX and nothing of ``repro`` (every module, the kernel
packages ``tm_popcount``, ``tm_interp``, ``clause_eval``,
``clause_matmul``, ``tm_train``, ``interp_stream``, ``clause_table`` and
``pack_literals``,
``prune``, ``data``, ``dist``, ``core.runtime`` and the LM modules
``configs``, ``optim``, ``models``, ``launch.serve``, ``launch.train``,
``launch.mesh``, ``runtime_ft.elastic`` and the dry run's
``analysis.roofline``, ``analysis.corrections``, ``analysis.report`` and
``launch.dryrun`` among them,
imports without ``nvcc``);
its entry points refuse to run without a CUDA card unless
``device="cpu"`` is asked for; the kernel wrappers send a CUDA tensor to
the kernel, never to the plain twin; and the deprecated executor shim
warns once per process.
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
from repro_torch.dist import make_mesh
from repro_torch.kernels import _build
from repro_torch.kernels.tm_popcount import kernel, ops
from repro_torch.recal import RecalWorker, make_train_engine
from repro_torch.serve_tm import TMServer

SRC = Path(__file__).resolve().parents[1] / "src"
KERNELS = ["clause_eval", "clause_matmul", "clause_table", "interp_stream",
           "pack_literals", "tm_interp", "tm_popcount", "tm_train"]
MODULES = ["repro_torch.core.runtime", "repro_torch.core.interp",
           "repro_torch.core.booleanize", "repro_torch.data.pipeline",
           "repro_torch.prune.rank", "repro_torch.prune.passes",
           "repro_torch.serve_tm.executors", "repro_torch.fleet.pool",
           "repro_torch.fleet.router", "repro_torch.fleet.health",
           "repro_torch.fleet.chaos", "repro_torch.fleet.rollout",
           "repro_torch.runtime_ft.supervisor", "repro_torch.checkpoint.manager",
           "repro_torch.dist", "repro_torch.dist.sharding", "repro_torch.dist.tm_sharded",
           "repro_torch.dist.steps", "repro_torch.kernels.clause_table.kernel",
           "repro_torch.kernels.clause_table.ref", "repro_torch.tree",
           "repro_torch.configs.base", "repro_torch.configs.registry",
           "repro_torch.optim.adamw", "repro_torch.optim.compress",
           "repro_torch.models.common", "repro_torch.models.moe",
           "repro_torch.models.dense", "repro_torch.models.ssm",
           "repro_torch.models.xlstm", "repro_torch.models.recurrent_lm",
           "repro_torch.models.encdec", "repro_torch.models.api",
           "repro_torch.launch.serve", "repro_torch.convert",
           "repro_torch.launch.train", "repro_torch.launch.mesh",
           "repro_torch.runtime_ft.elastic", "repro_torch.analysis.roofline",
           "repro_torch.analysis.corrections", "repro_torch.analysis.report",
           "repro_torch.launch.dryrun", "repro_torch.dist.collectives"]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaks = sorted(m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "jaxlib"))
               or m == "repro" or m.startswith("repro."))
kernels = sorted({n.split(".")[2] for n in names if n.startswith("repro_torch.kernels.")})
print(len(names), ",".join(kernels), ",".join(names), leaks)
"""


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=120, env={
            **os.environ, "PYTHONPATH": str(SRC),
            "CUDA_HOME": str(SRC / "no-such-toolkit"),  # no nvcc to be found
        },
    )
    assert out.returncode == 0, out.stderr
    n_modules, kernels, names, leaks = out.stdout.split(maxsplit=3)
    assert int(n_modules) >= 40
    assert set(KERNELS) <= set(kernels.split(","))
    assert set(MODULES) <= set(names.split(","))
    assert leaks.strip() == "[]"


def _model():
    rng = np.random.default_rng(0)
    cfg = tm.TMConfig(3, 4, 10)
    return compress.encode(cfg, rng.random((3, 4, 20)) < 0.2)


@pytest.mark.parametrize("entry", ["Accelerator", "for_models", "TMServer",
                                   "make_engine", "resolve_device",
                                   "RecalWorker", "make_train_engine",
                                   "interp engine", "plan engine",
                                   "core.runtime.Accelerator", "MultiCoreAccelerator",
                                   "to_device_bool", "clause_fire_counts",
                                   "vote_contribution", "prune_ranked",
                                   "PrunePolicy.apply", "make_mesh", "sharded engine",
                                   "sharded train engine", "init_params", "Server",
                                   "make_train_step", "batch_to_device",
                                   "lm_params_from_numpy", "XLSTM.init_params",
                                   "Zamba2.init_params", "Whisper.init_params",
                                   "Server with a mesh", "launch.train.main",
                                   "make_production_mesh", "shard_batch"])
def test_entry_points_refuse_to_fall_back_to_the_cpu(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    from repro_torch import prune
    from repro_torch.configs.registry import get
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.core import booleanize, runtime
    from repro_torch.data.pipeline import batch_to_device, shard_batch
    from repro_torch.dist import make_train_step, opt_config_for, sharding
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.models import api, dense

    plan = CapacityPlan.for_models([_model()])
    cfg = tm.TMConfig(3, 4, 10)
    acts = np.random.default_rng(0).random((3, 4, 20)) < 0.2
    x = np.zeros((8, 10), np.uint8)
    y = np.zeros(8, np.int32)
    lm = get("stablelm-3b-smoke")
    # a mesh of the card, as one built on a machine that has it
    card_mesh = sharding.Mesh(np.full((1, 1), torch.device("cuda", 0), object),
                              ("data", "model"))
    calls = {
        "Accelerator": lambda: Accelerator(plan),
        "for_models": lambda: Accelerator.for_models([_model()]),
        "TMServer": lambda: TMServer(plan),
        "make_engine": lambda: make_engine("popcount", plan),
        "resolve_device": lambda: resolve_device(),
        "RecalWorker": lambda: RecalWorker(tm.TMConfig(3, 4, 10)),
        "make_train_engine": lambda: make_train_engine("packed", tm.TMConfig(3, 4, 10)),
        "interp engine": lambda: make_engine("interp", plan),
        "plan engine": lambda: make_engine("plan", plan),
        "core.runtime.Accelerator": lambda: runtime.Accelerator(),
        "MultiCoreAccelerator": lambda: runtime.MultiCoreAccelerator(2),
        "to_device_bool": lambda: booleanize.to_device_bool(x),
        "clause_fire_counts": lambda: prune.clause_fire_counts(cfg, acts, x),
        "vote_contribution": lambda: prune.vote_contribution(cfg, acts, x),
        "prune_ranked": lambda: prune.prune_ranked(cfg, acts, x, y, tolerance=0.1),
        "PrunePolicy.apply": lambda: prune.PrunePolicy(tolerance=0.1).apply(
            cfg, acts, X=x, y=y),
        "make_mesh": lambda: make_mesh((2, 2)),
        "sharded engine": lambda: make_engine("sharded", plan),
        "sharded train engine": lambda: make_train_engine("sharded", cfg),
        "init_params": lambda: dense.init_params(lm, 0),
        "Server": lambda: Server(lm, batch=2, prompt_cap=8),
        "make_train_step": lambda: make_train_step(lm, opt_config_for(lm)),
        "batch_to_device": lambda: batch_to_device({"tokens": x}),
        "lm_params_from_numpy": lambda: lm_params_from_numpy(lm, {}),
        **{f"{name}.init_params": (lambda a: lambda: api.family_for(get(a)).init_params(
            get(a), 0))(arch) for name, arch in (("XLSTM", "xlstm-125m-smoke"),
                                                 ("Zamba2", "zamba2-2.7b-smoke"),
                                                 ("Whisper", "whisper-medium-smoke"))},
        "Server with a mesh": lambda: Server(lm, card_mesh, batch=2, prompt_cap=8),
        "launch.train.main": lambda: train.main(["--arch", "stablelm-3b-smoke",
                                                 "--steps", "1"]),
        "make_production_mesh": lambda: make_production_mesh(),
        "shard_batch": lambda: shard_batch({"tokens": x}, card_mesh, {
            "tokens": sharding.NamedSharding(card_mesh, sharding.P("data", None))}),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    assert Accelerator(plan, device="cpu").engine.device.type == "cpu"
    if entry in ("Server with a mesh", "shard_batch"):
        cpu_mesh = make_mesh((1, 1), devices="cpu")
        assert Server(lm, cpu_mesh, batch=2, prompt_cap=8, device="cpu").mesh is cpu_mesh
        sharding.set_activation_mesh(None)
        placed = shard_batch({"tokens": x}, cpu_mesh, {
            "tokens": sharding.NamedSharding(cpu_mesh, sharding.P("data", None))})
        assert placed["tokens"].device.type == "cpu"
    if entry in ("init_params", "Server", "make_train_step"):
        params = dense.init_params(lm, 0, device="cpu")
        assert params.embed.device.type == "cpu"
        assert Server(lm, batch=2, prompt_cap=8, device="cpu").device.type == "cpu"
        make_train_step(lm, opt_config_for(lm), device="cpu")


def test_resolve_device_rejects_other_devices():
    assert resolve_device("cpu") == torch.device("cpu")
    # the dry run's device, only when asked for by name
    assert resolve_device("meta") == torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")


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
        kernel.popcount_program(*_operands("meta")[:4])


def test_cpu_tensors_run_the_plain_twin_and_count_no_launch():
    before = kernel.launches
    args = _operands("cpu")
    program = kernel.popcount_program(*args[:4])
    assert torch.equal(kernel.tm_popcount(program, args[4]),
                       kernel.tm_popcount_plain(*args))
    assert kernel.launches == before


def test_build_without_nvcc_raises_clearly(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(SRC / "no-such-toolkit"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
    assert _build.kernel_names() == KERNELS


@pytest.mark.cuda
def test_cuda_tensors_launch_the_kernel_not_the_twin(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _operands("cuda")

    def no_twin(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain twin")

    want = kernel.tm_popcount_plain(*args)
    monkeypatch.setattr(kernel, "tm_popcount_plain", no_twin)
    program = kernel.popcount_program(*args[:4])
    before = kernel.launches
    got = kernel.tm_popcount(program, args[4])
    assert kernel.launches == before + 2
    assert torch.equal(got, want)


def _dense_and_interp_calls(device):
    """(module, wrapper call, plain-twin name, launches per call) for each
    kernel of the dense and interpreter paths, on small operands on
    ``device``."""
    from repro_torch.kernels.clause_eval import kernel as ce
    from repro_torch.kernels.clause_matmul import kernel as cm
    from repro_torch.core.interp import pack_features
    from repro_torch.kernels.interp_stream import kernel as ist
    from repro_torch.kernels.pack_literals import kernel as plk
    from repro_torch.kernels.tm_interp import kernel as ti
    from repro_torch.kernels.tm_interp.ops import plan_to_operands

    rng = np.random.default_rng(2)
    acts = torch.from_numpy((rng.random((12, 20)) < 0.2).astype(np.int32)).to(device)
    lits = torch.from_numpy(rng.integers(0, 2, (20, 64)).astype(np.int32)).to(device)
    packed = tm.pack_literals(torch.from_numpy(
        rng.integers(0, 2, (64, 10), dtype=np.uint8)
    )).to(device)
    plan = compress.decode_to_plan(_model())
    operands = [torch.from_numpy(a).to(device) for a in plan_to_operands(plan, 64)]
    from repro_torch.core import prng
    from repro_torch.kernels.tm_train import kernel as tt, pack_ta_state

    cfg = tm.TMConfig(3, 4, 10)
    state = pack_ta_state(cfg, torch.from_numpy(
        rng.integers(1, 257, (3, 4, 20)).astype(np.int32))).to(device)
    x = torch.from_numpy(rng.integers(0, 2, (37, 10), dtype=np.uint8)).to(device)
    y = torch.from_numpy(rng.integers(0, 3, 37).astype(np.int32)).to(device)
    model = _model()
    imem = torch.from_numpy(model.instructions.astype(np.int32)).to(device)
    feats = pack_features(x, 16, 2)
    block = torch.from_numpy(rng.integers(0, 2, (64, 10), dtype=np.uint8)).to(device)
    return [  # (..., CUDA launches per call)
        (plk, lambda: plk.pack_literals(block), "pack_literals_plain", 1),
        (ce, lambda: ce.clause_eval(acts, packed), "clause_eval_plain", 1),
        (tt, lambda: tt.fused_train_batch(cfg, state, prng.key(3), x, y),
         "tm_train_plain", 2),
        (cm, lambda: cm.clause_matmul(acts, lits), "clause_matmul_plain", 2),
        (ti, lambda: ti.tm_interp(*operands, packed, m_cap=3), "tm_interp_plain", 1),
        (ist, lambda: ist.interp_stream(imem, model.n_instructions, feats, m_cap=3),
         "interpret_stream_plain", 2),
    ]


@pytest.mark.cuda
def test_cuda_tensors_launch_the_new_kernels_not_their_twins(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def no_twin(*a, **k):
        raise AssertionError("a CUDA tensor reached a plain twin")

    for module, call, twin, n in _dense_and_interp_calls("cuda"):
        monkeypatch.setattr(module, twin, no_twin)
        before = module.launches
        call()
        torch.cuda.synchronize()
        assert module.launches == before + n, module.__name__


def test_executor_shim_warns_once_per_process():
    probe = (
        "import importlib, warnings\n"
        "warnings.simplefilter('always')\n"
        "with warnings.catch_warnings(record=True) as seen:\n"
        "    import repro_torch.serve_tm.executors as ex\n"
        "    importlib.import_module('repro_torch.serve_tm.executors')\n"
        "    import repro_torch.serve_tm.executors\n"
        "e = ex.make_executor('interp', ex.ServeCapacity(), device='cpu')\n"
        "print(sum(issubclass(w.category, DeprecationWarning) for w in seen),\n"
        "      type(e).__name__, ex.PlanExecutor.__name__, ex.PopcountExecutor.__name__)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", probe], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(SRC)},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "InterpEngine", "PlanEngine", "PopcountEngine"]
