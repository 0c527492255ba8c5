"""The port's ``sharded`` serving engine (``repro_torch.accel.engines.
ShardedEngine``) on CPU meshes of 1, 2 and 4 tiles, exactly: the same
``TMProgram`` bytes served through ``Accelerator(mesh=)`` and
``TMServer(engine="sharded", mesh=)`` give the dense oracle's class sums
and the JAX ``plan`` engine's, across a hot-swap, a rollback and a pruned
weighted model, with one operand signature; the capability flags, the
selection with and without a mesh, mesh forwarding, the capacity checks
of the reference's sharded engine and the ``ShardedExecutor`` shim.

The reference's sharded engine builds and validates on this jax but
does not serve (``shard_map(check_rep=)``), so its sums are held to the
reference's ``plan`` engine and the oracle.
"""

import warnings

import numpy as np
import pytest
import torch

from repro.accel import ENGINES as JENGINES
from repro.accel import Accelerator as JAccelerator
from repro.accel import CapacityPlan as JCapacityPlan
from repro.accel import make_engine as jmake_engine
from repro.accel import select_engine as jselect_engine
from repro_torch.accel import (
    ENGINES,
    Accelerator,
    CapacityPlan,
    ShardedEngine,
    TMProgram,
    engine_names,
    make_engine,
    select_engine,
)
from repro_torch.core import compress, tm
from repro_torch.dist import make_mesh
from repro_torch.prune import PrunePolicy
from repro_torch.serve_tm import TMServer

M, C, F = 5, 10, 30
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]


def _models(seed):
    rng = np.random.default_rng(seed)
    cfg = tm.TMConfig(M, C, F)
    acts_a = rng.random((M, C, 2 * F)) < 0.08
    acts_b = rng.random((M, C, 2 * F)) < 0.08
    acts_b[3] = False  # a class with zero includes
    w_b = rng.integers(1, 8, (M, C))
    return rng, cfg, (acts_a, None), (acts_b, w_b)


def _oracle(cfg, acts, w, x):
    return tm.batch_class_sums_weighted(
        cfg, tm.state_from_actions(cfg, torch.from_numpy(acts)),
        torch.from_numpy(x), None if w is None else torch.from_numpy(w),
    ).numpy()


@pytest.mark.parametrize("shape", MESHES)
def test_swaps_and_rollback_serve_the_oracle_and_the_reference(shape):
    rng, cfg, (acts_a, _), (acts_b, w_b) = _models(1)
    a, b = compress.encode(cfg, acts_a), compress.encode(cfg, acts_b, w_b)
    mesh = make_mesh(shape, devices="cpu")
    acc = Accelerator.for_models([a, b], batch_words=2, mesh=mesh)
    assert acc.engine.name == "sharded" and acc.engine.mesh is mesh
    assert acc.engine.device == torch.device("cpu")
    assert acc.compile_cache_size() == 0
    jacc = JAccelerator(JCapacityPlan(**acc.plan.as_dict()), engine="plan")
    x = rng.integers(0, 2, (40, F), dtype=np.uint8)
    blob_a = acc.compile(a).to_bytes()
    acc.load("s", blob_a)
    jacc.load("s", blob_a)
    sums_a = acc.class_sums("s", x)
    assert np.abs(sums_a).sum() > 0
    np.testing.assert_array_equal(sums_a, _oracle(cfg, acts_a, None, x))
    np.testing.assert_array_equal(sums_a, np.asarray(jacc.class_sums("s", x)))
    queued = acc.submit("s", x)  # drained under a by the swap
    blob_b = acc.compile(b).to_bytes()
    acc.load("s", blob_b, provenance="swap")
    jacc.load("s", blob_b, provenance="swap")
    np.testing.assert_array_equal(queued.result(), sums_a.argmax(1))
    sums_b = acc.class_sums("s", x)
    np.testing.assert_array_equal(sums_b, _oracle(cfg, acts_b, w_b, x))
    np.testing.assert_array_equal(sums_b, np.asarray(jacc.class_sums("s", x)))
    assert not sums_b[:, 3].any()
    acc.rollback("s")
    jacc.rollback("s")
    np.testing.assert_array_equal(acc.class_sums("s", x), sums_a)
    np.testing.assert_array_equal(acc.infer("s", x[:1]), sums_a[:1].argmax(1))
    assert acc.installed_checksum("s") == jacc.installed_checksum("s")
    assert acc.compile_cache_size() == 1


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_a_pruned_weighted_model_serves_its_oracle(shape):
    """Exact pruning and merging make a weighted (v2) model; its weights
    fold into the polarity tables (weight x polarity up to 7)."""
    rng, cfg, (acts_a, _), _ = _models(2)
    acts = acts_a.copy()
    acts[:, 1::2] = acts[:, 0::2]  # duplicates of opposite polarity cancel
    acts[0, 4] = acts[0, 2]  # a duplicate that merges into a weight
    acts[0, 6] = acts[0, 2]
    result = PrunePolicy().apply(cfg, acts, device="cpu")
    assert result.weights is not None and result.weights.max() > 1
    model = compress.encode(cfg, result.actions, result.weights)
    x = rng.integers(0, 2, (64, F), dtype=np.uint8)
    plan = CapacityPlan.for_models([model], batch_words=2)
    server = TMServer(plan, engine="sharded", mesh=make_mesh(shape, devices="cpu"))
    server.register("p", TMProgram(plan, model).to_bytes())
    jacc = JAccelerator(JCapacityPlan(**plan.as_dict()), engine="plan")
    jacc.load("p", TMProgram(plan, model).to_bytes())
    got = server.class_sums("p", x)
    np.testing.assert_array_equal(got, np.asarray(jacc.class_sums("p", x)))
    np.testing.assert_array_equal(got, _oracle(cfg, acts, None, x))
    np.testing.assert_array_equal(
        got, _oracle(cfg, result.actions, result.weights.astype(np.int64), x))


def test_flags_selection_and_mesh_forwarding():
    assert engine_names() == sorted(JENGINES) == ["interp", "plan", "popcount", "sharded"]
    ours, theirs = ENGINES["sharded"], JENGINES["sharded"]
    assert ours is ShardedEngine
    for attr in ("needs_mesh", "priority", "validated_knobs", "needs_decoded_plan",
                 "instruction_metric"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert [n for n, c in ENGINES.items() if c.needs_mesh] == ["sharded"]
    mesh = make_mesh((1, 2), devices="cpu")
    plan = CapacityPlan()
    assert select_engine(plan) == jselect_engine() == "popcount"
    assert select_engine(plan, mesh=mesh) == "sharded"
    # the mesh goes to mesh engines only
    assert make_engine("popcount", plan, mesh=mesh, device="cpu").name == "popcount"
    eng = make_engine("sharded", plan, mesh=mesh)
    assert eng.mesh is mesh and eng.device.type == "cpu"
    assert make_engine("sharded", plan, device="cpu").mesh.shape == {"data": 1, "model": 1}
    assert TMServer(plan, mesh=mesh).executor.name == "sharded"
    assert Accelerator(plan, mesh=mesh).engine.name == "sharded"
    assert Accelerator(plan, engine="plan", mesh=mesh, device="cpu").engine.name == "plan"


def test_without_a_mesh_or_device_the_engine_sits_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_engine("sharded", CapacityPlan())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Accelerator(CapacityPlan(), engine="sharded")


def test_capacity_checks_match_the_reference_sharded_engine():
    """The sharded layout instantiates the clause tables, not the
    instruction memory: it refuses exactly what the reference's refuses."""
    rng = np.random.default_rng(9)
    cfg = tm.TMConfig(2, 4, 6)
    acts = rng.random((2, 4, 12)) < 0.3
    model = compress.encode(cfg, acts, np.full((2, 4), 9, np.int64))
    plans = [
        CapacityPlan(instruction_capacity=32, feature_capacity=32, class_capacity=2,
                     clause_capacity=4, include_capacity=12),
        CapacityPlan(instruction_capacity=32, feature_capacity=32, class_capacity=2,
                     clause_capacity=2, include_capacity=2),
    ]
    for plan in plans:
        ours = make_engine("sharded", plan, mesh=make_mesh((1, 2), devices="cpu"))
        theirs = jmake_engine("sharded", JCapacityPlan(**plan.as_dict()))
        assert ours.model_violations(model) == theirs.model_violations(model)


def test_sharded_executor_through_the_shim():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro_torch.serve_tm import executors as ex
    assert ex.ShardedExecutor is ShardedEngine and "ShardedExecutor" in ex.__all__
    mesh = make_mesh((2, 1), devices="cpu")
    with pytest.warns(DeprecationWarning, match="make_engine"):
        eng = ex.make_executor("sharded", ex.ServeCapacity(batch_words=1), mesh)
    assert isinstance(eng, ShardedEngine) and eng.mesh is mesh
    rng, cfg, (acts_a, _), _ = _models(3)
    model = compress.encode(cfg, acts_a)
    x = rng.integers(0, 2, (32, F), dtype=np.uint8)
    prog = eng.program(model)
    np.testing.assert_array_equal(eng.class_sums(prog, x), _oracle(cfg, acts_a, None, x))
    assert eng.compile_cache_size() == 1
