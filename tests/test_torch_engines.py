"""The port's ``interp`` and ``plan`` engines (``repro_torch.accel.
engines``) against the JAX reference's engines of those names and the
port's ``popcount`` engine, on the CPU (``device="cpu"``), exactly: the
same ``TMProgram`` bytes, weighted and weightless, served through the
port's ``Accelerator(engine=...)`` give the reference's class sums and the
dense oracle's, across hot-swaps and a rollback with one operand
signature; the engines keep the reference's capabilities and capacity
checks; auto-selection still picks ``popcount`` (the ``sharded`` engine,
registered beside them, is eligible only with a mesh:
tests/test_torch_sharded_engine.py).
"""

import numpy as np
import pytest
import torch

from repro.accel import ENGINES as JENGINES
from repro.accel import Accelerator as JAccelerator
from repro.accel import CapacityPlan as JCapacityPlan
from repro.accel import make_engine as jmake_engine
from repro_torch.accel import (
    ENGINES,
    Accelerator,
    CapacityPlan,
    InterpEngine,
    PlanEngine,
    TMProgram,
    engine_names,
    make_engine,
    select_engine,
)
from repro_torch.core import compress, tm

M, C, F = 5, 10, 30


def _models(seed):
    rng = np.random.default_rng(seed)
    cfg = tm.TMConfig(M, C, F)
    acts_a = rng.random((M, C, 2 * F)) < 0.08
    acts_b = rng.random((M, C, 2 * F)) < 0.12
    acts_b[3] = False  # a class with zero includes
    w_b = rng.integers(1, 6, (M, C))
    return rng, cfg, (acts_a, None), (acts_b, w_b)


def _oracle(cfg, acts, w, x):
    return tm.batch_class_sums_weighted(
        cfg, tm.state_from_actions(cfg, torch.from_numpy(acts)),
        torch.from_numpy(x), None if w is None else torch.from_numpy(w),
    ).numpy()


def test_registry_and_auto_selection():
    assert engine_names() == ["interp", "plan", "popcount", "sharded"]
    assert ENGINES["interp"] is InterpEngine and ENGINES["plan"] is PlanEngine
    assert select_engine() == select_engine(CapacityPlan()) == "popcount"
    for name in ("interp", "plan", "popcount", "sharded"):
        ours, theirs = ENGINES[name], JENGINES[name]
        assert ours.needs_mesh == theirs.needs_mesh
        assert ours.priority == theirs.priority
        assert ours.validated_knobs == theirs.validated_knobs
        assert ours.instruction_metric == theirs.instruction_metric
        assert ours.needs_decoded_plan == theirs.needs_decoded_plan


@pytest.mark.parametrize("engine", ["interp", "plan"])
@pytest.mark.parametrize("weighted", [False, True])
def test_same_bytes_serve_the_reference_sums(engine, weighted):
    rng, cfg, (acts_a, _), (acts_b, w_b) = _models(0)
    acts, w = (acts_b, w_b) if weighted else (acts_a, None)
    models = [compress.encode(cfg, acts_a), compress.encode(cfg, acts_b, w_b)]
    plan = CapacityPlan.for_models(models, batch_words=2)
    blob = TMProgram(plan, compress.encode(cfg, acts, w)).to_bytes()
    acc = Accelerator(plan, engine=engine, device="cpu")
    pop = Accelerator(plan, engine="popcount", device="cpu")
    jacc = JAccelerator(JCapacityPlan(**plan.as_dict()), engine=engine)
    for a in (acc, pop, jacc):
        a.load("s", blob)
    assert acc.engine.name == engine and acc.engine.device.type == "cpu"
    x = rng.integers(0, 2, (150, F), dtype=np.uint8)  # spans three batches
    sums = acc.class_sums("s", x[:64])
    assert sums.dtype == np.int32 and sums.shape == (64, M)
    np.testing.assert_array_equal(sums, np.asarray(jacc.class_sums("s", x[:64])))
    np.testing.assert_array_equal(sums, pop.class_sums("s", x[:64]))
    np.testing.assert_array_equal(sums, _oracle(cfg, acts, w, x[:64]))
    np.testing.assert_array_equal(acc.infer("s", x), np.asarray(jacc.infer("s", x)))
    assert acc.installed_checksum("s") == jacc.installed_checksum("s")


@pytest.mark.parametrize("engine", ["interp", "plan"])
def test_swaps_and_rollback_keep_one_signature(engine):
    rng, cfg, (acts_a, _), (acts_b, w_b) = _models(1)
    a, b = compress.encode(cfg, acts_a), compress.encode(cfg, acts_b, w_b)
    acc = Accelerator.for_models([a, b], batch_words=2, engine=engine, device="cpu")
    assert acc.compile_cache_size() == 0
    x = rng.integers(0, 2, (40, F), dtype=np.uint8)
    acc.load("s", acc.compile(a).to_bytes())
    queued = acc.submit("s", x)  # drained under a by the swap
    acc.load("s", acc.compile(b), provenance="swap")
    np.testing.assert_array_equal(queued.result(), _oracle(cfg, acts_a, None, x).argmax(1))
    np.testing.assert_array_equal(acc.class_sums("s", x), _oracle(cfg, acts_b, w_b, x))
    acc.rollback("s")
    np.testing.assert_array_equal(acc.class_sums("s", x), _oracle(cfg, acts_a, None, x))
    assert acc.compile_cache_size() == 1


@pytest.mark.parametrize("engine", ["interp", "plan", "popcount"])
def test_capacity_checks_match_the_reference(engine):
    """Each engine refuses exactly what the reference engine of its name
    refuses: interp reads its weight memory (no weight_planes knob) and
    the whole stream, plan the includes and the clause table."""
    rng = np.random.default_rng(9)
    cfg = tm.TMConfig(2, 4, 6)
    acts = rng.random((2, 4, 12)) < 0.3
    model = compress.encode(cfg, acts, np.full((2, 4), 9, np.int64))
    plans = [
        CapacityPlan(instruction_capacity=32, feature_capacity=32, class_capacity=2,
                     clause_capacity=4, weight_planes=2),
        CapacityPlan(instruction_capacity=model.n_instructions - 1, feature_capacity=32,
                     class_capacity=2, clause_capacity=2, weight_planes=4),
    ]
    opts = {"implementation": "xla"} if engine == "popcount" else {}
    for plan in plans:
        ours = make_engine(engine, plan, device="cpu")
        theirs = jmake_engine(engine, JCapacityPlan(**plan.as_dict()), **opts)
        assert ours.model_violations(model) == theirs.model_violations(model)
