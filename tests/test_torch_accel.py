"""The port's serving path (repro_torch.accel + serve_tm) against the JAX
reference, on the CPU (``device="cpu"``): the same TMProgram bytes give
the same predictions and class sums; hot-swaps between weighted and
weightless models and a rollback keep one kernel operand signature
(``compile_cache_size() == 1``); the metrics schema is the reference's;
``convert`` carries a JAX-built model and state across.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.accel import Accelerator as JAccelerator
from repro.accel import CapacityPlan as JCapacityPlan
from repro.core import compress as jcomp
from repro.core import tm as jtm
from repro.serve_tm import schema as jschema
from repro_torch import convert
from repro_torch.accel import (
    Accelerator,
    CapacityExceeded,
    CapacityPlan,
    PopcountEngine,
    TMProgram,
    make_engine,
    select_engine,
)
from repro_torch.core import compress, tm
from repro_torch.serve_tm import TMServer, schema

M, C, F = 5, 10, 30


def _models(seed):
    rng = np.random.default_rng(seed)
    cfg = tm.TMConfig(M, C, F)
    acts_a = rng.random((M, C, 2 * F)) < 0.08
    acts_b = rng.random((M, C, 2 * F)) < 0.12
    acts_b[3] = False  # a class with zero includes
    w_b = rng.integers(1, 6, (M, C))
    a = compress.encode(cfg, acts_a)
    b = compress.encode(cfg, acts_b, w_b)
    return rng, cfg, (acts_a, None, a), (acts_b, w_b, b)


def _oracle(cfg, acts, w, x):
    return tm.batch_class_sums_weighted(
        cfg, tm.state_from_actions(cfg, torch.from_numpy(acts)),
        torch.from_numpy(x), None if w is None else torch.from_numpy(w),
    ).numpy()


@pytest.mark.parametrize("weighted", [False, True])
def test_same_bytes_serve_the_same_as_reference(weighted):
    rng, cfg, ma, mb = _models(0)
    _, _, model = mb if weighted else ma
    acc = Accelerator.for_models([ma[2], mb[2]], batch_words=2, device="cpu")
    blob = acc.compile(model).to_bytes()
    jacc = JAccelerator(JCapacityPlan(**acc.plan.as_dict()))
    acc.load("s", blob)
    jacc.load("s", blob)
    x = rng.integers(0, 2, (150, F), dtype=np.uint8)  # spans three batches
    np.testing.assert_array_equal(
        acc.class_sums("s", x[:64]), np.asarray(jacc.class_sums("s", x[:64]))
    )
    np.testing.assert_array_equal(acc.infer("s", x), jacc.infer("s", x))
    acts, w, _ = mb if weighted else ma
    np.testing.assert_array_equal(
        acc.class_sums("s", x[:64]), _oracle(cfg, acts, w, x[:64])
    )
    assert acc.installed_checksum("s") == jacc.installed_checksum("s")


def test_hot_swap_and_rollback_keep_one_signature():
    rng, cfg, (acts_a, _, a), (acts_b, w_b, b) = _models(1)
    acc = Accelerator.for_models([a, b], batch_words=2, device="cpu")
    assert isinstance(acc.engine, PopcountEngine)
    assert acc.compile_cache_size() == 0
    x = rng.integers(0, 2, (40, F), dtype=np.uint8)
    acc.load("s", acc.compile(a).to_bytes())
    h = acc.submit("s", x)
    acc.flush()
    np.testing.assert_array_equal(
        h.result(), _oracle(cfg, acts_a, None, x).argmax(1)
    )
    queued = acc.submit("s", x)  # drained under a by the swap
    entry = acc.load("s", acc.compile(b), provenance="swap")
    assert entry.version == 2
    np.testing.assert_array_equal(
        queued.result(), _oracle(cfg, acts_a, None, x).argmax(1)
    )
    np.testing.assert_array_equal(
        acc.infer("s", x), _oracle(cfg, acts_b, w_b, x).argmax(1)
    )
    entry = acc.rollback("s")
    assert entry.provenance == "rollback:v2->v1(load)"
    np.testing.assert_array_equal(
        acc.infer("s", x), _oracle(cfg, acts_a, None, x).argmax(1)
    )
    assert acc.compile_cache_size() == 1
    snap = acc.metrics_snapshot()
    assert snap["swaps"] == 3 and snap["rollbacks"] == 1


def test_scheduler_loop_serves_without_flush():
    rng, cfg, (acts_a, _, a), _ = _models(2)
    acc = Accelerator.for_models([a], batch_words=1, device="cpu")
    acc.load("s", a)
    acc.start()
    try:
        x = rng.integers(0, 2, (70, F), dtype=np.uint8)
        handles = [acc.submit("s", x[i:i + 10]) for i in range(0, 70, 10)]
        preds = np.concatenate([h.wait(timeout=30) for h in handles])
    finally:
        acc.stop()
    assert not acc.scheduler_running
    np.testing.assert_array_equal(preds, _oracle(cfg, acts_a, None, x).argmax(1))
    assert acc.compile_cache_size() == 1


def test_metrics_schema_matches_reference():
    assert schema.SUMMARY_KEYS == jschema.SUMMARY_KEYS
    assert schema.LANE_KEYS == jschema.LANE_KEYS
    assert schema.AGGREGATE_KEYS == jschema.AGGREGATE_KEYS
    assert schema.HEALTH_NODE_KEYS == jschema.HEALTH_NODE_KEYS
    rng, _, (_, _, a), _ = _models(3)
    acc = Accelerator.for_models([a], device="cpu")
    acc.load("s", a)
    acc.infer("s", rng.integers(0, 2, (33, F), dtype=np.uint8))
    snap = acc.metrics_snapshot()
    assert tuple(snap) == schema.SUMMARY_KEYS
    for lane in schema.LANES:
        assert tuple(snap["lanes"][lane]) == schema.LANE_KEYS
    assert snap["rows"] == 33 and snap["batches"] == 1


def test_capacity_errors_are_structured():
    _, _, (_, _, a), (_, _, b) = _models(4)
    plan = CapacityPlan.for_models([a], batch_words=1)
    server = TMServer(plan, device="cpu")
    assert server.executor.name == select_engine(plan) == "popcount"
    with pytest.raises(CapacityExceeded) as err:
        server.register("s", b)  # b needs weight planes a's plan lacks
    assert err.value.knob in ("instruction_capacity", "weight_planes")
    server.register("s", a)
    with pytest.raises(CapacityExceeded) as err:
        server.class_sums("s", np.zeros((33, F), np.uint8))
    assert err.value.knob == "batch_words"


def test_staging_is_zero_copy_for_batcher_views():
    _, _, (_, _, a), _ = _models(5)
    engine = make_engine("popcount", CapacityPlan.for_models([a]), device="cpu")
    st = engine.staging
    assert st.dtype == np.uint8 and st.shape == (128, 32)
    assert np.shares_memory(st, engine.staging_tensor.numpy())
    view = st[:10, :F]
    assert engine._pad_x(view) is st


def test_convert_round_trips_a_reference_model():
    rng = np.random.default_rng(6)
    jcfg = jtm.TMConfig(M, C, F)
    acts = rng.random((M, C, 2 * F)) < 0.1
    w = rng.integers(1, 4, (M, C))
    jstate = jtm.state_from_actions(jcfg, acts)
    jm = jcomp.encode(jcfg, acts, w)
    cfg = tm.TMConfig(M, C, F)
    state = convert.state_from_numpy(cfg, np.asarray(jstate), device="cpu")
    assert state.dtype == torch.int32
    x = rng.integers(0, 2, (64, F), dtype=np.uint8)
    np.testing.assert_array_equal(
        tm.batch_class_sums(cfg, state, torch.from_numpy(x)).numpy(),
        np.asarray(jtm.batch_class_sums(jcfg, jstate, jnp.asarray(x))),
    )
    model = convert.model_from_numpy(
        jm.instructions, jm.n_classes, jm.n_clauses, jm.n_features,
        clause_weights=jm.clause_weights,
    )
    ours = compress.encode(cfg, tm.include_actions(cfg, state).numpy(), w)
    np.testing.assert_array_equal(model.instructions, ours.instructions)
    np.testing.assert_array_equal(model.clause_weights, ours.clause_weights)
    plan = CapacityPlan.for_models([model])
    assert TMProgram(plan, model).to_bytes() == TMProgram(plan, ours).to_bytes()
    with pytest.raises(ValueError):
        convert.state_from_numpy(cfg, np.zeros((M, C, F), np.int32), "cpu")
    with pytest.raises(TypeError):
        convert.model_from_numpy(jm.instructions.astype(np.int32), M, C, F)
