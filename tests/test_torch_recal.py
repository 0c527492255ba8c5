"""The port's Fig-8 loop (``repro_torch.recal``) against the JAX reference
(``repro.recal``) on the CPU, on the same numpy inputs, bit for bit: the
train-engine registry and its selection rules, engines that agree with
each other and with the reference, a (key, step, state) checkpoint moved
between a JAX worker and the port's in both directions, the drift
monitor's decisions, the compressor's stream and ``TMProgram`` bytes, and
a controller run (drift -> recalibrate -> hot-swap -> rollback) whose
published program bytes and trained TA state equal the JAX controller's
on the same traffic.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import CapacityPlan as JCapacityPlan
from repro.core import tm as jtm
from repro.core import train as jtrain
from repro.data.pipeline import TMDatasetSpec, booleanized_tm_dataset
from repro.prune import PrunePolicy as JPrunePolicy
from repro.recal import Compressor as JCompressor
from repro.recal import DriftMonitor as JDriftMonitor
from repro.recal import RecalController as JRecalController
from repro.recal import RecalWorker as JRecalWorker
from repro.serve_tm import TMServer as JTMServer
from repro_torch import convert
from repro_torch.accel import CapacityExceeded, CapacityPlan
from repro_torch.core import prng, tm
from repro_torch.prune import PrunePolicy
from repro_torch.recal import (
    TRAIN_ENGINES,
    Compressor,
    DriftMonitor,
    PackedTrainEngine,
    RecalController,
    RecalWorker,
    ReferenceTrainEngine,
    TrainEngine,
    TrainEngineBase,
    make_train_engine,
    register_train_engine,
    select_train_engine,
    train_engine_names,
)
from repro_torch.serve_tm import TMServer


def _batch(rng, B, F, M):
    return (rng.integers(0, 2, (B, F)).astype(np.uint8),
            rng.integers(0, M, B).astype(np.int32))


# -- registry and selection ---------------------------------------------------


def test_registry_lists_the_ported_engines():
    assert train_engine_names() == ["packed", "reference", "sharded"]
    assert TRAIN_ENGINES["packed"] is PackedTrainEngine
    assert TRAIN_ENGINES["reference"] is ReferenceTrainEngine
    for name in train_engine_names():
        eng = make_train_engine(name, tm.TMConfig(2, 4, 3), device="cpu")
        assert isinstance(eng, TrainEngine) and eng.name == name
        # the sharded engine's default mesh is (1, 1) on the device
        assert eng.needs_mesh == (name == "sharded") and eng.device.type == "cpu"


def test_selection_rules():
    cfg = tm.TMConfig(2, 4, 3)
    assert select_train_engine(cfg) == "packed"  # priority 2 beats 1
    assert select_train_engine() == "packed"
    wide = tm.TMConfig(2, 4, 3, n_states=200)  # outside the int8 range
    assert select_train_engine(wide) == "reference"
    with pytest.raises(ValueError, match="exceeds the packed int8"):
        make_train_engine("packed", wide, device="cpu")
    # a mesh selects the mesh engine (tests/test_torch_sharded_train.py)
    assert select_train_engine(cfg, mesh=object()) == "sharded"
    with pytest.raises(ValueError, match="unknown train engine"):
        make_train_engine("distributed", cfg, device="cpu")
    built = make_train_engine("reference", cfg, device="cpu", parallel=False)
    assert make_train_engine(built, cfg) is built and not built.parallel


def test_register_refuses_a_taken_name_and_takes_a_new_one():
    with pytest.raises(ValueError, match="already registered"):
        @register_train_engine("packed")
        class Other(TrainEngineBase):
            pass

    @register_train_engine("zz-test", priority=-1)
    class Probe(ReferenceTrainEngine):
        pass

    try:
        assert Probe.name == "zz-test" and Probe.priority == -1
        assert select_train_engine(tm.TMConfig(2, 4, 3)) == "packed"
    finally:
        del TRAIN_ENGINES["zz-test"]


def test_engines_agree_with_each_other_and_the_reference():
    """reference (summed-delta) == packed == the JAX engines over a
    multi-step run with a ragged tail batch and a step offset."""
    M, C, F = 3, 34, 10
    cfg = tm.TMConfig(M, C, F)
    rng = np.random.default_rng(31)
    batches = [_batch(rng, b, F, M) for b in (32, 32, 13)]
    finals = {}
    for name in train_engine_names():
        eng = make_train_engine(name, cfg, device="cpu")
        internal = eng.prepare(tm.init_state(cfg))
        for j, (x, y) in enumerate(batches):
            internal = eng.fit_step(internal, prng.key(29), x, y, step=5 + j)
        finals[name] = eng.canonical(internal).numpy()
    want = jtm.init_state(jtm.TMConfig(M, C, F), jax.random.key(4))
    for j, (x, y) in enumerate(batches):
        want = jtrain.fit_step(jtm.TMConfig(M, C, F), want, jax.random.key(29),
                               jnp.asarray(x), jnp.asarray(y), step=5 + j, parallel=True)
    for name, got in finals.items():
        assert np.array_equal(got, np.asarray(want)), name


# -- the worker ---------------------------------------------------------------

SPEC = TMDatasetSpec("recal-test", 12, 3, 4, 24)


def _worker_cfgs():
    F = SPEC.n_raw_features * SPEC.thermometer_bits
    return (jtm.TMConfig(SPEC.n_classes, SPEC.n_clauses, F),
            tm.TMConfig(SPEC.n_classes, SPEC.n_clauses, F))


@pytest.mark.parametrize("engine", ["packed", "reference"])
def test_worker_checkpoint_resumes_across_the_packages(engine):
    """2 epochs on a JAX worker, its (key, step, state) moved into the
    port for 2 more, moved back for a last one == the same 5 epochs on
    one JAX worker."""
    xb, y, _ = booleanized_tm_dataset(SPEC, 300, seed=0, drift=0.0)
    jcfg, cfg = _worker_cfgs()
    straight = JRecalWorker(jcfg, key=jax.random.key(11), train_engine="packed")
    straight.fine_tune_epochs(xb, y, epochs=5, batch=64)

    jw = JRecalWorker(jcfg, key=jax.random.key(11), train_engine="packed")
    jw.fine_tune_epochs(xb, y, epochs=2, batch=64)
    pw = RecalWorker(cfg, jw.snapshot(), device="cpu", train_engine=engine,
                     key=convert.key_from_numpy(np.asarray(jax.random.key_data(jw.key))))
    pw.step_count = jw.step_count
    assert pw.fine_tune_epochs(xb, y, epochs=2, batch=64) == 8
    back = JRecalWorker(jcfg, jnp.asarray(pw.snapshot()), train_engine="packed",
                        key=jax.random.wrap_key_data(prng.key_data(pw.key)))
    back.step_count = pw.step_count
    back.fine_tune_epochs(xb, y, epochs=1, batch=64)
    assert back.step_count == straight.step_count == 20
    assert np.array_equal(back.snapshot(), straight.snapshot())


def test_worker_defaults_snapshot_and_restore():
    jcfg, cfg = _worker_cfgs()
    w = RecalWorker(cfg, device="cpu")
    assert w.train_engine == "packed" and w.device.type == "cpu"
    assert np.array_equal(prng.key_data(w.key), np.array([0, 0], np.uint32))
    snap = w.snapshot()
    assert isinstance(snap, np.ndarray) and (snap == cfg.n_states).all()
    xb, y, _ = booleanized_tm_dataset(SPEC, 64, seed=2, drift=0.0)
    assert w.fine_tune(xb, y) == 0 and w.step_count == 1
    assert not np.array_equal(w.snapshot(), snap)
    w.restore(snap)
    assert np.array_equal(w.snapshot(), snap)
    with pytest.raises(CapacityExceeded):
        RecalWorker(cfg, device="cpu", plan=CapacityPlan(batch_words=1)).fine_tune(xb, y)
    # labels outside the classes train as the reference's do
    y_out = np.resize(np.array([3, -1, -4, 9], np.int32), 64)
    before = w.snapshot()
    assert w.fine_tune(xb, y_out) == 1
    want = jtrain.fit_step(jcfg, jnp.asarray(before), jax.random.key(0),
                           jnp.asarray(xb), jnp.asarray(y_out), step=1, parallel=True)
    assert np.array_equal(w.snapshot(), np.asarray(want))


# -- the monitor ---------------------------------------------------------------


def _sums(margin, n, M=4):
    s = np.zeros((n, M), np.int32)
    s[:, 0] = margin
    return s


def test_monitor_decisions_match_the_reference():
    rng = np.random.default_rng(0)
    mons = [cls(window=64, min_samples=32, min_labelled=8, margin_fraction=0.5)
            for cls in (DriftMonitor, JDriftMonitor)]
    feeds = [(_sums(10, 16), None), (_sums(10, 32), None), ("freeze", None),
             (_sums(1, 64), None), ("reset", None),
             (rng.integers(-5, 6, (40, 3)), rng.integers(0, 3, 40)),
             (_sums(4, 40, 1), np.zeros(40, np.int32))]
    for sums, labels in feeds:
        for mon in mons:
            if isinstance(sums, str):
                getattr(mon, "freeze_baseline" if sums == "freeze" else "reset")()
            else:
                mon.observe(sums, np.asarray(sums).argmax(1), labels)
        a, b = (dataclasses.astuple(mon.decision()) for mon in mons)
        assert a == b and mons[0].margin == mons[1].margin
    with pytest.raises(ValueError, match="does not match"):
        mons[0].observe(_sums(1, 3), np.zeros(2, np.int32))


# -- the compressor --------------------------------------------------------------


@pytest.mark.parametrize("with_plan", [False, True])
def test_compressor_bytes_match_the_reference(with_plan):
    jcfg, cfg = _worker_cfgs()
    rng = np.random.default_rng(4)
    state = rng.integers(1, 257, (jcfg.n_classes, jcfg.n_clauses, jcfg.n_literals))
    state = state.astype(np.int32)
    state[:, ::2] = np.minimum(state[:, ::2], 100)  # some empty-ish clauses
    traffic = rng.integers(0, 2, (20, jcfg.n_features)).astype(np.uint8)
    kw = dict(instruction_capacity=8192, feature_capacity=64, include_capacity=128)
    jc = JCompressor(plan=JCapacityPlan(**kw) if with_plan else None)
    pc = Compressor(plan=CapacityPlan(**kw) if with_plan else None)
    want = jc.compress(jcfg, jnp.asarray(state), traffic_sample=traffic)
    got = pc.compress(cfg, torch.from_numpy(state), traffic_sample=traffic)
    assert np.array_equal(got.model.instructions, want.model.instructions)
    assert (got.n_includes, got.compression_ratio, got.probe_rows, got.shrink) == (
        want.n_includes, want.compression_ratio, want.probe_rows, want.shrink)
    assert (got.artifact is None) == (want.artifact is None) == (not with_plan)
    if with_plan:
        assert got.artifact.to_bytes() == want.artifact.to_bytes()
    # the exact prune passes run before the encode, as in the reference
    got = pc.compress(cfg, torch.from_numpy(state), traffic_sample=traffic,
                      prune=PrunePolicy(merge=False))
    want = jc.compress(jcfg, jnp.asarray(state), traffic_sample=traffic,
                       prune=JPrunePolicy(merge=False))
    assert np.array_equal(got.model.instructions, want.model.instructions)
    assert dataclasses.asdict(got.prune) == dataclasses.asdict(want.prune)
    with pytest.raises(ValueError, match="traffic_sample"):
        pc.compress(cfg, torch.from_numpy(state), traffic_sample=traffic[:, :5])
    if with_plan:
        with pytest.raises(CapacityExceeded):
            Compressor(plan=CapacityPlan(instruction_capacity=32, feature_capacity=64)
                       ).compress(cfg, torch.from_numpy(state))


# -- the controller: the closed loop against the reference's --------------------


def _loop(pkg):
    """Train, deploy, serve clean traffic, then drift until a recal swap;
    returns the controller and the clean traffic."""
    jcfg, cfg = _worker_cfgs()
    xb, y, booler = booleanized_tm_dataset(SPEC, 600, seed=0, drift=0.0)
    kw = dict(feature_capacity=64, instruction_capacity=8192)
    if pkg == "jax":
        worker = JRecalWorker(jcfg, key=jax.random.key(11), train_engine="packed")
        server = JTMServer(JCapacityPlan(**kw), backend="plan")
        ctl_cls, mon_cls = JRecalController, JDriftMonitor
    else:
        worker = RecalWorker(cfg, key=prng.key(11), device="cpu")
        server = TMServer(CapacityPlan(**kw), device="cpu")
        ctl_cls, mon_cls = RecalController, DriftMonitor
    worker.fine_tune_epochs(xb, y, epochs=2, batch=150)
    ctl = ctl_cls(
        server, "edge", worker,
        monitor=mon_cls(window=256, min_samples=128, accuracy_threshold=0.9),
        buffer_batches=4, train_batch_size=128, min_buffer_rows=384,
        epochs_per_recal=3,
    )
    ctl.deploy()
    xt, yt, _ = booleanized_tm_dataset(SPEC, 256, seed=1, drift=0.0, booleanizer=booler)
    ctl.observe(xt, yt)
    ctl.freeze_baseline()
    for i in range(6):
        xd, yd, _ = booleanized_tm_dataset(
            SPEC, 128, seed=100 + i, drift=1.2, booleanizer=booler
        )
        ctl.serve(xd, yd)
    return ctl, xt


def test_controller_loop_publishes_the_reference_bytes():
    jctl, xt = _loop("jax")
    pctl, _ = _loop("port")
    fields = ("version", "reason", "steps_taken", "holdout_acc_before",
              "holdout_acc_after", "rolled_back", "compression_ratio", "reclaimable")
    assert pctl.events and len(pctl.events) == len(jctl.events)
    for pe, je in zip(pctl.events, jctl.events):
        assert [getattr(pe, f) for f in fields] == [getattr(je, f) for f in fields]
    assert np.array_equal(pctl.worker.snapshot(), jctl.worker.snapshot())
    assert pctl.server.installed_artifact("edge").to_bytes() == \
        jctl.server.installed_artifact("edge").to_bytes()
    assert pctl.server.registry.get("edge").provenance.startswith("recal:")
    assert np.array_equal(pctl.server.class_sums("edge", xt[:128]),
                          np.asarray(jctl.server.class_sums("edge", xt[:128])))
    # a forced rollback restores the version before the swap in both
    for ctl in (pctl, jctl):
        ctl.server.rollback("edge")
    assert pctl.server.registry.get("edge").version == jctl.server.registry.get("edge").version
    assert pctl.server.installed_artifact("edge").to_bytes() == \
        jctl.server.installed_artifact("edge").to_bytes()
    assert np.array_equal(pctl.server.infer("edge", xt),
                          np.asarray(jctl.server.infer("edge", xt)))
    m = pctl.server.metrics.summary()
    assert (m["recals"], m["rollbacks"]) == (len(pctl.events), 1)
    assert pctl.server.compile_cache_size() == 1


def test_controller_rolls_back_a_bad_recalibration():
    _, cfg = _worker_cfgs()

    class SabotagedWorker(RecalWorker):
        def fine_tune_epochs(self, x, y, *, epochs, batch):
            self.state = tm.init_state(cfg)  # unlearns everything
            return 1

    xb, y, booler = booleanized_tm_dataset(SPEC, 600, seed=0, drift=0.0)
    good = RecalWorker(cfg, key=prng.key(11), device="cpu")
    good.fine_tune_epochs(xb, y, epochs=2, batch=150)
    bad = SabotagedWorker(cfg, good.snapshot(), key=prng.key(11), device="cpu")
    server = TMServer(CapacityPlan(feature_capacity=64, instruction_capacity=8192),
                      device="cpu")
    ctl = RecalController(server, "edge", bad, buffer_batches=4, train_batch_size=128)
    with pytest.raises(RuntimeError, match="no labelled traffic"):
        ctl.recalibrate()
    ctl.deploy()
    xt, yt, _ = booleanized_tm_dataset(SPEC, 256, seed=1, drift=0.0, booleanizer=booler)
    expected = ctl.observe(xt, yt)
    event = ctl.recalibrate(reason="test")
    assert event.rolled_back and server.metrics.rollbacks == 1
    assert np.array_equal(server.infer("edge", xt), expected)
    assert np.array_equal(bad.snapshot(), good.snapshot())
    assert server.compile_cache_size() == 1
    assert RecalController(server, "edge", bad, prune=PrunePolicy()).prune == PrunePolicy()
