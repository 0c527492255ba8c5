"""The class-sharded TM train step and its engine on the CPU against the
JAX reference (tolerance 0): ``dist.make_tm_train_step`` on meshes of
1, 2, 3 and 4 tiles over chained steps, equal to the reference's
``train_batch_parallel``; the per-slice delta equal to the sum of the
reference's ``sample_class_delta``; the ``model``-axis ``ValueError``;
the ``sharded`` train engine (batch pin, ragged fallback, selection,
mesh forwarding); ``RecalWorker(mesh=)`` and its legacy spelling; and
``Compressor(validate_knobs=)`` publishing the reference's bytes.

The reference's own sharded step does not run on this jax
(``shard_map(check_rep=)``), so the port is held to the reference
functions that do: ``train_batch_parallel``, ``fit_step`` and
``sample_class_delta`` (its docstring: the sharded step equals
``train_batch_parallel`` bit for bit on any mesh).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import CapacityPlan as JCapacityPlan
from repro.core import tm as jtm
from repro.core import train as jtrain
from repro.dist import steps as jsteps
from repro.recal import Compressor as JCompressor
from repro_torch.accel import CapacityExceeded, CapacityPlan
from repro_torch.core import prng, tm, train
from repro_torch.dist import make_mesh, make_tm_train_step
from repro_torch.recal import (
    Compressor,
    RecalWorker,
    ShardedTrainEngine,
    TRAIN_ENGINES,
    make_train_engine,
    select_train_engine,
)

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (1, 4)]


def _cpu_mesh(shape):
    return make_mesh(shape, devices="cpu")


def _batch(rng, B, F, M):
    return (rng.integers(0, 2, (B, F)).astype(np.uint8),
            rng.integers(0, M, B).astype(np.int32))


def _state(rng, M, C, F):
    s = rng.integers(1, 257, (M, C, 2 * F)).astype(np.int32)
    s[:, 0], s[:, 1] = 1, 256  # rows at both walls
    return s


@pytest.mark.parametrize("shape", MESHES)
def test_step_matches_train_batch_parallel_over_chained_steps(shape):
    """(3, 1) leaves a batch of 32 replicated (3 does not divide it);
    (1, 4) splits 4 classes one per tile."""
    M, C, F, B = 4, 8, 6, 32
    jcfg, cfg = jtm.TMConfig(M, C, F), tm.TMConfig(M, C, F)
    rng = np.random.default_rng(2)
    state = _state(rng, M, C, F)
    step = make_tm_train_step(cfg, _cpu_mesh(shape), batch=B)
    want, got = jnp.asarray(state), torch.from_numpy(state)
    for j in range(3):
        xb, yb = _batch(rng, B, F, M)
        want = jtrain.train_batch_parallel(
            jcfg, want, jax.random.fold_in(jax.random.key(5), j),
            jnp.asarray(xb), jnp.asarray(yb))
        got = step(got, prng.fold_in(prng.key(5), j), xb, yb)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want)), (shape, j)
    # slices kept on their devices between steps give the same state
    slices = step.split(state)
    assert len(slices) == step.n_model
    rng = np.random.default_rng(2)
    _state(rng, M, C, F)
    for j in range(3):
        xb, yb = _batch(rng, B, F, M)
        slices = step.step_slices(slices, prng.fold_in(prng.key(5), j), xb, yb)
    assert np.array_equal(step.join(slices, "cpu").numpy(), np.asarray(want))


@pytest.mark.parametrize("m0,Mc", [(0, 4), (0, 2), (2, 2), (1, 1), (3, 1)])
def test_slice_delta_is_the_sum_of_the_reference_sample_deltas(m0, Mc):
    M, C, F, B = 4, 6, 5, 9
    jcfg, cfg = jtm.TMConfig(M, C, F), tm.TMConfig(M, C, F)
    rng = np.random.default_rng(m0 * 10 + Mc)
    state = _state(rng, M, C, F)
    xb, yb = _batch(rng, B, F, M)
    keys = train.sample_keys(prng.key(7), B, offset=3)
    jkeys = jtrain.sample_keys(jax.random.key(7), B, offset=3)
    sl = slice(m0, m0 + Mc)
    got = train.class_slice_delta(cfg, torch.from_numpy(state[sl]), m0, keys,
                                  torch.from_numpy(xb), torch.from_numpy(yb))
    m_ids = jnp.arange(m0, m0 + Mc, dtype=jnp.int32)
    want = sum(
        np.asarray(jtrain.sample_class_delta(
            jcfg, jnp.asarray(state[sl]), m_ids, jkeys[i], jnp.asarray(xb[i]),
            jnp.int32(yb[i])))
        for i in range(B)
    )
    assert np.array_equal(got.numpy(), want)
    ours = sum(
        train.sample_class_delta(cfg, torch.from_numpy(state[sl]),
                                 torch.arange(m0, m0 + Mc), keys[i],
                                 torch.from_numpy(xb[i]), int(yb[i]))
        for i in range(B)
    )
    assert torch.equal(got, ours)


def test_model_axis_that_does_not_divide_the_classes_raises():
    cfg = tm.TMConfig(3, 4, 5)
    mesh = _cpu_mesh((1, 2))
    with pytest.raises(ValueError, match="must divide n_classes=3") as ours:
        make_tm_train_step(cfg, mesh, batch=32)
    # the reference raises the same before it reaches shard_map
    with pytest.raises(ValueError) as theirs:
        jsteps.make_tm_train_step(jtm.TMConfig(3, 4, 5), mesh, batch=32)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="must divide"):
        make_train_engine("sharded", cfg, mesh=mesh)
    with pytest.raises(ValueError, match="built for batch 32"):
        make_tm_train_step(tm.TMConfig(2, 4, 5), mesh, batch=32)(
            np.ones((2, 4, 10), np.int32), prng.key(0),
            np.zeros((16, 5), np.uint8), np.zeros(16, np.int32))


# -- the engine ----------------------------------------------------------------


def _reference_chain(M, C, F, state, batches, key, step0=0):
    jcfg = jtm.TMConfig(M, C, F)
    want = jnp.asarray(state)
    for j, (x, y) in enumerate(batches):
        want = jtrain.fit_step(jcfg, want, jax.random.key(key), jnp.asarray(x),
                               jnp.asarray(y), step=step0 + j, parallel=True)
    return np.asarray(want)


@pytest.mark.parametrize("pin", [0, 32])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_engine_pins_its_batch_and_falls_back_on_ragged_batches(pin, shape):
    M, C, F = 4, 10, 7
    cfg = tm.TMConfig(M, C, F)
    rng = np.random.default_rng(31)
    state = _state(rng, M, C, F)
    batches = [_batch(rng, b, F, M) for b in (32, 13, 32, 64)]
    eng = make_train_engine("sharded", cfg, mesh=_cpu_mesh(shape), batch=pin)
    assert isinstance(eng, ShardedTrainEngine) and eng.device.type == "cpu"
    assert eng._batch == pin  # 0: the first batch binds the step
    internal = eng.prepare(state)
    assert isinstance(internal, tuple) and len(internal) == shape[1]
    for j, (x, y) in enumerate(batches):
        internal = eng.fit_step(internal, prng.key(29), x, y, step=5 + j)
        assert eng._batch == 32  # the first batch binds an unpinned step
    want = _reference_chain(M, C, F, state, batches, 29, step0=5)
    assert np.array_equal(eng.canonical(internal).numpy(), want)


def test_engine_flags_selection_and_mesh_forwarding():
    cfg = tm.TMConfig(2, 4, 3)
    mesh = _cpu_mesh((1, 2))
    assert TRAIN_ENGINES["sharded"] is ShardedTrainEngine
    assert ShardedTrainEngine.needs_mesh and ShardedTrainEngine.priority == 1
    assert not TRAIN_ENGINES["packed"].needs_mesh
    assert select_train_engine(cfg, mesh=mesh) == "sharded"
    assert select_train_engine(cfg) == "packed"
    assert make_train_engine("reference", cfg, mesh=mesh, device="cpu").name == "reference"
    eng = make_train_engine("sharded", cfg, mesh=mesh)
    assert eng.mesh is mesh and eng.device == torch.device("cpu")
    assert make_train_engine("sharded", cfg, device="cpu").mesh.shape == {"data": 1, "model": 1}


def test_engine_without_a_mesh_or_device_sits_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_engine("sharded", tm.TMConfig(2, 4, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RecalWorker(tm.TMConfig(2, 4, 3), mesh=make_mesh((1, 1)))


# -- the worker and the compressor --------------------------------------------


def test_worker_with_a_mesh_trains_like_the_reference_worker():
    M, C, F = 4, 6, 5
    cfg = tm.TMConfig(M, C, F)
    mesh = _cpu_mesh((2, 2))
    w = RecalWorker(cfg, key=prng.key(0), mesh=mesh)
    assert w.train_engine == "sharded" and w.device.type == "cpu"
    wr = RecalWorker(cfg, key=prng.key(0), train_engine="reference", device="cpu")
    rng = np.random.default_rng(0)
    x, y = _batch(rng, 64, F, M)
    assert w.fine_tune_epochs(x, y, epochs=2, batch=16) == 8
    wr.fine_tune_epochs(x, y, epochs=2, batch=16)
    assert np.array_equal(w.snapshot(), wr.snapshot())
    pinned = RecalWorker(cfg, key=prng.key(0), mesh=mesh,
                         engine_options={"batch": 16})
    assert pinned.engine._batch == 16
    snap = w.snapshot()
    w.fine_tune(x[:16], y[:16])
    w.restore(snap)
    assert np.array_equal(w.snapshot(), snap)


def test_worker_legacy_sharded_spelling_warns_once_per_process():
    probe = textwrap.dedent("""
        import warnings
        import numpy as np
        from repro_torch.core import prng
        from repro_torch.core.tm import TMConfig
        from repro_torch.dist import make_mesh
        from repro_torch.recal import RecalWorker

        cfg = TMConfig(n_classes=2, n_clauses=6, n_features=4)
        mesh = make_mesh((1, 1), devices="cpu")
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            w1 = RecalWorker(cfg, key=prng.key(0), mesh=mesh, sharded_batch=16)
            w2 = RecalWorker(cfg, key=prng.key(0), mesh=mesh, sharded_batch=16)
        dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
        assert len(dep) == 1, [str(w.message) for w in rec]
        assert "train_engine='sharded'" in str(dep[0].message)
        assert w1.train_engine == "sharded" and w1.engine._batch == 16
        wr = RecalWorker(cfg, key=prng.key(0), train_engine="reference",
                         device="cpu")
        rng = np.random.default_rng(0)
        x = rng.integers(0, 2, (16, 4)).astype(np.uint8)
        y = rng.integers(0, 2, 16).astype(np.int32)
        w1.fine_tune(x, y)
        wr.fine_tune(x, y)
        assert np.array_equal(w1.snapshot(), wr.snapshot())
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            RecalWorker(cfg, key=prng.key(0), mesh=mesh)
        assert not [w for w in rec if issubclass(w.category, DeprecationWarning)]
        print("LEGACY_OK")
    """)
    out = subprocess.run(
        [sys.executable, "-c", probe], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(SRC)},
    )
    assert out.returncode == 0, out.stderr
    assert "LEGACY_OK" in out.stdout


@pytest.mark.parametrize("knobs", [None, ("feature_capacity", "class_capacity",
                                          "clause_capacity", "include_capacity")])
def test_compressor_validate_knobs_publishes_the_reference_bytes(knobs):
    """A plan whose instruction memory is too small for the model: the
    full check refuses it in both packages, the sharded engine's knobs
    (no instruction memory) publish the same bytes."""
    M, C, F = 3, 8, 12
    jcfg, cfg = jtm.TMConfig(M, C, F), tm.TMConfig(M, C, F)
    rng = np.random.default_rng(4)
    state = rng.integers(1, 257, (M, C, 2 * F)).astype(np.int32)
    kw = dict(instruction_capacity=32, feature_capacity=16, class_capacity=4,
              clause_capacity=8, include_capacity=24)
    pc = Compressor(plan=CapacityPlan(**kw), validate_knobs=knobs)
    jc = JCompressor(plan=JCapacityPlan(**kw), validate_knobs=knobs)
    if knobs is None:
        with pytest.raises(CapacityExceeded, match="instruction_capacity"):
            pc.compress(cfg, torch.from_numpy(state))
        with pytest.raises(ValueError, match="instruction_capacity"):
            jc.compress(jcfg, jnp.asarray(state))
        return
    got = pc.compress(cfg, torch.from_numpy(state))
    want = jc.compress(jcfg, jnp.asarray(state))
    assert got.model.n_instructions > 32
    assert got.artifact.to_bytes() == want.artifact.to_bytes()
    assert got.shrink == want.shrink
