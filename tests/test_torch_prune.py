"""The port's clause pruning (``repro_torch.prune``) against the JAX
reference (``repro.prune``) on the CPU, on the same numpy inputs, exactly:
every rank function (the traffic sweep's pad rows included), every pass's
masks, weights and ``PruneReport``, the policy's stages, bit-exact serving
of the exact and merged models on the ``interp``, ``plan`` and
``popcount`` engines, the TMProgram v2 bytes that ``Compressor(prune=)``
and a ``RecalController(prune=)`` run publish, and the v1 golden fixture
on the new engines.  Mirrors ``tests/test_prune.py`` without its
``sharded`` engine.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import prune as jprune
from repro.accel import CapacityPlan as JCapacityPlan
from repro.core.tm import TMConfig as JTMConfig
from repro.core.tm import state_from_actions as jstate_from_actions
from repro.data.pipeline import TMDatasetSpec, booleanized_tm_dataset
from repro.recal import Compressor as JCompressor
from repro.recal import RecalController as JRecalController
from repro.recal import RecalWorker as JRecalWorker
from repro.serve_tm import TMServer as JTMServer
from repro_torch import prune
from repro_torch.accel import CapacityPlan, TMProgram, make_engine
from repro_torch.core import prng, tm
from repro_torch.core.compress import encode
from repro_torch.prune.rank import clause_fire_counts_plain
from repro_torch.recal import Compressor, RecalController, RecalWorker
from repro_torch.serve_tm import TMServer

ENGINE_NAMES = ("interp", "plan", "popcount")
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _cfgs(M, C, F):
    return tm.TMConfig(M, C, F), JTMConfig(M, C, F)


def _oracle(cfg, acts, X, weights=None):
    w = None if weights is None else torch.from_numpy(np.asarray(weights, np.int32))
    return tm.batch_class_sums_weighted(
        cfg, tm.state_from_actions(cfg, torch.from_numpy(acts)), torch.from_numpy(X), w
    ).numpy()


def _engine_sums(name, model, X):
    plan = CapacityPlan.for_models([model], batch_words=2)
    eng = make_engine(name, plan, device="cpu")
    return eng.class_sums(eng.program(model), X)


def _messy_actions(rng, cfg, density=0.2):
    """Random mask seeded with every dead-clause species: all-excluded
    rows, contradictory rows, duplicate groups (cancelling and not)."""
    M, C, L = cfg.n_classes, cfg.n_clauses, cfg.n_literals
    acts = rng.random((M, C, L)) < density
    acts[:, C - 1, :] = False  # all-excluded everywhere
    if C >= 4:
        acts[0, 1] = False  # contradictory clause
        acts[0, 1, 0] = acts[0, 1, 1] = True
        acts[1, 0] = False  # a cancelling duplicate pair
        acts[1, 1] = False
        acts[1, 0, 2] = acts[1, 1, 2] = True
        acts[2, 0] = False  # a same-parity pair that must NOT cancel
        acts[2, 2] = False
        acts[2, 0, 4] = acts[2, 2, 4] = True
    return acts


def _same_result(got, want):
    assert np.array_equal(got.actions, want.actions)
    if want.weights is None:
        assert got.weights is None
    else:
        assert got.weights.dtype == want.weights.dtype == np.uint16
        assert np.array_equal(got.weights, want.weights)
    assert dataclasses.asdict(got.report) == dataclasses.asdict(want.report)
    assert got.report.n_removed == want.report.n_removed


# -- ranking and dead-clause detection -----------------------------------------


@pytest.mark.parametrize("seed,B", [(0, 40), (1, 32), (2, 1), (3, 77)])
def test_rank_functions_match_reference(seed, B):
    rng = np.random.default_rng(seed)
    cfg, jcfg = _cfgs(3, 8, 7)
    acts = _messy_actions(rng, cfg)
    X = rng.integers(0, 2, (B, 7)).astype(np.uint8)
    w = rng.integers(1, 9, (3, 8))
    counts = prune.clause_fire_counts(cfg, acts, X, device="cpu")
    assert counts.dtype == np.int64
    assert np.array_equal(counts, jprune.clause_fire_counts(jcfg, acts, X))
    assert np.array_equal(counts, clause_fire_counts_plain(cfg, acts, X, device="cpu"))
    for weights in (None, w):
        got = prune.vote_contribution(cfg, acts, X, weights, device="cpu")
        assert got.dtype == np.int64
        assert np.array_equal(got, jprune.vote_contribution(jcfg, acts, X, weights))
        assert np.array_equal(prune.dead_clause_mask(cfg, acts, weights),
                              jprune.dead_clause_mask(jcfg, acts, weights))
    assert np.array_equal(prune.contradictory_clauses(cfg, acts),
                          jprune.contradictory_clauses(jcfg, acts))
    assert prune.duplicate_groups(cfg, acts) == jprune.duplicate_groups(jcfg, acts)


@pytest.mark.parametrize("B", [1, 31, 37, 64])
def test_fire_counts_leave_out_the_pad_rows(B):
    """A clause of negated literals only fires on the all-zero rows that
    pad the sweep to whole words: they are not traffic."""
    cfg, jcfg = _cfgs(2, 4, 5)
    acts = np.zeros((2, 4, 10), bool)
    acts[0, 0, 1::2] = True  # NOT x_f for every f: fires on all-zero rows
    acts[1, 2, [1, 3]] = True
    X = np.ones((B, 5), np.uint8)
    X[::3] = 0
    counts = prune.clause_fire_counts(cfg, acts, X, device="cpu")
    assert np.array_equal(counts, jprune.clause_fire_counts(jcfg, acts, X))
    assert counts[0, 0] == len(range(0, B, 3))


def test_rank_functions_refuse_bad_shapes_like_the_reference():
    cfg, jcfg = _cfgs(2, 4, 5)
    for ours, theirs in (
        (lambda: prune.dead_clause_mask(cfg, np.zeros((2, 4, 9), bool)),
         lambda: jprune.dead_clause_mask(jcfg, np.zeros((2, 4, 9), bool))),
        (lambda: prune.vote_contribution(cfg, np.zeros((2, 4, 10), bool),
                                         np.zeros((3, 5)), np.ones((2, 3)), device="cpu"),
         lambda: jprune.vote_contribution(jcfg, np.zeros((2, 4, 10), bool),
                                          np.zeros((3, 5)), np.ones((2, 3)))),
    ):
        with pytest.raises(ValueError) as a:
            ours()
        with pytest.raises(ValueError) as b:
            theirs()
        assert str(a.value) == str(b.value)


# -- the exact passes -------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_exact_passes_match_reference(seed):
    rng = np.random.default_rng(seed)
    M, C, F = int(rng.integers(2, 5)), int(rng.integers(4, 9)), int(rng.integers(4, 12))
    cfg, jcfg = _cfgs(M, C, F)
    acts = _messy_actions(rng, cfg)
    w = rng.integers(1, 4, (M, C))
    for weights in (None, w):
        r, jr = prune.prune_exact(cfg, acts, weights), jprune.prune_exact(jcfg, acts, weights)
        _same_result(r, jr)
        m, jm = (prune.merge_weighted(cfg, r.actions, r.weights),
                 jprune.merge_weighted(jcfg, jr.actions, jr.weights))
        _same_result(m, jm)


def test_merge_survivor_parity_and_cancelled_group():
    cfg, jcfg = _cfgs(1, 6, 3)
    acts = np.zeros((1, 6, 6), bool)
    for j in (0, 1, 2):  # slots 0(+), 2(+), 1(-) with weights 3, 2, 1 -> net +4
        acts[0, j, 0] = True
    acts[0, 3, 2] = acts[0, 4, 2] = True  # net 0: zeroed outright
    w = np.ones((1, 6), np.int64)
    w[0, 0], w[0, 2], w[0, 1] = 3, 2, 1
    r = prune.merge_weighted(cfg, acts, w)
    _same_result(r, jprune.merge_weighted(jcfg, acts, w))
    assert r.actions[0, 0].any() and r.weights[0, 0] == 4
    assert not r.actions[0, 1:5].any()
    X = np.array([[1, 0, 1], [0, 1, 1], [1, 1, 1]], np.uint8)
    assert np.array_equal(_oracle(cfg, r.actions, X, r.weights), _oracle(cfg, acts, X, w))


def test_merge_leaves_groups_past_the_weight_format():
    cfg, jcfg = _cfgs(1, 4, 2)
    acts = np.zeros((1, 4, 4), bool)
    acts[0, 0, 0] = acts[0, 2, 0] = True
    w = np.array([[60000, 1, 60000, 1]])
    r = prune.merge_weighted(cfg, acts, w)
    _same_result(r, jprune.merge_weighted(jcfg, acts, w))
    assert r.report.n_merged == 0


# -- the ranked pass and the policy ---------------------------------------------


def _separable_setup(seed=7, B=200):
    """A model + labelled holdout whose labels come from the model itself."""
    rng = np.random.default_rng(seed)
    cfg, jcfg = _cfgs(3, 10, 8)
    acts = rng.random((3, 10, 16)) < 0.12
    X = rng.integers(0, 2, (B, 8)).astype(np.uint8)
    y = np.argmax(_oracle(cfg, acts, X), axis=1).astype(np.int32)
    return cfg, jcfg, acts, X, y, rng


@pytest.mark.parametrize("seed,tolerance,weighted", [
    (7, 0.05, False), (8, 1.0, False), (9, 0.0, False), (10, 0.02, True), (11, 0.1, True),
])
def test_prune_ranked_matches_reference(seed, tolerance, weighted):
    cfg, jcfg, acts, X, y, rng = _separable_setup(seed, B=37 + seed)
    w = rng.integers(1, 5, (3, 10)).astype(np.uint16) if weighted else None
    r = prune.prune_ranked(cfg, acts, X, y, tolerance=tolerance, weights=w, device="cpu")
    _same_result(r, jprune.prune_ranked(jcfg, acts, X, y, tolerance=tolerance, weights=w))
    assert r.report.pruned_accuracy >= r.report.baseline_accuracy - tolerance - 1e-12
    if tolerance == 1.0:
        assert r.report.n_clauses_after == 0


def test_prune_ranked_refuses_a_negative_tolerance():
    cfg, jcfg, acts, X, y, _ = _separable_setup()
    with pytest.raises(ValueError) as a:
        prune.prune_ranked(cfg, acts, X, y, tolerance=-0.1, device="cpu")
    with pytest.raises(ValueError) as b:
        jprune.prune_ranked(jcfg, acts, X, y, tolerance=-0.1)
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("policy,labels,messy", [
    (dict(tolerance=0.05), True, False),
    (dict(tolerance=0.05), False, False),
    (dict(), True, True),
    (dict(tolerance=0.02), True, True),
    (dict(exact=False, tolerance=0.0), True, True),
    (dict(merge=False), False, True),
])
def test_policy_matches_reference(policy, labels, messy):
    cfg, jcfg, acts, X, y, rng = _separable_setup(9)
    if messy:
        acts = _messy_actions(rng, cfg, density=0.25)
    kw = dict(X=X, y=y) if labels else dict(X=X)
    r = prune.PrunePolicy(**policy).apply(cfg, acts, device="cpu", **kw)
    jr = jprune.PrunePolicy(**policy).apply(jcfg, acts, **kw)
    _same_result(r, jr)
    if policy.get("tolerance") is not None and not labels:
        assert r.report.stages[-1] == "ranked:skipped-no-labels"
        assert np.array_equal(_oracle(cfg, r.actions, X, r.weights), _oracle(cfg, acts, X))


def test_policy_skips_a_merge_that_grows_the_artifact():
    """One merged pair of many clauses: the weight vector costs more bytes
    than the instructions the merge saves."""
    rng = np.random.default_rng(3)
    cfg, jcfg = _cfgs(3, 8, 6)
    acts = _messy_actions(rng, cfg, density=0.3)
    r = prune.PrunePolicy().apply(cfg, acts)
    _same_result(r, jprune.PrunePolicy().apply(jcfg, acts))
    assert r.report.stages == ("exact", "merge:skipped-grows-bytes")


# -- bit-exact serving of the exact passes ---------------------------------------


@pytest.mark.parametrize("engine", ENGINE_NAMES)
@pytest.mark.parametrize("seed", range(2))
def test_exact_and_merged_models_serve_bit_exactly(engine, seed):
    rng = np.random.default_rng(100 + seed)
    cfg, _ = _cfgs(3, 8, 6)
    acts = _messy_actions(rng, cfg)
    X = rng.integers(0, 2, (37, cfg.n_features)).astype(np.uint8)
    r = prune.prune_exact(cfg, acts)
    assert r.report.n_dead >= 1
    assert np.array_equal(_engine_sums(engine, encode(cfg, r.actions, r.weights), X),
                          _oracle(cfg, acts, X))
    m = prune.merge_weighted(cfg, r.actions, r.weights)
    model = encode(cfg, m.actions, clause_weights=m.weights)
    assert model.weighted
    assert np.array_equal(_engine_sums(engine, model, X), _oracle(cfg, acts, X))


@pytest.mark.parametrize("engine", ENGINE_NAMES)
def test_v1_golden_fixture_serves_on_every_engine(engine):
    rng = np.random.default_rng(1234)
    cfg = tm.TMConfig(n_classes=4, n_clauses=6, n_features=16)
    acts = rng.random((4, 6, 32)) < 0.15
    with open(os.path.join(DATA_DIR, "tmprogram_v1_golden.bin"), "rb") as f:
        blob = f.read()
    art = TMProgram.from_bytes(blob)
    assert art.format_version == 1 and not art.model.weighted
    assert art.to_bytes() == blob
    X = np.random.default_rng(42).integers(0, 2, (32, cfg.n_features)).astype(np.uint8)
    assert np.array_equal(_engine_sums(engine, art.model, X), _oracle(cfg, acts, X))


# -- the Fig-8 loop with pruning -------------------------------------------------


def test_compressor_publishes_the_reference_pruned_bytes():
    rng = np.random.default_rng(15)
    cfg, jcfg = _cfgs(3, 8, 6)
    acts = _messy_actions(rng, cfg)
    state = tm.state_from_actions(cfg, torch.from_numpy(acts))
    jstate = jstate_from_actions(jcfg, jnp.asarray(acts))
    baseline = Compressor().compress(cfg, state)
    plan = dataclasses.replace(CapacityPlan.for_models([baseline.model]), weight_planes=4)
    jplan = JCapacityPlan(**plan.as_dict())
    X = rng.integers(0, 2, (30, 6)).astype(np.uint8)
    y = rng.integers(0, 3, 30).astype(np.int32)
    for kw in (dict(), dict(traffic_sample=X), dict(traffic_sample=X, labels=y)):
        policy = prune.PrunePolicy(tolerance=0.1)
        got = Compressor(plan=plan).compress(cfg, state, prune=policy, **kw)
        want = JCompressor(plan=jplan).compress(
            jcfg, jstate, prune=jprune.PrunePolicy(tolerance=0.1), **kw)
        assert dataclasses.asdict(got.prune) == dataclasses.asdict(want.prune)
        assert got.artifact.to_bytes() == want.artifact.to_bytes()
        assert (got.n_includes, got.compression_ratio, got.probe_rows, got.shrink) == (
            want.n_includes, want.compression_ratio, want.probe_rows, want.shrink)
    assert got.model.n_bytes < baseline.model.n_bytes
    assert any(k == "instruction_capacity" for k, _, _ in got.shrink)


def _prune_loop(pkg):
    spec = TMDatasetSpec("prune-test", 10, 3, 4, 20)
    xb, y, booler = booleanized_tm_dataset(spec, 600, seed=0, drift=0.0)
    M, C, F = spec.n_classes, spec.n_clauses, booler.n_boolean_features
    kw = dict(feature_capacity=64, instruction_capacity=8192)
    if pkg == "jax":
        worker = JRecalWorker(JTMConfig(M, C, F), key=jax.random.key(11),
                              train_engine="packed")
        server = JTMServer(JCapacityPlan(**kw), backend="plan")
        ctl_cls, policy = JRecalController, jprune.PrunePolicy(tolerance=0.02)
    else:
        worker = RecalWorker(tm.TMConfig(M, C, F), key=prng.key(11), device="cpu")
        server = TMServer(CapacityPlan(**kw), backend="plan", device="cpu")
        ctl_cls, policy = RecalController, prune.PrunePolicy(tolerance=0.02)
    worker.fine_tune_epochs(xb, y, epochs=3, batch=150)
    ctl = ctl_cls(server, "edge", worker, buffer_batches=4, train_batch_size=128,
                  min_buffer_rows=256, regression_margin=0.1, prune=policy)
    ctl.deploy()  # no labels: exact + merge only
    deployed = server.installed_artifact("edge").to_bytes()
    for i in range(0, 600, 200):
        ctl.observe(np.asarray(xb[i:i + 200]), np.asarray(y[i:i + 200]))
    event = ctl.recalibrate(reason="test")
    return ctl, event, deployed, xb


def test_controller_with_pruning_publishes_the_reference_bytes():
    jctl, jevent, jdeployed, xb = _prune_loop("jax")
    ctl, event, deployed, _ = _prune_loop("port")
    assert deployed == jdeployed
    fields = ("version", "reason", "steps_taken", "holdout_acc_before",
              "holdout_acc_after", "rolled_back", "compression_ratio", "reclaimable",
              "pruned_clauses", "prune_stages")
    assert [getattr(event, f) for f in fields] == [getattr(jevent, f) for f in fields]
    assert event.prune_stages[0] == "exact" and "ranked" in event.prune_stages[-1]
    assert not event.rolled_back
    assert ctl.server.installed_artifact("edge").to_bytes() == \
        jctl.server.installed_artifact("edge").to_bytes()
    assert np.array_equal(ctl.worker.snapshot(), jctl.worker.snapshot())
    assert np.array_equal(ctl.server.class_sums("edge", xb[:64]),
                          np.asarray(jctl.server.class_sums("edge", xb[:64])))
    assert ctl.server.compile_cache_size() == 1
