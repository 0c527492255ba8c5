"""repro_torch.fleet on the CPU: the cases of tests/test_fleet.py on the
port's nodes (``TMServer`` on the ``interp``, ``plan``, ``popcount`` and
``sharded`` engines and the ``Accelerator`` façade, all on the CPU), every
served prediction and class sum held to the reference's
``batch_class_sums`` with tolerance 0 — pool membership behind the
ServingNode boundary, routed replica traffic (least-depth, failover,
replication), and canary → wave → fleet rollouts with gated fleet-wide
rollback."""

import asyncio

import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import TMConfig as JTMConfig
from repro.core import batch_class_sums, state_from_actions
from repro_torch.accel import Accelerator, CapacityPlan, TMProgram
from repro_torch.core import TMConfig
from repro_torch.core.compress import encode
from repro_torch.dist import make_mesh
from repro_torch.fleet import (
    FleetPool,
    NoEligibleNode,
    RolloutAborted,
    RolloutManager,
    Router,
    plan_stages,
)
from repro_torch.serve_tm import CapacityExceeded, ServingNode, TMServer
from repro_torch.serve_tm.scheduler import Overloaded

CAP = CapacityPlan(
    instruction_capacity=1024, feature_capacity=128, class_capacity=16,
    clause_capacity=32, include_capacity=24, batch_words=2,
)
SMALL = CapacityPlan(
    instruction_capacity=64, feature_capacity=32, class_capacity=4,
    clause_capacity=8, include_capacity=8, batch_words=1,
)

# the reference's four engines in its order, then the façade; the sharded
# node runs a (1, 2) CPU mesh.  Pools that cycle them all have 5 nodes
ENGINES = ("interp", "plan", "popcount", "sharded", "accelerator")


def _node(engine=None, cap=CAP):
    if engine == "accelerator":
        return Accelerator(cap, device="cpu")
    if engine == "sharded":
        return TMServer(cap, engine="sharded", mesh=make_mesh((1, 2), devices="cpu"))
    return TMServer(cap, engine=engine, device="cpu")


def _random_model(rng, M, C, F, density=0.05):
    cfg = TMConfig(n_classes=M, n_clauses=C, n_features=F)
    acts = rng.random((M, C, 2 * F)) < density
    return cfg, acts, encode(cfg, acts)


def _oracle_sums(cfg, acts, X):
    """The reference's dense class sums (JAX)."""
    jcfg = JTMConfig(cfg.n_classes, cfg.n_clauses, cfg.n_features)
    return np.asarray(
        batch_class_sums(jcfg, state_from_actions(jcfg, jnp.asarray(acts)),
                         jnp.asarray(X))
    )


def _program(model, cap=CAP):
    return TMProgram(capacity=cap, model=model)


def _pool(n, slot=None, artifact=None, engines=ENGINES):
    """A pool of n nodes over heterogeneous engines."""
    pool = FleetPool()
    for i in range(n):
        node = _node(engines[i % len(engines)])
        if slot is not None:
            node.register(slot, artifact)
        pool.add(f"n{i}", node)
    return pool


# -- membership / protocol ---------------------------------------------------


def test_pool_membership_and_protocol_conformance():
    pool = FleetPool()
    server = _node()
    accel = _node("accelerator")
    # both node flavors satisfy the structural boundary
    assert isinstance(server, ServingNode)
    assert isinstance(accel, ServingNode)
    pool.add("a", server)
    pool.add("b", accel)
    assert pool.names() == ["a", "b"]  # join order
    assert "a" in pool and len(pool) == 2
    with pytest.raises(ValueError, match="already in the pool"):
        pool.add("a", _node())
    with pytest.raises(TypeError, match="ServingNode"):
        pool.add("c", object())
    assert pool.remove("a") is server
    assert pool.names() == ["b"]
    with pytest.raises(KeyError):
        pool.node("a")


def test_pool_install_validates_every_target_before_any_register():
    """A heterogeneous fleet must never end up half-programmed: if ONE
    node can't fit the artifact, NO node gets it."""
    rng = np.random.default_rng(0)
    _, _, model = _random_model(rng, 5, 12, 40)
    pool = FleetPool({"big": _node(), "small": _node(cap=SMALL)})
    with pytest.raises(CapacityExceeded, match="small"):
        pool.install("m", _program(model))
    assert pool.nodes_with_slot("m") == []
    # restricting to fitting nodes works
    pool.install("m", _program(model), nodes=["big"])
    assert [n for n, _ in pool.nodes_with_slot("m")] == ["big"]


# -- routing -----------------------------------------------------------------


def test_router_least_depth_routing_and_bit_exactness():
    """Requests spread by pending rows across heterogeneous engines and
    every prediction matches the dense oracle."""
    rng = np.random.default_rng(1)
    cfg, acts, model = _random_model(rng, 5, 12, 40)
    art = _program(model)
    pool = _pool(5, slot="m", artifact=art)
    router = Router(pool)
    with pytest.raises(NoEligibleNode, match="no node hosts"):
        router.route("ghost")
    handles = []
    for _ in range(10):  # loops not running -> queues accumulate
        x = rng.integers(0, 2, (10, 40)).astype(np.uint8)
        handles.append((router.submit("m", x), x))
    # least-depth + join-order tie-break round-robins a uniform load
    assert [h.routed_to for h, _ in handles] == ["n0", "n1", "n2", "n3", "n4"] * 2
    for _, node in pool.items():
        node.flush()
    for h, x in handles:
        want = _oracle_sums(cfg, acts, x)
        assert (h.result() == want.argmax(1)).all()
        assert np.array_equal(np.asarray(h.class_sums), want)


class _AlwaysOverloaded(TMServer):
    async def async_submit(self, slot, x, **kw):
        raise Overloaded(slot, kw.get("priority", "normal"), 99, 1)


def test_router_async_failover_on_overloaded():
    """A node's Overloaded moves the request to the next candidate; it
    propagates only when every candidate rejects."""
    rng = np.random.default_rng(2)
    cfg, acts, model = _random_model(rng, 4, 10, 32)
    art = _program(model)
    full = _AlwaysOverloaded(CAP, engine="interp", device="cpu")
    full.register("m", art)
    ok = _node("plan")
    ok.register("m", art)
    pool = FleetPool({"full": full, "ok": ok})
    router = Router(pool)
    x = rng.integers(0, 2, (8, 32)).astype(np.uint8)

    async def run():
        h = await router.async_submit("m", x)
        return h

    h = asyncio.run(run())
    assert h.routed_to == "ok"
    ok.flush()
    assert (h.result() == _oracle_sums(cfg, acts, x).argmax(1)).all()

    full2 = _AlwaysOverloaded(CAP, engine="interp", device="cpu")
    full2.register("m", art)
    all_full = FleetPool({"a": full2})

    async def run_full():
        await Router(all_full).async_submit("m", x)

    with pytest.raises(Overloaded):
        asyncio.run(run_full())


def test_router_replicate_reships_artifact_capacity_fit():
    rng = np.random.default_rng(3)
    _, _, model = _random_model(rng, 5, 12, 40)
    art = _program(model)
    pool = FleetPool({
        "src": _node("interp"),
        "fit": _node("popcount"),
        "tiny": _node(cap=SMALL),
        "façade": _node("accelerator"),
    })
    pool.install("m", art, nodes=["src"])
    router = Router(pool)
    # asks for 3 replicas; only two nodes fit -> capacity-fit filtering
    assert router.replicate("m", n=3) == ["fit", "façade"]
    for name in ("fit", "façade"):
        node = pool.node(name)
        assert node.installed_checksum("m") == art.checksum
        assert node.registry.get("m").provenance == "replicate:src"
    assert "m" not in pool.node("tiny").slots()
    # a slot programmed from a bare model has no wire artifact to re-ship
    bare = _node()
    bare.register("bare", model)
    p2 = FleetPool({"a": bare, "b": _node()})
    with pytest.raises(ValueError, match="bare model"):
        Router(p2).replicate("bare")


# -- rollouts ----------------------------------------------------------------


def test_plan_stages_shapes():
    assert plan_stages(["a"]) == [("canary", ["a"])]
    assert plan_stages(["a", "b"]) == [("canary", ["a"]), ("wave", ["b"])]
    assert plan_stages(["a", "b", "c", "d"]) == [
        ("canary", ["a"]), ("wave", ["b", "c"]), ("fleet", ["d"]),
    ]
    assert plan_stages(list("abcde")) == [
        ("canary", ["a"]), ("wave", ["b", "c"]), ("fleet", ["d", "e"]),
    ]


def test_rollout_success_canary_wave_fleet():
    """A good artifact ships in three gated stages; every node ends on
    the shipped checksum with rollout provenance, bit-exact across
    heterogeneous engines."""
    rng = np.random.default_rng(4)
    cfg1, acts1, m1 = _random_model(rng, 5, 12, 40)
    cfg2, acts2, m2 = _random_model(rng, 5, 12, 40)
    v1, v2 = _program(m1), _program(m2)
    pool = _pool(5, slot="m", artifact=v1)
    X = rng.integers(0, 2, (64, 40)).astype(np.uint8)
    y2 = _oracle_sums(cfg2, acts2, X).argmax(1)  # the NEW program's truth
    report = RolloutManager(pool).rollout(
        "m", v2, holdout_x=X, holdout_y=y2,
    )
    assert report.completed and report.failed_stage is None
    assert [s.stage for s in report.stages] == ["canary", "wave", "fleet"]
    assert [len(s.nodes) for s in report.stages] == [1, 2, 2]
    assert all(s.passed and s.bit_exact and s.checksum_ok
               for s in report.stages)
    # the new program aces its own holdout on every node
    assert all(s.accuracy == 1.0 for s in report.stages)
    for name, node in pool.items():
        assert node.installed_checksum("m") == v2.checksum
        assert "rollout:" in node.registry.get("m").provenance
        assert f"{v2.checksum:08x}" in report.provenance[name]
        assert np.array_equal(node.class_sums("m", X), _oracle_sums(cfg2, acts2, X))


def test_rollout_canary_accuracy_failure_rolls_back():
    """A bad artifact dies at the canary: the fleet never sees it, the
    canary is rolled back with nested provenance, and the structured
    RolloutAborted carries the full report."""
    rng = np.random.default_rng(5)
    cfg1, acts1, m1 = _random_model(rng, 5, 12, 40)
    _, _, bad = _random_model(rng, 5, 12, 40)
    v1, v2 = _program(m1), _program(bad)
    pool = _pool(5, slot="m", artifact=v1)
    X = rng.integers(0, 2, (64, 40)).astype(np.uint8)
    y1 = _oracle_sums(cfg1, acts1, X).argmax(1)  # CURRENT program's truth
    with pytest.raises(RolloutAborted) as ei:
        RolloutManager(pool).rollout("m", v2, holdout_x=X, holdout_y=y1)
    err = ei.value
    assert err.stage == "canary" and "accuracy" in err.reason
    assert err.report.baseline_accuracy == 1.0
    assert err.report.rolled_back == ("n0",)
    for name, node in pool.items():
        # every node serves the OLD program again (or still)
        assert node.installed_checksum("m") == v1.checksum
        prov = node.registry.get("m").provenance
        if name == "n0":
            # the retreat heads the chain; the attempt is in history
            assert prov.startswith("rollback:")
            assert any("rollout:canary" in h.provenance
                       for h in node.registry.history("m"))
        else:
            assert "rollout" not in prov


class _LyingChecksum(TMServer):
    """A node that programs the artifact but reports the wrong installed
    checksum — the integrity gate's target."""

    def installed_checksum(self, slot):
        return 0xDEADBEEF


def test_rollout_midwave_integrity_failure_rolls_back_everything():
    """A wave-stage gate failure retreats the WHOLE rollout: nodes
    installed in earlier passing stages roll back too."""
    rng = np.random.default_rng(6)
    _, _, m1 = _random_model(rng, 5, 12, 40)
    _, _, m2 = _random_model(rng, 5, 12, 40)
    v1, v2 = _program(m1), _program(m2)
    good = _node("interp")
    liar = _LyingChecksum(CAP, engine="plan", device="cpu")
    for node in (good, liar):
        node.register("m", v1)
    pool = FleetPool({"good": good, "liar": liar})
    X = rng.integers(0, 2, (32, 40)).astype(np.uint8)
    with pytest.raises(RolloutAborted) as ei:
        RolloutManager(pool).rollout("m", v2, holdout_x=X)
    assert ei.value.stage == "wave" and "checksum" in ei.value.reason
    assert ei.value.report.rolled_back == ("good", "liar")
    for node in (good, liar):
        # back on v1's artifact (version advances monotonically)
        assert node.registry.get("m").artifact.checksum == v1.checksum
        assert node.registry.get("m").provenance.startswith("rollback:")


def test_rollout_refuses_misfitting_fleet_up_front():
    rng = np.random.default_rng(7)
    _, _, m1 = _random_model(rng, 5, 12, 40)
    v1 = _program(m1)
    big = _node()
    big.register("m", v1)
    pool = FleetPool({"big": big, "tiny": _node(cap=SMALL)})
    X = rng.integers(0, 2, (8, 40)).astype(np.uint8)
    with pytest.raises(CapacityExceeded, match="tiny"):
        # explicit targets include the misfit -> refused before any install
        RolloutManager(pool).rollout(
            "m", v1, holdout_x=X, nodes=["big", "tiny"]
        )
    assert big.installed_checksum("m") == v1.checksum
    with pytest.raises(TypeError, match="TMProgram"):
        RolloutManager(pool).rollout("m", m1, holdout_x=X)


def test_rollout_under_live_traffic_drops_nothing():
    """A mid-traffic rollout: requests keep flowing through the router
    while the fleet reprograms; every reply matches the old OR the new
    program's oracle and nothing is dropped."""
    rng = np.random.default_rng(8)
    cfg1, acts1, m1 = _random_model(rng, 5, 12, 40)
    cfg2, acts2, m2 = _random_model(rng, 5, 12, 40)
    v1, v2 = _program(m1), _program(m2)
    pool = _pool(2, slot="m", artifact=v1)
    router = Router(pool)
    pool.start_all()
    try:
        handles = []
        X = rng.integers(0, 2, (40, 6, 40)).astype(np.uint8)
        for i in range(10):
            handles.append((router.submit("m", X[i]), X[i]))
        report = RolloutManager(pool, gate_timeout_s=60.0).rollout(
            "m", v2, holdout_x=X[0])
        assert report.completed
        for i in range(10, 20):
            handles.append((router.submit("m", X[i]), X[i]))
        ok1 = ok2 = 0
        for h, x in handles:
            preds = h.wait(timeout=60.0)
            e1 = _oracle_sums(cfg1, acts1, x).argmax(1)
            e2 = _oracle_sums(cfg2, acts2, x).argmax(1)
            if (preds == e1).all():
                ok1 += 1
            elif (preds == e2).all():
                ok2 += 1
            else:  # pragma: no cover - the assertion message we want
                raise AssertionError("reply matches neither program")
        assert ok1 + ok2 == 20 and ok2 >= 10  # post-rollout -> new program
    finally:
        pool.stop_all()


# -- fleet metrics rollup ----------------------------------------------------


def test_pool_metrics_aggregate_sums_nodes():
    rng = np.random.default_rng(9)
    cfg, acts, model = _random_model(rng, 4, 10, 32)
    art = _program(model)
    pool = _pool(2, slot="m", artifact=art, engines=("interp", "plan"))
    router = Router(pool)
    for _ in range(4):
        router.submit("m", rng.integers(0, 2, (5, 32)).astype(np.uint8))
    for _, node in pool.items():
        node.flush()
    summary = pool.metrics_summary()
    agg, nodes = summary["aggregate"], summary["nodes"]
    assert agg["nodes"] == 2 and set(nodes) == {"n0", "n1"}
    assert agg["rows"] == sum(s["rows"] for s in nodes.values()) == 20
    assert agg["requests_completed"] == 4
    assert agg["throughput_dps"] == pytest.approx(
        sum(s["throughput_dps"] for s in nodes.values())
    )


# -- stable exception exports -------------------------------------------------


def test_structured_exceptions_exported_from_both_packages():
    """Overloaded / DeadlineExceeded / CapacityExceeded (and the
    ServingNode boundary) are the SAME objects importable from
    repro_torch.accel and repro_torch.serve_tm."""
    import repro_torch.accel as accel
    import repro_torch.serve_tm as serve

    for name in ("Overloaded", "DeadlineExceeded", "CapacityExceeded",
                 "ServingNode"):
        a, s = getattr(accel, name), getattr(serve, name)
        assert a is s, name
        assert name in accel.__all__ and name in serve.__all__


def test_failure_exceptions_exported_from_all_three_packages():
    """NodeDown and EngineFault are stable, identical exports of
    repro_torch.fleet, repro_torch.serve_tm AND repro_torch.accel."""
    import repro_torch.accel as accel
    import repro_torch.fleet as fleet
    import repro_torch.serve_tm as serve

    for name in ("NodeDown", "EngineFault"):
        a = getattr(accel, name)
        f = getattr(fleet, name)
        s = getattr(serve, name)
        assert a is s and f is s, name
        for pkg in (accel, fleet, serve):
            assert name in pkg.__all__, (name, pkg.__name__)
    assert fleet.ServingNode is serve.ServingNode
