"""The port's fleet failure model on the CPU: the cases of
tests/test_fleet_chaos.py on the port's nodes (deterministic chaos
injection, the per-node circuit breaker, retry/backoff under a hard
deadline budget, structured engine faults, failure-aware rollouts and
teardown, all under injected clocks), then the same scenarios driven
single-threaded on a reference fleet (JAX ``TMServer``s) and on the
port's, which must agree exactly: every request's outcome, each
``ChaosNode.fault_log``, ``FleetHealth.summary()``, each
``RolloutReport`` (all but its timings) and the text of
``NoEligibleNode``.  Last, TMProgram bytes cross between the packages'
rollouts, and a live four-node CPU fleet keeps the rollout-under-traffic
invariants."""

import asyncio
import dataclasses
import os
import subprocess
import sys
import textwrap
import threading
import time
import types

import numpy as np
import pytest

import jax.numpy as jnp

import repro.accel as jaccel
import repro.fleet as jfleet
import repro.serve_tm as jserve
import repro_torch.accel as taccel
import repro_torch.fleet as tfleet
import repro_torch.serve_tm as tserve
from repro.core import TMConfig as JTMConfig
from repro.core import batch_class_sums, state_from_actions
from repro.core.compress import encode as jencode
from repro_torch.accel import Accelerator, CapacityPlan, TMProgram
from repro_torch.core import TMConfig
from repro_torch.core.compress import encode
from repro_torch.fleet import (
    ChaosNode,
    FleetHealth,
    FleetPool,
    NodeDown,
    NoEligibleNode,
    RetryPolicy,
    RolloutAborted,
    RolloutManager,
    Router,
)
from repro_torch.serve_tm import EngineFault, TMServer
from repro_torch.serve_tm.schema import HEALTH_NODE_KEYS, HEALTH_STATES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAP_KNOBS = dict(
    instruction_capacity=1024, feature_capacity=128, class_capacity=16,
    clause_capacity=32, include_capacity=24, batch_words=2,
)
CAP = CapacityPlan(**CAP_KNOBS)


def _node(engine=None, cap=CAP):
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


class _FakeTime:
    """One injectable clock for the breaker, the policy and its sleeps."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = []  # (clock at sleep, requested duration)

    def clock(self):
        return self.t

    def sleep(self, d):
        self.sleeps.append((self.t, d))
        self.t += d


class _StubNode:
    """Minimal structural ServingNode whose submit always fails —
    drives the retry loop without touching an engine."""

    def __init__(self, advance=None):
        self.calls = 0
        self.scheduler_running = False
        self.capacity = CAP
        self._advance = advance  # simulated per-call service cost

    def submit(self, slot, x, *, priority="normal", timeout_ms=None):
        self.calls += 1
        if self._advance is not None:
            self._advance()
        raise RuntimeError("stub node always fails")

    async def async_submit(self, slot, x, *, priority="normal",
                           timeout_ms=None):
        return self.submit(slot, x, priority=priority, timeout_ms=timeout_ms)

    def flush(self):
        pass

    def infer(self, slot, x):
        return self.submit(slot, x)

    def class_sums(self, slot, x):
        raise RuntimeError("stub")

    def start(self):
        pass

    def stop(self, drain=True):
        pass

    def register(self, slot, model, provenance="install"):
        pass

    def rollback(self, slot):
        pass

    def validate_model(self, model):
        pass

    def queue_depth(self, slot=None, priority=None):
        return 0

    def metrics_snapshot(self):
        return {}

    def slots(self):
        return ["m"]

    def installed_checksum(self, slot):
        return 0

    def installed_artifact(self, slot):
        return None

    def compile_cache_size(self):
        return 1


# -- RetryPolicy: the deadline budget rule -----------------------------------


def test_retry_policy_validation_and_backoff_shape():
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="multiplier"):
        RetryPolicy(backoff_multiplier=0.5)
    p = RetryPolicy(backoff_base_s=0.01, backoff_multiplier=2.0,
                    backoff_max_s=0.05)
    assert [p.backoff_s(i) for i in range(5)] == [
        0.01, 0.02, 0.04, 0.05, 0.05,  # exponential, capped
    ]


def test_retry_policy_deadline_budget_property():
    """Property: against an always-failing node, the router never tries
    more than max_attempts, every backoff sleep fits inside the
    remaining deadline budget, and the backoff sequence is exactly the
    policy's capped exponential — all under simulated time."""
    pytest.importorskip("hypothesis", reason="property tests need hypothesis")
    from hypothesis import given, settings, strategies as st

    x = np.zeros((1, 4), np.uint8)

    @given(
        max_attempts=st.integers(1, 6),
        base_ms=st.floats(0.1, 50.0),
        mult=st.floats(1.0, 4.0),
        cap_ms=st.floats(0.1, 100.0),
        timeout_ms=st.one_of(st.none(), st.floats(0.1, 300.0)),
        call_cost_ms=st.floats(0.0, 30.0),
    )
    @settings(max_examples=60, deadline=None)
    def check(max_attempts, base_ms, mult, cap_ms, timeout_ms, call_cost_ms):
        ft = _FakeTime()

        def advance():
            ft.t += call_cost_ms / 1e3

        node = _StubNode(advance=advance)
        pool = FleetPool({"a": node})
        # thresholds pushed out of reach: this property is about the
        # policy arithmetic, not the breaker
        health = FleetHealth(
            pool=pool, clock=ft.clock, consecutive_failures=10 ** 9,
            min_window=10 ** 9, probe_after_s=1e9,
        )
        retry = RetryPolicy(
            max_attempts=max_attempts, backoff_base_s=base_ms / 1e3,
            backoff_multiplier=mult, backoff_max_s=cap_ms / 1e3,
            sleep=ft.sleep, clock=ft.clock,
        )
        router = Router(pool, health=health, retry=retry)
        with pytest.raises(RuntimeError, match="stub node always fails"):
            router.submit("m", x, timeout_ms=timeout_ms)
        assert 1 <= node.calls <= max_attempts
        if timeout_ms is None:
            # no deadline: the full attempt budget is spent, with one
            # backoff between each single-candidate sweep
            assert node.calls == max_attempts
            assert len(ft.sleeps) == max_attempts - 1
        else:
            deadline = timeout_ms / 1e3  # stamped at t=0
            for at, d in ft.sleeps:
                assert at + d < deadline  # never sleeps past the budget
        for i, (_, d) in enumerate(ft.sleeps):
            assert d == pytest.approx(retry.backoff_s(i))

    check()


# -- the circuit breaker ------------------------------------------------------


class _FlakySubmit(TMServer):
    """A real node whose submit fails on demand (the engine is fine)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.failing = False
        self.calls = 0

    def submit(self, slot, x, **kw):
        self.calls += 1
        if self.failing:
            raise RuntimeError("transient engine fault")
        return super().submit(slot, x, **kw)


def test_breaker_full_cycle_quarantine_probe_recover_under_fake_clock():
    """healthy → degraded → quarantined → (cooldown) → half-open probe →
    healthy, and the probe-failure edge back to quarantined — all
    transitions driven through the ROUTER, no wall-clock."""
    rng = np.random.default_rng(30)
    cfg, acts, model = _random_model(rng, 4, 10, 32)
    art = _program(model)
    bad = _FlakySubmit(CAP, engine="interp", device="cpu")
    ok = _node("plan")
    for node in (bad, ok):
        node.register("m", art)
    pool = FleetPool({"bad": bad, "ok": ok})
    ft = _FakeTime()
    health = FleetHealth(
        pool=pool, consecutive_failures=2, probe_after_s=5.0,
        heartbeat_timeout_s=1e9, clock=ft.clock,
    )
    router = Router(pool, health=health,
                    retry=RetryPolicy(sleep=ft.sleep, clock=ft.clock))
    x = rng.integers(0, 2, (4, 32)).astype(np.uint8)

    bad.failing = True
    assert router.submit("m", x).routed_to == "ok"
    assert health.state("bad") == "degraded"
    assert router.submit("m", x).routed_to == "ok"
    assert health.state("bad") == "quarantined"  # consecutive threshold

    # quarantined + cooldown not elapsed: the node is not even tried
    calls = bad.calls
    assert router.submit("m", x).routed_to == "ok"
    assert bad.calls == calls

    # cooldown elapses, the node healed: ONE half-open probe closes the
    # breaker and the probe request itself is served there
    ft.t += 5.0
    bad.failing = False
    h = router.submit("m", x)
    assert h.routed_to == "bad"
    assert health.state("bad") == "healthy"
    assert health.summary()["bad"]["probes"] == 1
    bad.flush()
    assert np.array_equal(np.asarray(h.class_sums), _oracle_sums(cfg, acts, x))

    # the probe-failure edge: re-quarantined, cooldown restamped
    bad.failing = True
    router.submit("m", x)
    router.submit("m", x)
    assert health.state("bad") == "quarantined"
    ft.t += 5.0
    assert health.probe_due("bad")
    assert router.submit("m", x).routed_to == "ok"  # probe fails over
    assert health.state("bad") == "quarantined"
    assert not health.probe_due("bad")  # cooldown restarted
    assert health.summary()["bad"]["probes"] == 2
    assert health.summary()["bad"]["quarantines"] == 3
    # the router mirrored failovers into the serving node's own metrics
    assert ok.metrics.failovers > 0


def test_router_all_quarantined_raises_structured_no_eligible_node():
    node = _StubNode()
    pool = FleetPool({"a": node})
    health = FleetHealth(pool=pool, probe_after_s=1e9)
    health.quarantine("a", reason="manual")
    router = Router(pool, health=health,
                    retry=RetryPolicy(sleep=lambda d: None))
    with pytest.raises(NoEligibleNode, match="quarantined or unreachable"):
        router.submit("m", np.zeros((1, 4), np.uint8))
    assert node.calls == 0


def test_heartbeat_sweep_quarantines_silent_nodes():
    ft = _FakeTime()
    health = FleetHealth(heartbeat_timeout_s=10.0, clock=ft.clock)
    health.record_success("a")
    health.record_success("b")
    ft.t = 5.0
    health.record_success("a")  # a keeps beating, b goes silent
    ft.t = 12.0
    assert health.sweep() == ["b"]
    assert health.state("b") == "quarantined"
    assert health.state("a") == "healthy"
    assert health.sweep() == []  # already quarantined: not re-flagged


def test_straggler_evict_quarantines_slow_node():
    """A node that still answers but far slower than its own history is
    routed around like a dead one (supervisor's StragglerMonitor)."""
    health = FleetHealth(consecutive_failures=10 ** 9)
    for _ in range(8):
        health.record_success("slow", latency_s=0.01)
    assert health.state("slow") == "healthy"
    n = 0
    while health.state("slow") != "quarantined" and n < 30:
        health.record_success("slow", latency_s=5.0)
        n += 1
    assert health.state("slow") == "quarantined"
    assert health.summary()["slow"]["quarantines"] == 1


def test_health_summary_matches_schema():
    health = FleetHealth()
    health.record_success("a", latency_s=0.01)
    health.record_failure("b", RuntimeError("x"))
    health.record_overload("a")
    summary = health.summary()
    assert list(summary) == ["a", "b"]
    for d in summary.values():
        assert tuple(d.keys()) == HEALTH_NODE_KEYS
        assert d["state"] in HEALTH_STATES
    assert summary["a"]["overloads"] == 1
    assert summary["b"]["consecutive_failures"] == 1


# -- ChaosNode ----------------------------------------------------------------


def _chaos_server(art, engine="interp", **chaos_kw):
    inner = _node(engine)
    inner.register("m", art)
    chaos_kw.setdefault("sleep", lambda d: None)
    return inner, ChaosNode(inner, **chaos_kw)


def _drive(chaos, x, n_ops):
    """A fixed op script; faults are swallowed, the schedule advances."""
    for i in range(n_ops):
        op = ("submit", "infer", "flush")[i % 3]
        try:
            if op == "submit":
                chaos.submit("m", x)
            elif op == "infer":
                chaos.infer("m", x)
            else:
                chaos.flush()
        except Exception:
            pass


def test_chaos_same_seed_replays_identical_fault_schedule():
    rng = np.random.default_rng(40)
    cfg, acts, model = _random_model(rng, 4, 10, 32)
    art = _program(model)
    x = rng.integers(0, 2, (3, 32)).astype(np.uint8)
    rates = dict(error_rate=0.2, latency_rate=0.15, latency_s=0.0,
                 overload_rate=0.15, hang_rate=0.1)
    logs = []
    for seed in (7, 7, 8):
        _, chaos = _chaos_server(art, seed=seed, **rates)
        _drive(chaos, x, 40)
        logs.append(list(chaos.fault_log))
    assert logs[0] == logs[1]        # same seed -> identical schedule
    assert logs[0] != logs[2]        # different seed -> different storm
    faults = {f for _, _, f in logs[0]}
    assert faults - {"ok"}           # the storm actually injected faults


def test_chaos_hung_handle_resolved_by_kill_then_revive():
    rng = np.random.default_rng(41)
    cfg, acts, model = _random_model(rng, 4, 10, 32)
    art = _program(model)
    inner, chaos = _chaos_server(art, name="h", seed=3, hang_rate=1.0)
    x = rng.integers(0, 2, (4, 32)).astype(np.uint8)
    h = chaos.submit("m", x)
    with pytest.raises(TimeoutError):
        h.wait(timeout=0.05)  # hung: the node accepted, then went silent
    assert h.status == "pending"
    chaos.kill()
    assert h.failed and h.status == "failed"
    with pytest.raises(NodeDown):
        h.result()
    with pytest.raises(NodeDown):
        chaos.submit("m", x)
    with pytest.raises(NodeDown):
        chaos.queue_depth()
    assert chaos.down and not chaos.scheduler_running
    chaos.revive()
    chaos.rates["hang"] = 0.0
    h2 = chaos.submit("m", x)
    chaos.flush()
    assert (h2.result() == _oracle_sums(cfg, acts, x).argmax(1)).all()


def test_chaos_corrupted_artifact_rejected_by_crc():
    """A bit-flipped TMProgram on the wire NEVER reaches a live
    accelerator: the CRC-32 integrity check rejects it on install."""
    rng = np.random.default_rng(42)
    _, _, model = _random_model(rng, 4, 10, 32)
    art = _program(model)
    inner = _node()
    chaos = ChaosNode(inner, seed=0, corrupt_rate=1.0)
    with pytest.raises(ValueError, match="checksum mismatch"):
        chaos.register("m", art)
    assert "m" not in inner.slots()  # the registry was never touched


def test_chaos_down_after_ops_is_deterministic():
    rng = np.random.default_rng(43)
    _, _, model = _random_model(rng, 4, 10, 32)
    art = _program(model)
    x = rng.integers(0, 2, (2, 32)).astype(np.uint8)
    _, chaos = _chaos_server(art, seed=0, down_after_ops=3)
    chaos.submit("m", x)
    chaos.submit("m", x)
    chaos.flush()  # op 3: the last one served
    with pytest.raises(NodeDown):
        chaos.submit("m", x)
    assert chaos.fault_log[-1] == (4, "submit", "down")


# -- routing under faults -----------------------------------------------------


def test_router_failover_bit_exact_across_heterogeneous_engines():
    """A failed-over request returns predictions AND class sums
    identical to the dense oracle even when the healthy replica runs a
    different engine than the one that failed."""
    rng = np.random.default_rng(50)
    cfg, acts, model = _random_model(rng, 5, 12, 40)
    art = _program(model)
    flaky_inner, flaky = _chaos_server(art, engine="interp",
                                       name="flaky", seed=5, error_rate=1.0)
    ok = _node("popcount")
    ok.register("m", art)
    pool = FleetPool({"flaky": flaky, "ok": ok})
    health = FleetHealth(pool=pool, consecutive_failures=3,
                         probe_after_s=1e6)
    router = Router(pool, health=health,
                    retry=RetryPolicy(sleep=lambda d: None))
    handles = []
    for _ in range(3):
        x = rng.integers(0, 2, (6, 40)).astype(np.uint8)
        h = router.submit("m", x)
        assert h.routed_to == "ok"
        handles.append((h, x))
    assert health.state("flaky") == "quarantined"
    # the breaker event was mirrored into the node's own metrics
    assert flaky_inner.metrics.quarantines == 1
    assert ok.metrics.failovers == 3
    ok.flush()
    for h, x in handles:
        want = _oracle_sums(cfg, acts, x)
        assert (h.result() == want.argmax(1)).all()
        assert np.array_equal(np.asarray(h.class_sums), want)


class _FailsOnce(TMServer):
    """First submit (sync or async) raises; every later one serves."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.failures_left = 1

    def _maybe_fail(self):
        if self.failures_left > 0:
            self.failures_left -= 1
            raise RuntimeError("transient")

    def submit(self, slot, x, **kw):
        self._maybe_fail()
        return super().submit(slot, x, **kw)

    async def async_submit(self, slot, x, **kw):
        self._maybe_fail()
        return await super().async_submit(slot, x, **kw)


def test_router_retry_after_backoff_serves_bit_exact():
    """A single-node fleet whose node fails once: the router backs off,
    re-sweeps, and the RETRIED request is served bit-exact; the node's
    metrics record the retry."""
    rng = np.random.default_rng(51)
    cfg, acts, model = _random_model(rng, 4, 10, 32)
    node = _FailsOnce(CAP, engine="plan", device="cpu")
    node.register("m", _program(model))
    pool = FleetPool({"only": node})
    ft = _FakeTime()
    health = FleetHealth(pool=pool, consecutive_failures=5, clock=ft.clock)
    retry = RetryPolicy(max_attempts=3, backoff_base_s=0.01,
                        sleep=ft.sleep, clock=ft.clock)
    router = Router(pool, health=health, retry=retry)
    x = rng.integers(0, 2, (5, 32)).astype(np.uint8)
    h = router.submit("m", x)
    assert h.routed_to == "only"
    assert ft.sleeps == [(0.0, 0.01)]  # exactly one backoff sweep
    assert node.metrics.retries == 1
    node.flush()
    want = _oracle_sums(cfg, acts, x)
    assert (h.result() == want.argmax(1)).all()
    assert np.array_equal(np.asarray(h.class_sums), want)


def test_router_async_retry_with_injected_sleep():
    rng = np.random.default_rng(52)
    cfg, acts, model = _random_model(rng, 4, 10, 32)
    node = _FailsOnce(CAP, engine="interp", device="cpu")
    node.register("m", _program(model))
    pool = FleetPool({"only": node})
    ft = _FakeTime()
    health = FleetHealth(pool=pool, consecutive_failures=5, clock=ft.clock)
    retry = RetryPolicy(max_attempts=3, backoff_base_s=0.02,
                        sleep=ft.sleep, clock=ft.clock)
    router = Router(pool, health=health, retry=retry)
    x = rng.integers(0, 2, (5, 32)).astype(np.uint8)
    h = asyncio.run(router.async_submit("m", x))
    assert h.routed_to == "only"
    assert ft.sleeps == [(0.0, 0.02)]  # injected sleep, not asyncio's
    node.flush()
    assert (h.result() == _oracle_sums(cfg, acts, x).argmax(1)).all()


def test_router_routes_around_dead_node_and_quarantines_it():
    """A node that dies outright (introspection raises NodeDown) is
    skipped by candidates, recorded as failing, and quarantined."""
    rng = np.random.default_rng(53)
    cfg, acts, model = _random_model(rng, 4, 10, 32)
    art = _program(model)
    _, dead = _chaos_server(art, engine="interp", name="d", seed=0)
    ok = _node("plan")
    ok.register("m", art)
    pool = FleetPool({"d": dead, "ok": ok})
    health = FleetHealth(pool=pool, consecutive_failures=3,
                         probe_after_s=1e6)
    router = Router(pool, health=health,
                    retry=RetryPolicy(sleep=lambda d: None))
    dead.kill()
    x = rng.integers(0, 2, (4, 32)).astype(np.uint8)
    for _ in range(3):
        assert router.submit("m", x).routed_to == "ok"
    assert health.state("d") == "quarantined"


# -- structured engine faults -------------------------------------------------


def test_scheduler_engine_fault_fails_handles_and_loop_survives():
    """A raising batch body fails its requests with EngineFault (slot +
    cause) instead of stranding them; the slot serves again once the
    engine recovers."""
    rng = np.random.default_rng(60)
    cfg, acts, model = _random_model(rng, 4, 10, 32)
    server = _node("plan")
    server.register("m", model)
    x = rng.integers(0, 2, (6, 32)).astype(np.uint8)
    h = server.submit("m", x)
    real = server.executor

    class _Boom:
        def __getattr__(self, name):
            return getattr(real, name)  # staging etc. still work

        def class_sums(self, prog, xx):
            raise RuntimeError("device fell off the bus")

    server.executor = _Boom()
    server.flush()  # must not raise: the batch body absorbs the fault
    assert h.failed and h.status == "failed"
    with pytest.raises(EngineFault) as ei:
        h.result()
    assert ei.value.slot == "m"
    assert isinstance(ei.value.cause, RuntimeError)
    assert "device fell off the bus" in str(ei.value)
    # recovery: the same server keeps serving after the engine heals
    server.executor = real
    h2 = server.submit("m", x)
    server.flush()
    assert (h2.result() == _oracle_sums(cfg, acts, x).argmax(1)).all()


# -- failure-aware rollouts ---------------------------------------------------


def _three_node_pool(v1, victim_kw):
    """n0/n2 plain, n1 chaos-wrapped (the wave stage's only member)."""
    inners = {}
    for i, eng in enumerate(("interp", "plan", "popcount")):
        inner = _node(eng)
        inner.register("m", v1)
        inners[f"n{i}"] = inner
    victim = ChaosNode(inners["n1"], name="n1", sleep=lambda d: None,
                       **victim_kw)
    pool = FleetPool({"n0": inners["n0"], "n1": victim, "n2": inners["n2"]})
    return inners, victim, pool


def test_rollout_midwave_node_death_quarantines_and_rolls_back_reachable():
    """A node dying mid-wave is a gate failure: the rollback completes
    on every reachable node, the corpse is quarantined and recorded
    unreachable (it keeps the attempted artifact until it returns)."""
    rng = np.random.default_rng(70)
    _, _, m1 = _random_model(rng, 5, 12, 40)
    _, _, m2 = _random_model(rng, 5, 12, 40)
    v1, v2 = _program(m1), _program(m2)
    # op 1 = the wave install (survives), op 2 = the gate submit (dies)
    inners, victim, pool = _three_node_pool(v1, dict(seed=0,
                                                     down_after_ops=1))
    health = FleetHealth(pool=pool)
    X = rng.integers(0, 2, (24, 40)).astype(np.uint8)
    with pytest.raises(RolloutAborted) as ei:
        RolloutManager(pool, health=health).rollout("m", v2, holdout_x=X)
    err = ei.value
    assert err.stage == "wave" and "died during the gate" in err.reason
    assert err.report.rolled_back == ("n0",)
    assert err.report.unreachable == ("n1",)
    # reachable nodes are back on (or never left) the OLD checksum
    assert inners["n0"].installed_checksum("m") == v1.checksum
    assert inners["n0"].registry.get("m").provenance.startswith("rollback:")
    assert inners["n2"].installed_checksum("m") == v1.checksum
    assert "rollout" not in inners["n2"].registry.get("m").provenance
    # the corpse kept the attempted artifact and is quarantined
    assert inners["n1"].installed_checksum("m") == v2.checksum
    assert health.state("n1") == "quarantined"


def test_rollout_corrupt_install_aborts_cleanly_and_quarantines():
    """Corrupted wire bytes die at the node's CRC check BEFORE its
    registry is touched: the stage aborts, the victim still runs the
    old program, the canary is rolled back."""
    rng = np.random.default_rng(71)
    _, _, m1 = _random_model(rng, 5, 12, 40)
    _, _, m2 = _random_model(rng, 5, 12, 40)
    v1, v2 = _program(m1), _program(m2)
    inners, victim, pool = _three_node_pool(v1, dict(seed=0,
                                                     corrupt_rate=1.0))
    health = FleetHealth(pool=pool)
    X = rng.integers(0, 2, (24, 40)).astype(np.uint8)
    with pytest.raises(RolloutAborted) as ei:
        RolloutManager(pool, health=health).rollout("m", v2, holdout_x=X)
    err = ei.value
    assert err.stage == "wave" and "failed install" in err.reason
    assert "checksum mismatch" in err.reason
    assert err.report.rolled_back == ("n0",)
    assert err.report.unreachable == ()  # alive, just fed garbage
    for name in ("n0", "n1", "n2"):
        assert inners[name].installed_checksum("m") == v1.checksum
    assert health.state("n1") == "quarantined"


# -- dead-node-tolerant pool lifecycle ----------------------------------------


def test_pool_remove_and_stop_all_tolerate_dead_nodes():
    rng = np.random.default_rng(80)
    _, _, model = _random_model(rng, 4, 10, 32)
    art = _program(model)
    inner, dead = _chaos_server(art, name="dead", seed=0)
    ok = _node("plan")
    ok.register("m", art)
    pool = FleetPool({"dead": dead, "ok": ok})
    pool.start_all()
    try:
        dead.kill()
        # rollups flag the corpse instead of raising
        ms = pool.metrics_summary()
        assert ms["unreachable"] == ["dead"] and "ok" in ms["nodes"]
        assert pool.queue_depths() == {"ok": 0}
        assert [n for n, _ in pool.nodes_with_slot("m")] == ["ok"]
        # teardown completes; the failure is a recorded warning
        pool.stop_all()
        assert any("dead" in w for w in pool.warnings)
        n_warnings = len(pool.warnings)
        assert pool.remove("dead") is dead
        assert "dead" not in pool
        assert len(pool.warnings) == n_warnings + 1
    finally:
        pool.stop_all()
        inner.stop()  # the corpse's own loop, which its wrapper cannot reach


# -- deprecations -------------------------------------------------------------


def test_gate_timeout_constant_deprecation_fires_once():
    """Reading the deprecated fleet.rollout.GATE_TIMEOUT_S constant
    warns exactly once per process; importing the module stays silent."""
    code = textwrap.dedent(
        """
        import warnings

        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            import repro_torch.fleet.rollout as ro  # import: silent
            v1 = ro.GATE_TIMEOUT_S                  # first access: warns
            v2 = ro.GATE_TIMEOUT_S                  # cached: silent
        assert v1 == v2 == 120.0
        dep = [
            w for w in rec
            if issubclass(w.category, DeprecationWarning)
            and "GATE_TIMEOUT_S" in str(w.message)
        ]
        assert len(dep) == 1, [str(w.message) for w in rec]
        assert "gate_timeout_s" in str(dep[0].message)
        print("GATE-OK")
        """
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get(
        "PYTHONPATH", ""
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "GATE-OK" in out.stdout


# -- the same scenarios on both packages -------------------------------------
# Requests carry no ``timeout_ms`` here: a node stamps deadlines on the
# wall clock, which no two runs share (the deadline budget's arithmetic is
# the property test's above).

PACKAGES = {
    "jax": types.SimpleNamespace(
        fleet=jfleet, TMProgram=jaccel.TMProgram, cap=jaccel.CapacityPlan(**CAP_KNOBS),
        server=lambda cap, engine: jserve.TMServer(cap, engine=engine),
        accelerator=lambda cap: jaccel.Accelerator(plan=cap),
    ),
    "torch": types.SimpleNamespace(
        fleet=tfleet, TMProgram=taccel.TMProgram, cap=CAP,
        server=lambda cap, engine: tserve.TMServer(cap, engine=engine, device="cpu"),
        accelerator=lambda cap: taccel.Accelerator(cap, device="cpu"),
    ),
}
# the engines both packages run on the CPU; the reference's ``sharded``
# fails on this tree, the port's waits for the multi-device slice
SHARED_ENGINES = ("interp", "plan", "popcount")


def _models(seed, n=2, dims=(5, 12, 40)):
    rng = np.random.default_rng(seed)
    return rng, [_random_model(rng, *dims) for _ in range(n)]


def _nodes(P, blob, n=3):
    """n nodes of package P on the shared engines (the façade 4th),
    each holding ``blob`` in slot "m"."""
    nodes = {}
    for i in range(n):
        node = (P.accelerator(P.cap) if i == 3
                else P.server(P.cap, SHARED_ENGINES[i]))
        node.register("m", P.TMProgram.from_bytes(blob))
        nodes[f"n{i}"] = node
    return nodes


def _attempt(fn):
    """What a call did: ("ok", value) or the exception's type and text."""
    try:
        return ("ok", fn())
    except Exception as e:
        return ("raised", type(e).__name__, str(e))


def _resolved(h):
    """A routed handle's terminal state, as bytes that compare across the
    packages: predictions and class sums, or the error's type and text."""
    if h.status == "pending":
        return ("pending", h.routed_to)
    try:
        preds = h.result()
    except Exception as e:
        return ("failed", h.routed_to, type(e).__name__, str(e))
    return ("done", h.routed_to, np.asarray(preds, np.int64).tobytes(),
            np.asarray(h.class_sums, np.int64).tobytes())


def _report(report):
    """A RolloutReport without its timings."""
    d = dataclasses.asdict(report)
    for s in d["stages"]:
        del s["install_s"], s["verify_s"]
    return d


def _routing_scenario(P, blob, xs):
    """Failover, the breaker's whole cycle (kill -> quarantine -> revive
    -> half-open probe) and the NoEligibleNode texts, single-threaded
    under one fake clock."""
    ft = _FakeTime()
    nodes = _nodes(P, blob)
    flaky = P.fleet.ChaosNode(
        nodes["n0"], name="n0", seed=7, error_rate=0.25, overload_rate=0.25,
        latency_rate=0.15, latency_s=0.004, sleep=ft.sleep,
    )
    pool = P.fleet.FleetPool({"n0": flaky, "n1": nodes["n1"], "n2": nodes["n2"]})
    health = P.fleet.FleetHealth(
        pool=pool, consecutive_failures=2, probe_after_s=5.0,
        heartbeat_timeout_s=1e9, clock=ft.clock,
    )
    router = P.fleet.Router(pool, health=health, retry=P.fleet.RetryPolicy(
        max_attempts=3, sleep=ft.sleep, clock=ft.clock))
    outcomes, pending = [], []
    for i, x in enumerate(xs):
        if i == 15:
            flaky.kill()
        if i == 24:
            flaky.revive()
            ft.t += 5.0  # the cooldown elapses: the next request probes
        pending.append(_attempt(lambda: router.submit(
            "m", x, priority=("normal", "critical")[i % 2])))
        if i % 3 == 2:  # queues build up three requests deep, then drain
            for node in nodes.values():
                node.flush()
            outcomes += [got if got[0] != "ok" else _resolved(got[1])
                         for got in pending]
            pending = []
    outcomes.append(_attempt(lambda: router.route("ghost")))
    for name in pool.names():
        health.quarantine(name, reason="drill")
    outcomes.append(_attempt(lambda: router.submit("m", xs[0])))
    return {"outcomes": outcomes, "fault_log": flaky.fault_log,
            "health": health.summary()}


def _rollout_scenario(P, blobs, X, y):
    """A good rollout over four nodes (``y`` is the new program's truth),
    then a bad artifact that dies at the canary's accuracy gate, then a
    corrupted wave install, all driven through each node's flush (no
    scheduler loop)."""
    nodes = _nodes(P, blobs[0], n=4)
    pool = P.fleet.FleetPool(nodes)
    health = P.fleet.FleetHealth(pool=pool)
    manager = P.fleet.RolloutManager(pool, health=health)
    out = {"good": _report(manager.rollout(
        "m", P.TMProgram.from_bytes(blobs[1]), holdout_x=X, holdout_y=y))}
    for name in ("bad", "corrupt"):
        if name == "corrupt":
            pool = P.fleet.FleetPool({
                "n0": nodes["n0"],
                "n1": P.fleet.ChaosNode(nodes["n1"], name="n1", seed=0,
                                        corrupt_rate=1.0),
                "n2": nodes["n2"],
            })
            manager = P.fleet.RolloutManager(pool, health=health)
        try:
            manager.rollout("m", P.TMProgram.from_bytes(blobs[2]), holdout_x=X,
                            holdout_y=y if name == "bad" else None)
        except P.fleet.RolloutAborted as e:
            out[name] = (str(e), _report(e.report))
        out[f"{name} checksums"] = {
            n: node.installed_checksum("m") for n, node in nodes.items()}
    out["provenance"] = {n: node.registry.get("m").provenance
                         for n, node in nodes.items()}
    out["health"] = health.summary()
    out["cache"] = [node.compile_cache_size() for node in nodes.values()]
    return out


def _chaos_scenario(P, blob, xs):
    """The fleet bench's chaos run, single-threaded: four ChaosNodes
    (seeds 100 + i, only the victim hangs), mixed priorities, the victim
    killed a third of the way in and revived at two thirds; critical
    requests are resubmitted on structured errors."""
    ft = _FakeTime()
    inners = _nodes(P, blob, n=4)
    chaos = {name: P.fleet.ChaosNode(
        inner, name=name, seed=100 + i, error_rate=0.06, latency_rate=0.08,
        latency_s=0.0005, overload_rate=0.04,
        hang_rate=0.1 if name == "n1" else 0.0, sleep=ft.sleep,
    ) for i, (name, inner) in enumerate(inners.items())}
    pool = P.fleet.FleetPool(chaos)
    health = P.fleet.FleetHealth(pool=pool, consecutive_failures=3,
                                 probe_after_s=0.05, heartbeat_timeout_s=600.0,
                                 clock=ft.clock)
    router = P.fleet.Router(pool, health=health, retry=P.fleet.RetryPolicy(
        max_attempts=6, backoff_base_s=0.002, backoff_max_s=0.02,
        sleep=ft.sleep, clock=ft.clock))
    n_critical = 48
    kill_at, revive_at = n_critical // 3, 2 * n_critical // 3
    outcomes, critical, quarantined_at = [], [], None

    def drain():
        for inner in inners.values():
            inner.flush()

    for i in range(n_critical):
        if i == kill_at:
            chaos["n1"].kill()
        if i == revive_at:
            chaos["n1"].revive()
            chaos["n1"].rates["hang"] = 0.0
            ft.t += health.probe_after_s
        background = _attempt(lambda: router.submit("m", xs[(i + 3) % len(xs)]))
        final = None
        for _ in range(12):  # the critical lane resubmits until it lands
            got = _attempt(lambda: router.submit(
                "m", xs[i % len(xs)], priority="critical"))
            drain()
            final = got if got[0] != "ok" else _resolved(got[1])
            outcomes.append(final)
            if final[0] == "done":
                break
        critical.append((i, final))
        if background[0] == "ok":
            outcomes.append(_resolved(background[1]))
        if quarantined_at is None and health.state("n1") == "quarantined":
            quarantined_at = health.summary()["n1"]["consecutive_failures"]
    return {"outcomes": outcomes, "critical": critical,
            "fault_logs": {n: c.fault_log for n, c in chaos.items()},
            "health": health.summary(), "quarantined_at": quarantined_at}


def test_routing_with_failover_matches_the_reference():
    rng, [(cfg, acts, model)] = _models(90, n=1)
    blob = _program(model).to_bytes()
    xs = [rng.integers(0, 2, (int(rng.integers(1, 50)), 40)).astype(np.uint8)
          for _ in range(36)]
    runs = {name: _routing_scenario(P, blob, xs) for name, P in PACKAGES.items()}
    assert runs["torch"] == runs["jax"]
    run = runs["torch"]
    done = [o for o in run["outcomes"] if o[0] == "done"]
    assert len(done) >= 30 and {o[1] for o in done} == {"n0", "n1", "n2"}
    for o, x in zip(run["outcomes"], xs):
        if o[0] == "done":
            assert o[3] == _oracle_sums(cfg, acts, x).astype(np.int64).tobytes()
    assert {f for _, _, f in run["fault_log"]} >= {"ok", "error", "overload"}
    assert run["health"]["n0"]["probes"] >= 1 and run["health"]["n0"]["quarantines"] >= 2
    ghost, drill = run["outcomes"][-2:]
    assert ghost[1] == "NoEligibleNode" and "slot 'ghost'" in ghost[2]
    assert drill[1] == "NoEligibleNode" and "3 node(s) quarantined" in drill[2]


def test_rollout_and_canary_abort_match_the_reference():
    rng, models = _models(91, n=3)
    blobs = [_program(m).to_bytes() for _, _, m in models]
    X = rng.integers(0, 2, (64, 40)).astype(np.uint8)
    (cfg1, acts1, _), (cfg2, acts2, _) = models[:2]
    y_new = _oracle_sums(cfg2, acts2, X).argmax(1)
    runs = {name: _rollout_scenario(P, blobs, X, y_new)
            for name, P in PACKAGES.items()}
    assert runs["torch"] == runs["jax"]
    run = runs["torch"]
    assert run["good"]["completed"] and all(
        s["bit_exact"] and s["checksum_ok"] and s["accuracy"] == 1.0
        for s in run["good"]["stages"])
    assert run["bad"][1]["failed_stage"] == "canary"
    assert run["corrupt"][1]["failed_stage"] == "wave"
    assert "checksum mismatch" in run["corrupt"][1]["failure_reason"]
    v2 = TMProgram.from_bytes(blobs[1]).checksum
    assert set(run["bad checksums"].values()) == {v2}
    assert run["cache"] == [1, 1, 1, 1]


def test_chaos_kill_and_revive_matches_the_reference():
    rng, [(cfg, acts, model)] = _models(92, n=1)
    blob = _program(model).to_bytes()
    xs = [rng.integers(0, 2, (16, 40)).astype(np.uint8) for _ in range(8)]
    runs = {name: _chaos_scenario(P, blob, xs) for name, P in PACKAGES.items()}
    assert runs["torch"] == runs["jax"]
    run = runs["torch"]
    # zero critical requests lost or incorrect
    for i, final in run["critical"]:
        want = _oracle_sums(cfg, acts, xs[i % len(xs)]).astype(np.int64)
        assert final[0] == "done" and final[3] == want.tobytes(), (i, final)
    assert run["quarantined_at"] is not None and run["quarantined_at"] <= 3
    victim = run["health"]["n1"]
    assert victim["probes"] >= 1 and victim["state"] not in ("quarantined", "half_open")
    assert any(f == "hang" for _, _, f in run["fault_logs"]["n1"])


def test_program_bytes_roll_out_through_the_other_package():
    """TMProgram bytes written by each package roll out through the
    other's RolloutManager, installed with the writer's checksum."""
    rng, [(cfg1, acts1, m1), (cfg2, acts2, m2)] = _models(93)
    X = rng.integers(0, 2, (32, 40)).astype(np.uint8)
    jcfg = JTMConfig(cfg2.n_classes, cfg2.n_clauses, cfg2.n_features)
    written = {
        "torch": _program(m2).to_bytes(),
        "jax": jaccel.TMProgram(capacity=PACKAGES["jax"].cap,
                                model=jencode(jcfg, acts2)).to_bytes(),
    }
    assert written["torch"] == written["jax"]
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        P = PACKAGES[reader]
        nodes = _nodes(P, _program(m1).to_bytes())
        art = P.TMProgram.from_bytes(written[writer])
        report = P.fleet.RolloutManager(P.fleet.FleetPool(nodes)).rollout(
            "m", art, holdout_x=X)
        assert report.completed and report.checksum == art.checksum
        for node in nodes.values():
            assert node.installed_checksum("m") == art.checksum
            assert np.array_equal(np.asarray(node.class_sums("m", X)),
                                  _oracle_sums(cfg2, acts2, X))


def test_live_four_node_fleet_rolls_out_under_traffic():
    """Four nodes (interp, plan, popcount and the façade) with their
    scheduler loops running; a thread keeps router traffic flowing while
    v2 ships canary -> wave -> fleet.  Nothing is dropped, every reply
    is the old or the new program's oracle, every stage is bit-exact."""
    rng, [(cfg1, acts1, m1), (cfg2, acts2, m2)] = _models(94)
    v1, v2 = _program(m1), _program(m2)
    pool = FleetPool()
    for i, eng in enumerate(SHARED_ENGINES + ("accelerator",)):
        node = Accelerator(CAP, device="cpu") if eng == "accelerator" else _node(eng)
        node.register("edge", v1)
        pool.add(f"n{i}", node)
    router = Router(pool)
    blocks = [rng.integers(0, 2, (16, 40)).astype(np.uint8) for _ in range(6)]
    holdout = rng.integers(0, 2, (64, 40)).astype(np.uint8)
    y2 = _oracle_sums(cfg2, acts2, holdout).argmax(1)
    served, stop = [], threading.Event()

    def traffic():
        # closed loop, at most four requests in flight: an open loop above
        # the service rate (a slow, shared CPU) would grow the queues
        # without bound, and a hot-swap drains its node's queue to empty
        i = 0
        while not stop.is_set():
            x = blocks[i % len(blocks)]
            served.append((router.submit("edge", x), x))
            if len(served) >= 4:
                served[-4][0].wait(timeout=60.0)
            i += 1
            time.sleep(0.004)

    pool.start_all()
    thread = threading.Thread(target=traffic, daemon=True)
    try:
        thread.start()
        time.sleep(0.05)
        report = RolloutManager(pool, gate_timeout_s=60.0).rollout(
            "edge", v2, holdout_x=holdout, holdout_y=y2, min_accuracy=0.99)
        time.sleep(0.05)
    finally:
        stop.set()
        thread.join(timeout=30)
        results = []
        for h, x in served:
            try:
                results.append((h.wait(timeout=60.0), x))
            except Exception as e:  # noted, then failed below
                results.append((e, x))
        pool.stop_all()
    assert not thread.is_alive()
    assert report.completed and [s.stage for s in report.stages] == [
        "canary", "wave", "fleet"]
    assert all(s.bit_exact and s.checksum_ok and s.accuracy == 1.0
               for s in report.stages)
    on_old = on_new = 0
    for preds, x in results:
        assert isinstance(preds, np.ndarray), preds  # nothing dropped
        if np.array_equal(preds, _oracle_sums(cfg1, acts1, x).argmax(1)):
            on_old += 1
        else:
            assert np.array_equal(preds, _oracle_sums(cfg2, acts2, x).argmax(1))
            on_new += 1
    assert on_old + on_new == len(served) > 0
    for _, node in pool.items():
        assert node.installed_checksum("edge") == v2.checksum
        assert node.compile_cache_size() == 1
