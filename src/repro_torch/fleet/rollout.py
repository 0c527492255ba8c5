"""Canary → wave → fleet-wide artifact rollouts over a ``FleetPool``.

The fleet analog of the paper's Fig-8 reprogram step: a recalibrated
``TMProgram`` ships to ONE node first (the canary), is gated on real
served traffic, then widens to a wave (~half the remaining nodes) and
finally the whole fleet — each stage re-gated before the next may start.

Per-node, per-stage gates:

  * **integrity** — the node's ``installed_checksum(slot)`` must equal
    the shipped artifact's CRC-32 (the wire artifact the node actually
    programmed is the one the operator audited);
  * **bit-exactness** — the holdout block is served through the node's
    REAL batched path (submit → scheduler/flush → demux) and every
    node's class sums must match the canary's exactly.  Heterogeneous
    engines are interchangeable only because of this invariant, so the
    rollout re-proves it on every node it touches;
  * **accuracy** — with labels, holdout accuracy must stay within
    ``regression_margin`` of the pre-rollout baseline (or clear an
    absolute ``min_accuracy``) — the fleet edition of the recal
    controller's post-swap validation.

A failed gate triggers the FLEET-WIDE rollback: every node that received
this rollout's artifact is rolled back through its registry's
drain-then-swap path, so the provenance chain on each node records both
the attempt and the retreat (``rollback:v3->v2(rollout:canary:…)``), and
the structured ``RolloutAborted`` carries the full ``RolloutReport``.
In-flight traffic is never dropped: installs and rollbacks hold each
node's scheduler lock across drain + install, exactly like a single-node
hot-swap.

Failure-aware: a node that dies mid-wave — raising out of its install,
its gate, or the retreat's rollback — is treated as a GATE FAILURE, not
a crash of the rollout itself.  The dead node is quarantined (when the
manager shares the router's ``FleetHealth``), the rollback still
completes on every reachable node, and ``RolloutReport.unreachable``
records who kept the attempted artifact so an operator can reconcile
when the node returns.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..accel.program import TMProgram
from .health import FleetHealth
from .pool import FleetPool, _validate_for_node
from .router import NoEligibleNode

# how long a gate waits for the node to serve the holdout block (a live
# scheduler loop completes it; without one the rollout drives flush())
_DEFAULT_GATE_TIMEOUT_S = 120.0

STAGES = ("canary", "wave", "fleet")

_GATE_TIMEOUT_WARNED = False


def __getattr__(name: str):
    # deprecated module constant: the timeout is a RolloutManager knob
    # now (gate_timeout_s=), per the once-per-process warning pattern
    if name == "GATE_TIMEOUT_S":
        global _GATE_TIMEOUT_WARNED
        if not _GATE_TIMEOUT_WARNED:
            _GATE_TIMEOUT_WARNED = True
            warnings.warn(
                "fleet.rollout.GATE_TIMEOUT_S is deprecated: pass "
                "RolloutManager(..., gate_timeout_s=...) instead — the "
                "module constant is no longer consulted at run time",
                DeprecationWarning,
                stacklevel=2,
            )
        return _DEFAULT_GATE_TIMEOUT_S
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass(frozen=True)
class StageReport:
    """One rollout stage: which nodes, what the gates measured."""

    stage: str
    nodes: Tuple[str, ...]
    versions: Dict[str, int]          # slot version installed per node
    checksum_ok: bool
    bit_exact: bool
    accuracy: Optional[float]         # worst node accuracy (labels given)
    passed: bool
    install_s: float
    verify_s: float


@dataclasses.dataclass
class RolloutReport:
    """The full trip (or the aborted prefix) of one artifact rollout."""

    slot: str
    checksum: int
    stages: List[StageReport]
    completed: bool
    failed_stage: Optional[str] = None
    failure_reason: Optional[str] = None
    rolled_back: Tuple[str, ...] = ()
    # nodes the retreat could NOT reach (dead mid-rollout): they keep the
    # attempted artifact until they come back; the health layer
    # quarantines them so no traffic routes there meanwhile
    unreachable: Tuple[str, ...] = ()
    baseline_accuracy: Optional[float] = None
    provenance: Dict[str, str] = dataclasses.field(default_factory=dict)


class RolloutAborted(RuntimeError):
    """A stage gate failed; every installed node was rolled back.

    Structured fields: ``slot``, ``stage``, ``reason`` and the full
    ``report`` (whose ``rolled_back``/``provenance`` record the fleet's
    retreat)."""

    def __init__(self, report: RolloutReport):
        self.report = report
        self.slot = report.slot
        self.stage = report.failed_stage
        self.reason = report.failure_reason
        super().__init__(
            f"rollout of slot {report.slot!r} aborted at stage "
            f"{report.failed_stage!r}: {report.failure_reason} — rolled "
            f"back {list(report.rolled_back) or 'nothing'}"
        )


def plan_stages(names: List[str]) -> List[Tuple[str, List[str]]]:
    """canary = first node, wave = ~half the remainder, fleet = the
    rest; empty stages are dropped (a 1-node pool is canary-only)."""
    stages = []
    if names:
        stages.append(("canary", names[:1]))
        rest = names[1:]
        n_wave = math.ceil(len(rest) / 2)
        if n_wave:
            stages.append(("wave", rest[:n_wave]))
        if rest[n_wave:]:
            stages.append(("fleet", rest[n_wave:]))
    return stages


class RolloutManager:
    def __init__(
        self,
        pool: FleetPool,
        *,
        health: Optional[FleetHealth] = None,
        gate_timeout_s: float = _DEFAULT_GATE_TIMEOUT_S,
    ):
        self.pool = pool
        # share the ROUTER's FleetHealth so a node this rollout finds
        # dead is quarantined for traffic too, not just for rollouts
        self.health = health
        self.gate_timeout_s = gate_timeout_s

    def _quarantine(self, name: str, exc: BaseException) -> None:
        if self.health is not None:
            self.health.record_failure(name, exc)
            self.health.quarantine(
                name, reason=f"died mid-rollout: {type(exc).__name__}: {exc}"
            )

    def rollout(
        self,
        slot: str,
        artifact: TMProgram,
        *,
        holdout_x: np.ndarray,
        holdout_y: Optional[np.ndarray] = None,
        min_accuracy: Optional[float] = None,
        regression_margin: float = 0.02,
        nodes: Optional[List[str]] = None,
    ) -> RolloutReport:
        """Ship ``artifact`` into ``slot`` across the pool in gated
        stages.  Targets are the nodes hosting the slot (``nodes=``
        overrides; a slot hosted nowhere targets the whole pool — a
        staged initial deploy).  Returns the completed ``RolloutReport``
        or raises ``RolloutAborted`` after the fleet-wide rollback."""
        if not isinstance(artifact, TMProgram):
            raise TypeError(
                f"rollout ships TMProgram artifacts (the checksummed wire "
                f"unit), got {type(artifact).__name__}"
            )
        holdout_x = np.asarray(holdout_x, np.uint8)
        if holdout_y is not None:
            holdout_y = np.asarray(holdout_y, np.int32)
        if nodes is not None:
            targets = [(n, self.pool.node(n)) for n in nodes]
        else:
            targets = self.pool.nodes_with_slot(slot)
            if not targets:
                targets = self.pool.items()  # staged initial deploy
        if not targets:
            raise NoEligibleNode(slot, "the pool is empty", [])

        # every target must fit the artifact BEFORE any node is touched:
        # a misfit mid-wave would strand the fleet split-brained
        for name, node in targets:
            _validate_for_node(node, artifact.model, name,
                               f"rollout of slot {slot!r}")

        report = RolloutReport(
            slot=slot, checksum=artifact.checksum, stages=[],
            completed=False,
        )
        # accuracy baseline: the CURRENT program's holdout score (first
        # hosting node's direct oracle hook — no queue traffic involved)
        floor = min_accuracy
        if holdout_y is not None and floor is None:
            hosting = self.pool.nodes_with_slot(slot)
            if hosting:
                sums = np.asarray(hosting[0][1].class_sums(slot, holdout_x))
                report.baseline_accuracy = float(
                    (sums.argmax(1) == holdout_y).mean()
                )
                floor = report.baseline_accuracy - regression_margin

        installed: List[str] = []
        reference: Optional[np.ndarray] = None
        names = [name for name, _ in targets]
        by_name = dict(targets)
        for stage, stage_names in plan_stages(names):
            t0 = time.perf_counter()
            versions = {}
            reason = None
            for name in stage_names:
                try:
                    entry = by_name[name].register(
                        slot, artifact,
                        provenance=(
                            f"rollout:{stage}:{artifact.checksum:08x}"
                        ),
                    )
                except Exception as e:
                    # a node dying (or rejecting corrupted wire bytes)
                    # mid-install is a GATE FAILURE, not an exception out
                    # of the loop: quarantine it, abort, roll back the
                    # reachable nodes
                    reason = (
                        f"node {name!r} ({stage}) failed install: "
                        f"{type(e).__name__}: {e}"
                    )
                    self._quarantine(name, e)
                    break
                installed.append(name)
                versions[name] = entry.version
            install_s = time.perf_counter() - t0

            t0 = time.perf_counter()
            checksum_ok = bit_exact = True
            accuracy: Optional[float] = None
            if reason is None:
                for name in stage_names:
                    node = by_name[name]
                    try:
                        if node.installed_checksum(slot) != artifact.checksum:
                            checksum_ok = False
                            reason = (
                                f"node {name!r} reports checksum "
                                f"{node.installed_checksum(slot)!r}, shipped "
                                f"{artifact.checksum:#x}"
                            )
                            break
                        # gate on the REAL served path, not the oracle
                        # hook: a live loop completes the handle,
                        # otherwise flush drives
                        handle = node.submit(slot, holdout_x)
                        if node.scheduler_running:
                            preds = handle.wait(timeout=self.gate_timeout_s)
                        else:
                            node.flush()
                            preds = handle.result()
                        sums = handle.class_sums
                    except Exception as e:
                        # node died mid-gate (NodeDown, a failed handle,
                        # a gate timeout): same treatment as any failed
                        # gate, plus quarantine
                        reason = (
                            f"node {name!r} ({stage}) died during the "
                            f"gate: {type(e).__name__}: {e}"
                        )
                        self._quarantine(name, e)
                        break
                    if reference is None:
                        reference = np.asarray(sums)
                    elif not np.array_equal(np.asarray(sums), reference):
                        bit_exact = False
                        reason = (
                            f"node {name!r} ({stage}) diverged from the "
                            f"canary's class sums — engines are no longer "
                            f"bit-exact"
                        )
                        break
                    if holdout_y is not None:
                        acc = float((preds == holdout_y).mean())
                        accuracy = acc if accuracy is None else min(accuracy,
                                                                    acc)
                        if floor is not None and acc < floor:
                            reason = (
                                f"node {name!r} ({stage}) holdout accuracy "
                                f"{acc:.3f} under the gate floor {floor:.3f}"
                            )
                            break
            verify_s = time.perf_counter() - t0
            passed = reason is None
            report.stages.append(StageReport(
                stage=stage, nodes=tuple(stage_names), versions=versions,
                checksum_ok=checksum_ok, bit_exact=bit_exact,
                accuracy=accuracy, passed=passed,
                install_s=install_s, verify_s=verify_s,
            ))
            if not passed:
                self._abort(report, stage, reason, installed, by_name,
                            slot)
        report.completed = True
        report.provenance = self._provenance(installed, by_name, slot)
        return report

    def _abort(self, report, stage, reason, installed, by_name, slot):
        """The fleet-wide retreat: roll back every node this rollout
        touched (drain-then-swap, provenance chains nest the attempt),
        then raise the structured ``RolloutAborted``.  A node the
        retreat cannot reach (died after install) is recorded in
        ``report.unreachable`` and quarantined — the rollback COMPLETES
        on every reachable node instead of raising out half-rolled-back."""
        rolled = []
        unreachable = []
        for name in installed:
            try:
                by_name[name].rollback(slot)
                rolled.append(name)
            except Exception as e:
                unreachable.append(name)
                self._quarantine(name, e)
        report.failed_stage = stage
        report.failure_reason = reason
        report.rolled_back = tuple(rolled)
        report.unreachable = tuple(unreachable)
        report.provenance = self._provenance(rolled, by_name, slot)
        raise RolloutAborted(report)

    @staticmethod
    def _provenance(names, by_name, slot) -> Dict[str, str]:
        """Per-node provenance audit strings, skipping nodes that cannot
        answer (the registry is an optional, best-effort window)."""
        out: Dict[str, str] = {}
        for name in names:
            try:
                node = by_name[name]
                out[name] = (
                    node.registry.get(slot).provenance
                    if hasattr(node, "registry") else ""
                )
            except Exception:
                out[name] = ""
        return out
