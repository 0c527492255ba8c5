"""Multi-tenant, dynamically-batched TM serving over the runtime-tunable
accelerator (the ROADMAP's "serve heavy traffic" north star applied to the
paper's Fig-4/Fig-8 engine).

    server = TMServer(CapacityPlan(...))     # the card; device="cpu" to opt out
    server.register("gas", model)            # program a named slot
    h = server.submit("gas", x)              # queue {0,1}[b, F] datapoints
    server.flush()                           # batch + run + demux
    preds = h.result()

    # or scheduler-owned continuous batching (the async front door):
    server.start()                           # flush loop runs itself
    h = await server.async_submit("gas", x, priority="critical",
                                  timeout_ms=50)
    preds = await h.async_result()
    server.stop()

New deployments should prefer the ``repro_torch.accel.Accelerator`` façade,
which negotiates capacity from the model population and adds the
portable ``TMProgram`` artifact path; ``TMServer`` remains the serving
core underneath it.  Engines come from the ``repro_torch.accel`` plugin
registry: pass ``backend=<name>`` to pin one, a built engine via
``engine=``, or neither to auto-select the fastest eligible plugin
(``mesh=`` makes the mesh engines the eligible set and is forwarded to
the one chosen).  The engine runs on ``device`` (see
``repro_torch.device.resolve_device``): the CUDA card unless the caller
passes ``device="cpu"``; a mesh engine runs on its mesh's devices.

Tenancy: each slot is one model; requests are batched PER SLOT (models
cannot share an engine pass) but all slots share the single compiled
engine — the multi-tenant generalization of the paper's one-engine-many-
models claim.  ``register`` on a live slot is the hot-swap/recalibration
path: queued traffic for that slot is drained under the OLD program first,
then the new model is installed; the engine is never recompiled, and
every scheduler-formed batch asserts ``compile_cache_size() == 1``.
``register`` also accepts a ``TMProgram`` artifact or its serialized
bytes (reprogram-over-the-wire).

Control flow: batch formation and execution are OWNED by the
``Scheduler`` (serve_tm/scheduler.py).  Without ``start()`` nothing
changes for callers — ``flush()`` drives the scheduler's batch body
synchronously, exactly the old semantics.  With ``start()`` a
continuous-batching asyncio loop forms batches itself (priority lanes,
EDF, deadline shedding, admission control); the sync API keeps working
and serializes against the loop through the scheduler's lock, and
hot-swap/rollback hold that lock across drain + install so in-flight
traffic always completes under the program it was submitted against.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Optional

import numpy as np

from ..accel.capacity import CapacityPlan
from ..accel.engine import EngineBase, make_engine, select_engine
from .batching import RequestHandle
from .metrics import ServeMetrics, Span, stamp, torch_profiler
from .registry import DEFAULT_HISTORY_DEPTH, Installable, ModelRegistry, SlotEntry
from .scheduler import Scheduler


class TMServer:
    def __init__(
        self,
        capacity: Optional[CapacityPlan] = None,
        backend: "Optional[str | EngineBase]" = None,
        mesh=None,
        *,
        engine: "Optional[str | EngineBase]" = None,
        engine_options: Optional[dict] = None,
        device=None,
        history_depth: int = DEFAULT_HISTORY_DEPTH,
        max_wait_ms: float = 2.0,
        lane_depth_rows: Optional[Dict[str, int]] = None,
    ):
        from .batching import Batcher  # deferred: keep import cycle simple

        self.capacity = capacity if capacity is not None else CapacityPlan()
        chosen = engine if engine is not None else backend
        if chosen is None:
            chosen = select_engine(self.capacity, mesh=mesh)
        self.executor = make_engine(
            chosen, self.capacity, mesh=mesh, device=device,
            **(engine_options or {})
        )
        self.registry = ModelRegistry(
            self.executor, history_depth=history_depth
        )
        self.batcher = Batcher(self.capacity.batch_capacity)
        self.metrics = ServeMetrics()
        self.scheduler = Scheduler(
            self, max_wait_ms=max_wait_ms, lane_depth_rows=lane_depth_rows
        )
        # itertools.count.__next__ is atomic in CPython: concurrent
        # submits (loop thread + N callers) never mint duplicate rids
        self._rid = itertools.count()

    # -- the continuous-batching lifecycle -----------------------------------

    def start(self) -> None:
        """Start the scheduler's continuous-batching loop (idempotent).
        Submitted requests are served without anyone calling flush()."""
        self.scheduler.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the loop; queued traffic is drained synchronously first
        (``drain=False`` strands it for a later flush())."""
        self.scheduler.stop(drain=drain)

    @property
    def scheduler_running(self) -> bool:
        return self.scheduler.running

    # -- programming (the Fig-8 reprogram/recalibration path) ---------------

    def register(
        self,
        slot: str,
        model: Installable,
        provenance: str = "install",
    ) -> SlotEntry:
        """Install ``model`` into ``slot``; hot-swaps live slots.

        ``model`` may be a ``CompressedModel``, a ``TMProgram`` artifact,
        or artifact bytes fresh off the wire.  Traffic already queued for
        the slot is drained under the OLD program first (in-flight
        requests keep the model they were submitted against), then the
        swap is pure data movement.  The scheduler lock is held across
        drain + install, so a running loop can never interleave a
        new-program batch into the drain.  ``provenance`` records who
        produced the model (e.g. the recal pipeline tags its swaps
        ``recal:<reason>``).
        """
        with self.scheduler.lock:
            if slot in self.registry and self.batcher.pending_rows(slot):
                self.scheduler.drain_slot(slot)
            t0 = time.perf_counter()
            entry = self.registry.install(slot, model, provenance=provenance)
            self.metrics.record_swap(time.perf_counter() - t0)
            return entry

    def rollback(self, slot: str) -> SlotEntry:
        """Reinstall ``slot``'s previous model (recal safety net).

        Same drain discipline as ``register``: queued traffic finishes
        under the CURRENT program, then the previous entry's programmed
        buffers are swapped back in verbatim.
        """
        with self.scheduler.lock:
            if self.batcher.pending_rows(slot):
                self.scheduler.drain_slot(slot)
            t0 = time.perf_counter()
            entry = self.registry.rollback(slot)
            self.metrics.record_swap(time.perf_counter() - t0)
            self.metrics.record_rollback()
            return entry

    # -- traffic -------------------------------------------------------------

    def _make_handle(
        self,
        slot: str,
        x: np.ndarray,
        priority: str,
        timeout_ms: Optional[float],
    ) -> "tuple[RequestHandle, np.ndarray]":
        entry = self.registry.get(slot)
        x = np.asarray(x, dtype=np.uint8)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[0] == 0:
            raise ValueError(f"expected {{0,1}}[b, F] features, got {x.shape}")
        if x.shape[1] != entry.n_features:
            raise ValueError(
                f"request has {x.shape[1]} features; slot {slot!r} v"
                f"{entry.version} expects {entry.n_features}"
            )
        if x.max(initial=0) > 1:
            raise ValueError("features must be Boolean {0,1}")
        deadline = None
        if timeout_ms is not None:
            deadline = time.perf_counter() + timeout_ms / 1e3
        handle = RequestHandle(
            next(self._rid), slot, x.shape[0],
            priority=priority, deadline=deadline,
        )
        handle.driver = (
            "scheduler" if self.scheduler.running else "flush"
        )
        return handle, x

    def submit(
        self,
        slot: str,
        x: np.ndarray,
        *,
        priority: str = "normal",
        timeout_ms: Optional[float] = None,
    ) -> RequestHandle:
        """Queue {0,1}[b, F] (or [F]) datapoints against ``slot``.

        With a running scheduler the request is served by the loop (no
        flush() needed — block on ``handle.wait()`` or await
        ``handle.async_result()``); otherwise it waits for the next
        flush().  ``priority`` picks the lane, ``timeout_ms`` stamps a
        deadline after which the request is shed instead of served.

        ``enqueue`` is internally serialized against the scheduler
        loop's batch formation (the batcher lock), so callers may submit
        from any thread while the loop runs.  While a profile runs, the
        call logs its ``front_door`` span."""
        entered = stamp() if torch_profiler._is_profiler_enabled else None
        handle, x = self._make_handle(slot, x, priority, timeout_ms)
        self.batcher.enqueue(handle, x)
        if self.scheduler.running:
            self.scheduler.wake()
        if entered is not None:
            self._record_front_door(entered, handle)
        return handle

    async def async_submit(
        self,
        slot: str,
        x: np.ndarray,
        *,
        priority: str = "normal",
        timeout_ms: Optional[float] = None,
    ) -> RequestHandle:
        """Admission-controlled submit for async callers.

        Raises the structured ``Overloaded`` when the (slot, lane) queue
        depth budget is exhausted — under sustained overload the low
        lanes reject first.  The depth check and the enqueue are one
        atomic section (batcher lock), so concurrent submitters cannot
        collectively exceed the lane budget.  Await the returned
        handle's ``async_result()`` for completion.  While a profile
        runs, the call logs its ``front_door`` span."""
        entered = stamp() if torch_profiler._is_profiler_enabled else None
        handle, xv = self._make_handle(slot, x, priority, timeout_ms)
        self.scheduler.admit_and_enqueue(handle, xv)
        if self.scheduler.running:
            self.scheduler.wake()
        if entered is not None:
            self._record_front_door(entered, handle)
        return handle

    def _record_front_door(self, entered, handle: RequestHandle) -> None:
        self.metrics.record_span(
            Span.FRONT_DOOR, entered, stamp(), tag=handle.rid,
            arg=handle.n_rows,
        )

    def flush(self) -> None:
        """Drain every slot's queue through the engine (the sync driver;
        a running scheduler loop makes this a no-op-ish safety valve —
        both drive the same scheduler batch body under one lock)."""
        self.scheduler.drain_all()

    def infer(self, slot: str, x: np.ndarray) -> np.ndarray:
        """Synchronous convenience: submit + drain -> int32[b] predictions."""
        handle = self.submit(slot, x)
        self.scheduler.drain_slot(slot)
        return handle.result()

    def class_sums(self, slot: str, x: np.ndarray) -> np.ndarray:
        """Direct (unbatched-queue) class sums for ``x`` — the oracle hook
        tests use for bit-exactness; does not touch the request queue."""
        entry = self.registry.get(slot)
        return self.executor.class_sums(entry.program, np.asarray(x, np.uint8))

    # -- the ServingNode boundary (what fleets/recal loops operate on) -------

    def slots(self) -> "list[str]":
        return self.registry.names()

    def validate_model(self, model) -> None:
        """The exact will-it-fit check this node's engine applies on
        install (raises ``CapacityExceeded``) — the node-boundary gate a
        publication/rollout runs so a passed artifact can never crash the
        hot-swap."""
        self.executor.validate_model(model)

    def queue_depth(
        self, slot: Optional[str] = None, priority: Optional[str] = None
    ) -> int:
        """Pending rows queued on this node (the router's load signal).
        ``slot``/``priority`` narrow the count; None sums everything."""
        if slot is not None:
            return self.batcher.pending_rows(slot, priority)
        return sum(
            self.batcher.pending_rows(s, priority)
            for s in self.batcher.pending_slots()
        )

    def metrics_snapshot(self) -> dict:
        """The per-lane ``ServeMetrics.summary()`` dict (schema pinned by
        serve_tm/schema.py) — what a fleet aggregates across nodes."""
        return self.metrics.summary()

    def installed_checksum(self, slot: str) -> Optional[int]:
        """CRC-32 of the artifact ``slot`` is running (None when the slot
        was programmed from a bare model rather than a ``TMProgram``).
        Rollout gating audits this against the shipped artifact."""
        artifact = self.registry.get(slot).artifact
        return None if artifact is None else artifact.checksum

    def installed_artifact(self, slot: str):
        """The ``TMProgram`` artifact ``slot`` is running, if it was
        installed from one (hot-slot replication re-ships it)."""
        return self.registry.get(slot).artifact

    # -- internals -----------------------------------------------------------

    def compile_cache_size(self) -> int:
        """# kernel operand signatures of this server's engine (must stay
        1)."""
        return self.executor.compile_cache_size()

    def _check_no_recompile(self) -> None:
        n = self.compile_cache_size()
        if n > 1:
            raise RuntimeError(
                f"engine recompiled: {n} compiled variants (expected 1) — "
                f"a model swap must be pure data movement"
            )
