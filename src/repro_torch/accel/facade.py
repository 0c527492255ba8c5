"""The Accelerator façade — one public entry point for deploying and
retuning runtime-tunable TMs (MATADOR's "single automated toolchain API"
applied to our serving stack).

    # negotiate the synthesis-time envelope from the model population
    acc = Accelerator.for_models([model_a, model_b], headroom=0.5)

    # train node: compile the portable artifact and ship it
    blob = acc.compile(model_a).to_bytes()

    # serving node: load = integrity check + pure data movement
    acc.load("tenant", blob)
    preds = acc.infer("tenant", x)

    # the Fig-8 loop: retune in the field, never resynthesize
    acc.load("tenant", acc.compile(model_b), provenance="recal:drift")
    assert acc.compile_cache_size() == 1

The façade auto-selects the fastest eligible engine plugin (the popcount
engine and its Hopper kernel off-mesh, the sharded engine when a mesh is
provisioned with ``mesh=``, ``dist.make_mesh``); pass ``engine=`` to pin
one, ``engine_options=`` for per-engine knobs.  It runs on the CUDA card
unless ``device="cpu"`` is passed (or the mesh's devices are the CPU);
with no card and no ``"cpu"`` it raises rather than fall back.

Everything underneath is the serving machinery: an engine plugin
(``accel.engines``), the versioned slot registry, the priority-lane
batcher, the continuous-batching scheduler and metrics (``serve_tm``).
``start()``/``stop()`` run the scheduler loop and ``async_submit(slot, x,
priority=, timeout_ms=)`` serves admission-controlled deadline-aware
traffic without anyone calling ``flush()``.

Where the host's time goes: run ``torch.profiler`` as for a device
trace.  While it runs, the served path logs spans (the front door, each
request, each batch tiled by its lock wait, fill, launch, device wait
and demux, the loop's idle wait and its yield between batches) into
``acc.metrics``.  Afterwards ``acc.metrics.spans()`` returns them on the
``time.perf_counter_ns()`` clock, and subtracting
``acc.metrics.profiler_offset_ns()`` from a profiler event's
``start_ns()`` puts the device trace beside them::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        ...                                  # serve
    spans = acc.metrics.spans()              # numpy records, by id
    offset = acc.metrics.profiler_offset_ns()
    device = [(e.start_ns() - offset, e.end_ns() - offset)
              for e in prof.profiler.kineto_results.events()]
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np

from ..core.compress import CompressedModel
from .capacity import CapacityPlan
from .program import TMProgram


class Accelerator:
    """A deployed accelerator: negotiated capacity + one engine plugin +
    the multi-tenant serving surface (slots, batching, hot-swap,
    rollback)."""

    def __init__(
        self,
        plan: Optional[CapacityPlan] = None,
        *,
        engine: Optional[str] = None,
        mesh=None,
        device=None,
        engine_options: Optional[dict] = None,
        history_depth: int = 4,
    ):
        # deferred: serve_tm.server imports accel.engine — importing it at
        # module scope would cycle through the package inits
        from ..serve_tm.server import TMServer

        self.plan = plan if plan is not None else CapacityPlan()
        # engine selection/construction is the serving node's job (the
        # ServingNode boundary): TMServer runs select_engine/make_engine
        self.server = TMServer(
            self.plan, engine=engine, mesh=mesh, device=device,
            engine_options=engine_options, history_depth=history_depth,
        )
        self.engine = self.server.executor

    @classmethod
    def for_models(
        cls,
        models: Iterable[CompressedModel],
        *,
        headroom: float = 0.0,
        batch_words: int = 4,
        engine: Optional[str] = None,
        mesh=None,
        device=None,
        engine_options: Optional[dict] = None,
        history_depth: int = 4,
    ) -> "Accelerator":
        """Capacity-negotiated construction: derive the minimal quantized
        envelope for ``models`` (see ``CapacityPlan.for_models``) and
        deploy an engine at that shape."""
        plan = CapacityPlan.for_models(
            models, headroom=headroom, batch_words=batch_words
        )
        return cls(
            plan, engine=engine, mesh=mesh, device=device,
            engine_options=engine_options,
            history_depth=history_depth,
        )

    # -- the deployment artifact path ---------------------------------------

    def compile(self, model: CompressedModel) -> TMProgram:
        """Model -> portable ``TMProgram`` artifact, stamped with this
        accelerator's capacity envelope.  Raises ``CapacityExceeded`` when
        the model doesn't fit the deployed engine's buffers — the EXACT
        check ``load`` will repeat, so compile-time is where a misfit
        surfaces, not the serving node's load path.  (Load revalidates by
        design: artifacts routinely cross process/node boundaries, so the
        one extra host-side stream decode per publication is the price of
        never trusting the wire.)"""
        self.engine.validate_model(model)
        return TMProgram(capacity=self.plan, model=model)

    def load(
        self,
        slot: str,
        artifact: "TMProgram | bytes | CompressedModel",
        provenance: str = "load",
    ):
        """Install an artifact (or raw ``to_bytes()`` blob, or a bare
        model) into ``slot`` — integrity-checked, capacity-validated, then
        pure data movement with the usual drain-then-swap discipline."""
        return self.server.register(slot, artifact, provenance=provenance)

    # -- serving delegation (the façade IS a TMServer-shaped object) ---------

    def register(self, slot, model, provenance: str = "install"):
        return self.server.register(slot, model, provenance=provenance)

    def rollback(self, slot: str):
        return self.server.rollback(slot)

    def submit(self, slot: str, x: np.ndarray, **kw):
        return self.server.submit(slot, x, **kw)

    async def async_submit(self, slot: str, x: np.ndarray, **kw):
        """Admission-controlled submit for async callers (priority lanes,
        deadlines); requires the scheduler loop (``start()``)."""
        return await self.server.async_submit(slot, x, **kw)

    def start(self) -> None:
        """Start the continuous-batching scheduler loop."""
        self.server.start()

    def stop(self, drain: bool = True) -> None:
        self.server.stop(drain=drain)

    @property
    def scheduler_running(self) -> bool:
        return self.server.scheduler_running

    def flush(self) -> None:
        self.server.flush()

    def infer(self, slot: str, x: np.ndarray) -> np.ndarray:
        return self.server.infer(slot, x)

    def class_sums(self, slot: str, x: np.ndarray) -> np.ndarray:
        return self.server.class_sums(slot, x)

    def compile_cache_size(self) -> int:
        return self.server.compile_cache_size()

    # -- the ServingNode boundary (fleet/recal operate on this surface) ------

    def validate_model(self, model) -> None:
        """The exact will-it-fit check this node's engine applies on
        install (raises ``CapacityExceeded``)."""
        self.server.validate_model(model)

    def queue_depth(self, slot=None, priority=None) -> int:
        return self.server.queue_depth(slot, priority)

    def metrics_snapshot(self) -> dict:
        return self.server.metrics_snapshot()

    def installed_checksum(self, slot: str):
        return self.server.installed_checksum(slot)

    def installed_artifact(self, slot: str):
        return self.server.installed_artifact(slot)

    @property
    def capacity(self) -> CapacityPlan:
        return self.plan

    @property
    def registry(self):
        return self.server.registry

    @property
    def metrics(self):
        return self.server.metrics

    def slots(self) -> Sequence[str]:
        return self.server.registry.names()

    def __repr__(self) -> str:
        return (
            f"Accelerator(engine={self.engine.name!r}, "
            f"device={str(self.engine.device)!r}, plan={self.plan.as_dict()})"
        )
