"""The Engine plugin protocol + registry of the port.

An *engine* is one realization of the runtime-tunable accelerator: a
fixed-capacity program store that models are programmed INTO (pure data
movement) rather than compiled FOR.  Every engine honours one contract:

  ``program(model)``        host-side reprogram: decode the compressed
                            model into the engine's fixed-capacity
                            buffers on its device.  The base class runs
                            capacity validation (``CapacityExceeded``)
                            before the engine-specific ``_program``.
  ``class_sums(prog, x)``   {0,1}[B, F] -> numpy int32[B, n_classes]
  ``compile_cache_size()``  distinct (shape, dtype) operand signatures
                            this engine has launched its kernel with —
                            the zero-resynthesis property; must stay 1
                            across model swaps at one ``CapacityPlan``.
  ``staging``               the numpy view of the engine's preallocated
                            [batch_capacity, feature_capacity] uint8
                            staging tensor (pinned when the engine runs
                            on CUDA); the batcher packs request rows
                            straight into it (``Batcher.next_batch(out=)``).

``@register_engine(name, needs_mesh=, priority=)`` registers a plugin;
``select_engine(plan, mesh=)`` picks the highest priority among the
engines eligible for that mesh (with a mesh, only ``needs_mesh`` engines;
without, only the others); ``make_engine(name, plan, mesh=, device=)``
builds one, forwarding the mesh only to ``needs_mesh`` engines.  Engines
run on the CUDA card unless ``device="cpu"`` is passed
(``repro_torch.device.resolve_device``); a mesh engine runs on its mesh's
devices (``dist.make_mesh``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..core.compress import decode_to_plan
from ..device import resolve_device
from .capacity import CapacityExceeded, CapacityPlan

# name -> engine class; populated by @register_engine (engines.py registers
# the built-ins on import)
ENGINES: Dict[str, type] = {}


@runtime_checkable
class Engine(Protocol):
    """Structural type of an accelerator engine (see module docstring)."""

    name: str
    needs_mesh: bool
    priority: int
    validated_knobs: tuple
    plan: CapacityPlan
    device: torch.device

    def program(self, model) -> Dict[str, Any]: ...

    def class_sums(self, prog: Dict[str, Any], x: np.ndarray) -> np.ndarray: ...

    def compile_cache_size(self) -> int: ...


def register_engine(name: str, *, needs_mesh: bool = False, priority: int = 0):
    """Class decorator registering an engine plugin under ``name`` and
    stamping its capability flags (``needs_mesh``: the engine consumes a
    device mesh).  Re-registering a taken name raises, so auto-selection
    stays deterministic."""

    def deco(cls):
        if name in ENGINES and ENGINES[name] is not cls:
            raise ValueError(
                f"engine name {name!r} already registered to "
                f"{ENGINES[name].__name__}"
            )
        cls.name = name
        cls.needs_mesh = bool(needs_mesh)
        cls.priority = int(priority)
        ENGINES[name] = cls
        return cls

    return deco


def engine_names() -> list:
    return sorted(ENGINES)


def select_engine(plan: Optional[CapacityPlan] = None, *, mesh=None) -> str:
    """Deterministically pick the fastest eligible engine name.

    With a mesh, mesh-consuming engines (``needs_mesh``) are the eligible
    set; without one, the fastest mesh-free engine wins.  Ties break
    lexicographically.  ``plan`` is part of the contract for plugins whose
    eligibility depends on the capacity point."""
    eligible = [c for c in ENGINES.values() if c.needs_mesh == (mesh is not None)]
    if not eligible:
        raise ValueError(
            f"no eligible engine (mesh={'yes' if mesh is not None else 'no'}; "
            f"registered: {engine_names() or 'none'})"
        )
    return max(eligible, key=lambda c: (c.priority, c.name)).name


def make_engine(
    engine: "str | EngineBase", plan: CapacityPlan, *, mesh=None, device=None,
    **options,
) -> "EngineBase":
    """Name (or a built instance) -> engine on ``device`` (the CUDA card
    unless ``device="cpu"``).  ``options`` go to the engine verbatim; the
    mesh is forwarded only to engines that declare ``needs_mesh``."""
    if isinstance(engine, EngineBase):
        return engine
    if engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; registered: {engine_names()}"
        )
    cls = ENGINES[engine]
    if cls.needs_mesh and mesh is not None:
        options = {**options, "mesh": mesh}
    return cls(plan, device=device, **options)


class EngineBase:
    """Shared engine mechanics: device placement, capacity validation,
    the staging tensor and the operand-signature count."""

    name = "?"
    needs_mesh = False
    priority = 0
    # which plan buffers this engine's layout instantiates
    validated_knobs: tuple = CapacityPlan.KNOBS
    # what instruction_capacity must hold for THIS layout: "stream" = the
    # full uint16 stream; "includes" = only the include slots (boundary
    # EXTENDs never materialize in the decoded operand vectors)
    instruction_metric = "stream"
    # engines whose reprogram consumes the DecodedPlan set this; the base
    # decodes the stream once and shares it between validation and _program
    needs_decoded_plan = False
    # a caller that times the device wait (the scheduler, while a profile
    # runs) puts a list here; ``_to_host`` appends the stamp at which the
    # wait began
    sync_marks: Optional[list] = None

    def __init__(self, plan: CapacityPlan, device=None):
        self.plan = plan
        self.device = resolve_device(device)
        self._staging_t: Optional[torch.Tensor] = None
        self._staging: Optional[np.ndarray] = None
        self._staging_dev: Optional[torch.Tensor] = None
        self._signatures: set = set()

    def on_device(self):
        """Context that makes the engine's CUDA device current (the
        scheduler calls engines from its own thread)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def model_violations(self, model, decoded=None) -> list:
        """``(knob, required, provided)`` for every buffer of THIS layout
        the model blows through, honouring ``instruction_metric``."""
        knobs = list(self.validated_knobs)
        metric_is_includes = (
            "instruction_capacity" in knobs
            and self.instruction_metric == "includes"
        )
        if metric_is_includes:
            knobs.remove("instruction_capacity")
        if decoded is None and (
            metric_is_includes
            or set(knobs) & {"clause_capacity", "include_capacity"}
        ):
            decoded = decode_to_plan(model)
        bad = self.plan.violations(model, knobs, decoded)
        if metric_is_includes and (
            decoded.n_includes > self.plan.instruction_capacity
        ):
            bad.insert(0, (
                "instruction_capacity", decoded.n_includes,
                self.plan.instruction_capacity,
            ))
        return bad

    def validate_model(self, model, decoded=None) -> None:
        """Raise ``CapacityExceeded`` when ``model`` doesn't fit this
        engine's buffers (the exact check the load path repeats)."""
        bad = self.model_violations(model, decoded)
        if bad:
            raise CapacityExceeded(*bad[0])

    def program(self, model) -> Dict[str, Any]:
        """Validate ``model`` against this engine's buffers, then run the
        engine-specific reprogram (pure data movement)."""
        decoded = decode_to_plan(model) if self.needs_decoded_plan else None
        self.validate_model(model, decoded)
        with self.on_device():
            return self._program(model, decoded)

    def _program(self, model, decoded) -> Dict[str, Any]:
        raise NotImplementedError

    def class_sums(self, prog: Dict[str, Any], x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _to_host(self, sums: torch.Tensor) -> np.ndarray:
        """The engine's result on the host.  The copy waits for the
        device, so the launches end and the wait begins here."""
        marks = self.sync_marks
        if marks is not None:
            marks.append((time.perf_counter_ns(), time.thread_time_ns()))
        return sums.cpu().numpy()

    def compile_cache_size(self) -> int:
        return len(self._signatures)

    def _record_signature(self, *tensors: torch.Tensor) -> None:
        self._signatures.add(
            tuple((tuple(t.shape), t.dtype) for t in tensors)
        )

    @property
    def staging_tensor(self) -> torch.Tensor:
        """The preallocated [batch_capacity, feature_capacity] uint8 host
        tensor (pinned for a CUDA engine, so its copy can be async)."""
        if self._staging_t is None:
            p = self.plan
            self._staging_t = torch.zeros(
                (p.batch_capacity, p.feature_capacity), dtype=torch.uint8,
                pin_memory=self.device.type == "cuda",
            )
        return self._staging_t

    def staged_on_device(self) -> torch.Tensor:
        """The staging block on the engine's device: on CUDA copied into a
        preallocated device buffer without blocking (the tensor is pinned;
        the caller's device-to-host copy of its result waits for it, so
        the block is free again when the engine call returns)."""
        staged = self.staging_tensor
        if self.device.type != "cuda":
            return staged
        if self._staging_dev is None:
            self._staging_dev = torch.empty_like(staged, device=self.device)
        return self._staging_dev.copy_(staged, non_blocking=True)

    @property
    def staging(self) -> np.ndarray:
        """Numpy view of ``staging_tensor``: the batcher packs request rows
        straight into it and the engines consume it as their one fixed
        operand shape — no per-flush host allocation."""
        if self._staging is None:
            self._staging = self.staging_tensor.numpy()
        return self._staging

    def _pad_x(self, x: np.ndarray) -> np.ndarray:
        """{0,1}[B, F] -> the staging array (zero-padded to capacity).

        When ``x`` is already a leading view of ``self.staging`` (the
        batcher packed it there), it is returned as-is — zero copies."""
        p = self.plan
        B, F = x.shape
        if B > p.batch_capacity:
            raise CapacityExceeded(
                "batch_words", -(-B // 32), p.batch_words, "batch"
            )
        if F > p.feature_capacity:
            raise CapacityExceeded(
                "feature_capacity", F, p.feature_capacity, "n_features"
            )
        st = self.staging
        if np.shares_memory(x, st):
            if (x.__array_interface__["data"][0]
                    == st.__array_interface__["data"][0]):
                # a leading view — the batcher packed rows [0, B) in place
                # and zeroed the remainder (next_batch(out=) contract)
                return st
            # any other overlapping view would be corrupted by the zero
            # fill below; detach it first
            x = np.array(x)
        st.fill(0)
        st[:B, :F] = x
        return st
