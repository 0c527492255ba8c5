"""The TrainEngine plugin protocol and registry, the port of
``repro.recal.train_engine``.

Where an inference engine is one realization of the runtime-tunable
accelerator, a train engine is one realization of the Fig-8 training
node.  Every plugin honours one contract, built on the fold-in seeding
contract of ``core.train``:

  ``prepare(state)``        canonical ``int32[M, C, 2F]`` TA state (a
                            tensor or numpy array) -> the engine's
                            internal representation on its device (the
                            packed engine keeps int8 across steps; the
                            reference engine is a copy)
  ``canonical(internal)``   internal -> canonical int32 state
  ``fit_step(internal, key, xb, yb, step=)``
                            one resumable update: the batch trains under
                            ``fold_in(key, step)``, sample ``i`` under
                            ``fold_in(call_key, i)``.  Every registered
                            engine gives the BIT-IDENTICAL canonical state
                            for the same (key, step, batch), and so does
                            the reference package's engine.

``@register_train_engine`` stamps ``needs_mesh`` and ``priority``;
``supports(cfg)`` narrows a class to the configs its representation
holds.  ``make_train_engine(name, cfg, *, mesh=None, plan=None,
device=None, **options)`` builds one, forwarding the mesh only to
``needs_mesh`` engines (the ``sharded`` engine, ``dist.steps``).
Engines run on ``device``: the CUDA card unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``); the sharded
engine runs on its mesh's devices.  ``plan`` opts every engine into the
negotiated ``CapacityPlan`` batch envelope (``CapacityExceeded``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from ..core.tm import TMConfig
from ..core.train import fit_step as _core_fit_step
from ..core.train import validate_batch_capacity
from ..core import prng
from ..device import resolve_device
from ..dist.sharding import make_mesh
from ..dist.steps import make_tm_train_step
from ..kernels.tm_train import (
    fused_fit_step,
    pack_ta_state,
    supports_packed_states,
    unpack_ta_state,
)

# name -> engine class; populated by @register_train_engine
TRAIN_ENGINES: Dict[str, type] = {}


@runtime_checkable
class TrainEngine(Protocol):
    """Structural type of a training backend (see module docstring)."""

    name: str
    needs_mesh: bool
    priority: int
    cfg: TMConfig

    def prepare(self, state) -> Any: ...

    def canonical(self, internal) -> torch.Tensor: ...

    def fit_step(self, internal, key, xb, yb, *, step: int) -> Any: ...


def register_train_engine(
    name: str, *, needs_mesh: bool = False, priority: int = 0
):
    """Class decorator registering a train-engine plugin under ``name``
    and stamping its capability flags.  Re-registering a taken name
    raises: auto-selection must be deterministic."""

    def deco(cls):
        if name in TRAIN_ENGINES and TRAIN_ENGINES[name] is not cls:
            raise ValueError(
                f"train engine name {name!r} already registered to "
                f"{TRAIN_ENGINES[name].__name__}"
            )
        cls.name = name
        cls.needs_mesh = bool(needs_mesh)
        cls.priority = int(priority)
        TRAIN_ENGINES[name] = cls
        return cls

    return deco


def train_engine_names() -> list:
    return sorted(TRAIN_ENGINES)


def select_train_engine(
    cfg: Optional[TMConfig] = None, *, mesh=None
) -> str:
    """Deterministically pick the fastest eligible train engine name.

    With a mesh, mesh-consuming engines are the eligible set; without
    one, the fastest mesh-free engine that ``supports(cfg)`` wins.  Ties
    break lexicographically."""
    eligible = [
        c
        for c in TRAIN_ENGINES.values()
        if c.needs_mesh == (mesh is not None)
        and (cfg is None or c.supports(cfg))
    ]
    if not eligible:
        raise ValueError(
            f"no eligible train engine "
            f"(mesh={'yes' if mesh is not None else 'no'}; "
            f"registered: {train_engine_names() or 'none'})"
        )
    return max(eligible, key=lambda c: (c.priority, c.name)).name


def make_train_engine(
    engine: "str | TrainEngineBase",
    cfg: TMConfig,
    *,
    mesh=None,
    plan=None,
    device=None,
    **options,
) -> "TrainEngineBase":
    """Uniform plugin construction: name (or a built instance) -> engine
    on ``device``.  ``options`` go to the engine verbatim; the mesh is
    forwarded only to engines that declare ``needs_mesh``."""
    if isinstance(engine, TrainEngineBase):
        return engine
    if engine not in TRAIN_ENGINES:
        raise ValueError(
            f"unknown train engine {engine!r}; registered: "
            f"{train_engine_names()}"
        )
    cls = TRAIN_ENGINES[engine]
    if cls.needs_mesh and mesh is not None:
        options = {**options, "mesh": mesh}
    return cls(cfg, plan=plan, device=device, **options)


class TrainEngineBase:
    """Shared train-engine mechanics: the device, batch-envelope
    validation and the canonical-representation hooks."""

    name = "?"
    needs_mesh = False
    priority = 0

    def __init__(self, cfg: TMConfig, *, plan=None, device=None):
        self.cfg = cfg
        self.plan = plan
        self.device = resolve_device(device)

    @classmethod
    def supports(cls, cfg: TMConfig) -> bool:
        """Whether this engine's representation can hold ``cfg``."""
        return True

    def _on_device(self, x, dtype) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x, dtype))
        return x.to(self.device)

    # -- representation ------------------------------------------------------

    def prepare(self, state) -> Any:
        """Canonical int32 state -> engine-internal representation, always
        a fresh buffer on the engine's device."""
        return self._on_device(state, np.int32).to(torch.int32, copy=True)

    def canonical(self, internal) -> torch.Tensor:
        """Engine-internal representation -> canonical int32 state."""
        return internal

    # -- the step ------------------------------------------------------------

    def fit_step(self, internal, key, xb, yb, *, step: int) -> Any:
        """One resumable update under the fold-in seeding contract.
        Validates the negotiated batch envelope (when a plan was given),
        moves the batch to the engine's device, then runs the engine's
        ``_fit_step``."""
        validate_batch_capacity(xb.shape[0], self.plan)
        xb = self._on_device(xb, np.uint8)
        yb = self._on_device(yb, np.int32)
        return self._fit_step(internal, key, xb, yb, step=step)

    def _fit_step(self, internal, key, xb, yb, *, step: int) -> Any:
        raise NotImplementedError


@register_train_engine("reference", priority=1)
class ReferenceTrainEngine(TrainEngineBase):
    """``core.train.fit_step`` on the canonical int32 state, in plain
    PyTorch on the engine's device.  ``parallel=True`` (summed-delta) is
    the default, the semantics every other engine is bit-identical to;
    ``parallel=False`` runs the sequential online scan."""

    def __init__(self, cfg: TMConfig, *, plan=None, device=None,
                 parallel: bool = True):
        super().__init__(cfg, plan=plan, device=device)
        self.parallel = bool(parallel)

    def _fit_step(self, internal, key, xb, yb, *, step: int):
        return _core_fit_step(
            self.cfg, internal, key, xb, yb, step=step, parallel=self.parallel,
        )


@register_train_engine("packed", priority=2)
class PackedTrainEngine(TrainEngineBase):
    """The fused packed-TA path (``kernels.tm_train``): int8 states in the
    flat (clauses, literals, 2) layout that persist across steps; on the
    card each step is the ``clause_eval`` and ``tm_train`` kernels.
    Conversion happens only at the ``prepare``/``canonical`` boundary."""

    def __init__(self, cfg: TMConfig, *, plan=None, device=None):
        if not supports_packed_states(cfg):
            raise ValueError(
                f"n_states={cfg.n_states} exceeds the packed int8 TA "
                f"range (<= 128); use the 'reference' train engine for "
                f"this config"
            )
        super().__init__(cfg, plan=plan, device=device)

    @classmethod
    def supports(cls, cfg: TMConfig) -> bool:
        return supports_packed_states(cfg)

    def prepare(self, state) -> torch.Tensor:
        return pack_ta_state(self.cfg, super().prepare(state)).contiguous()

    def canonical(self, internal) -> torch.Tensor:
        return unpack_ta_state(self.cfg, internal)

    def _fit_step(self, internal, key, xb, yb, *, step: int):
        return fused_fit_step(self.cfg, internal, key, xb, yb, step=step)


@register_train_engine("sharded", needs_mesh=True, priority=1)
class ShardedTrainEngine(TrainEngineBase):
    """The class-sharded step of ``dist.steps.make_tm_train_step``:
    classes over ``model``, batch over the data axes, integer deltas
    summed per class slice; bit-identical to the reference on any mesh.
    Its internal state is the tuple of class slices, each on its home
    device between steps.

    The step is built for ONE batch size: ``batch`` pins it at
    construction; otherwise it binds to the first batch seen.  Other
    batch sizes fall back to the reference path (bit-identical anyway).
    The default mesh is (1, 1) on ``device``."""

    def __init__(self, cfg: TMConfig, *, mesh=None, plan=None, device=None,
                 batch: int = 0):
        if mesh is None:
            mesh = make_mesh((1, 1), devices=resolve_device(device))
        elif device is not None and resolve_device(device) != mesh.first_device:
            raise ValueError(
                f"device {device} is not the mesh's first device "
                f"{mesh.first_device}; a mesh engine runs where its mesh is"
            )
        super().__init__(cfg, plan=plan, device=mesh.first_device)
        self.mesh = mesh
        # the class split is fixed by the mesh (a model axis that does not
        # divide n_classes raises here); 0 leaves the batch to the first
        # step, the slices' homes do not depend on it
        self._batch = int(batch)
        self._step = make_tm_train_step(cfg, mesh, batch=self._batch or 1)

    def prepare(self, state) -> tuple:
        return self._step.split(self._on_device(state, np.int32))

    def canonical(self, internal) -> torch.Tensor:
        return self._step.join(internal, self.device)

    def _fit_step(self, internal, key, xb, yb, *, step: int):
        if not self._batch:
            self._batch = int(xb.shape[0])
            self._step = make_tm_train_step(self.cfg, self.mesh, batch=self._batch)
        if xb.shape[0] == self._batch:
            # same bits as the local path: fold_in(key, step) is the call
            # key, global sample i trains under fold_in(call_key, i)
            return self._step.step_slices(
                internal, prng.fold_in(key, step), xb, yb
            )
        state = _core_fit_step(
            self.cfg, self.canonical(internal), key, xb, yb, step=step,
            parallel=True,
        )
        return self._step.split(state)
