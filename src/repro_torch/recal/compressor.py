"""Trained TA state -> validated ``CompressedModel`` (WHAT gets shipped),
the port of ``repro.recal.compressor``.

Encoding is the cheap part; the point of this class is the publication
gate: before a stream may be hot-swapped into a live accelerator it is
decoded back and checked bit-exact against the dense oracle
(``core.compress.validate_roundtrip``) on a deterministic probe batch
plus, optionally, a sample of real traffic.  A model that fails the gate
never reaches the registry.

With a ``CapacityPlan`` the gate also covers the deployment envelope:
the model must FIT the plan (``CapacityExceeded`` otherwise), and the
report carries the stamped, checksummed ``TMProgram`` artifact, byte
for byte the reference's for the same state.  The include actions are
computed on the state's device and brought to the host once; the rest
is numpy, except a prune policy's ranked pass, which runs on the state's
device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..accel.capacity import CapacityPlan
from ..accel.program import TMProgram
from ..core.compress import CompressedModel, encode, validate_roundtrip
from ..core.tm import TMConfig, include_actions
from ..prune import PrunePolicy, PruneReport


@dataclasses.dataclass(frozen=True)
class CompressionReport:
    """What the compressor hands the controller alongside the model."""

    model: CompressedModel
    n_includes: int
    compression_ratio: float
    probe_rows: int
    artifact: Optional[TMProgram] = None  # stamped when a plan was given
    prune: Optional[PruneReport] = None  # stamped when a policy ran
    # per-knob (name, provisioned, reclaimable) rows with reclaimable > 0:
    # how much tighter a renegotiated envelope could be for THIS artifact
    shrink: Tuple[Tuple[str, int, int], ...] = ()


class Compressor:
    def __init__(
        self,
        *,
        probe_rows: int = 64,
        probe_seed: int = 0,
        plan: Optional[CapacityPlan] = None,
        engine=None,
        validate_knobs=None,
    ):
        """``plan`` turns the gate capacity-aware and the report
        artifact-bearing.  Pass the TARGET ``engine`` (or serving node)
        to gate on exactly the check its load path will repeat
        (``validate_model``); ``validate_knobs`` instead narrows a plain
        plan check to a knob subset (None = the full envelope,
        conservative for every engine)."""
        self.probe_rows = probe_rows
        self.probe_seed = probe_seed
        self.engine = engine
        if plan is None and engine is not None:
            # engines carry .plan; ServingNode-shaped gates carry .capacity
            plan = getattr(engine, "plan", None)
            if plan is None:
                plan = getattr(engine, "capacity", None)
        self.plan = plan
        self.validate_knobs = validate_knobs

    def compress(
        self,
        cfg: TMConfig,
        state,
        *,
        traffic_sample: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        prune: Optional[PrunePolicy] = None,
    ) -> CompressionReport:
        """Encode + validate.  ``state`` is the canonical TA tensor (any
        device) or numpy array; ``traffic_sample`` ({0,1}[B, F]) extends
        the deterministic probe with rows of the live distribution.

        ``prune`` runs the compression pass between train and publish, on
        the state's device: the policy sees the traffic sample (ranking
        and the ranked drop's gate, when ``labels`` accompany it) and the
        PRUNED actions and weights are what gets encoded; the roundtrip
        gate then proves the pruned weighted stream against the pruned
        dense oracle, so an unsound prune is refused publication exactly
        like a corrupt encode."""
        state = torch.as_tensor(state)
        actions = include_actions(cfg, state).cpu().numpy()
        weights = None
        prune_report = None
        if prune is not None:
            result = prune.apply(
                cfg, actions, X=traffic_sample, y=labels, device=state.device
            )
            actions, weights = result.actions, result.weights
            prune_report = result.report
        model = encode(cfg, actions, clause_weights=weights)
        rng = np.random.default_rng(self.probe_seed)
        probe = rng.integers(
            0, 2, (self.probe_rows, cfg.n_features)
        ).astype(np.uint8)
        if traffic_sample is not None:
            sample = np.asarray(traffic_sample, np.uint8)
            if sample.ndim != 2 or sample.shape[1] != cfg.n_features:
                raise ValueError(
                    f"traffic_sample must be {{0,1}}[B, {cfg.n_features}], "
                    f"got {sample.shape}"
                )
            probe = np.concatenate([probe, sample], axis=0)
        validate_roundtrip(cfg, actions, model, probe, clause_weights=weights)
        artifact = None
        if self.engine is not None:
            # the capacity half of the gate: the exact check the target
            # engine's load path will repeat (CapacityExceeded)
            self.engine.validate_model(model)
            artifact = TMProgram(capacity=self.plan, model=model)
        elif self.plan is not None:
            self.plan.validate(model, self.validate_knobs)
            artifact = TMProgram(capacity=self.plan, model=model)
        shrink: Tuple[Tuple[str, int, int], ...] = ()
        if artifact is not None:
            # diagnostics only: the published artifact keeps the
            # negotiated plan so no engine recompiles
            shrink = tuple(
                row for row in artifact.capacity.shrink_diagnostics(model)
                if row[2] > 0
            )
        return CompressionReport(
            model=model,
            n_includes=int(actions.sum()),
            compression_ratio=model.compression_ratio(cfg),
            probe_rows=probe.shape[0],
            artifact=artifact,
            prune=prune_report,
            shrink=shrink,
        )
