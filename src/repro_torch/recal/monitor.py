"""Drift detection over live prediction traffic (WHEN to recalibrate): a
copy of ``repro.recal.monitor`` (numpy only).

The monitor keeps two sliding windows over the slot's served predictions:

  * **accuracy** — fraction correct over the labelled tail of the window
    (labels arrive late and sparsely in the field; unlabelled rows simply
    don't enter this window);
  * **class-sum margin** — mean (top1 - top2) class-sum gap, a
    label-free confidence proxy.  Under concept drift the margin collapses
    well before labels confirm the accuracy drop, which is what lets the
    Fig-8 training node start retraining early.

``freeze_baseline()`` snapshots the healthy-traffic margin right after a
deploy; ``decision()`` then triggers when EITHER window degrades past its
threshold.  All statistics are windowed (bounded memory) — this runs
beside the serving loop for the lifetime of the deployment.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DriftDecision:
    """The monitor's verdict for the current window."""

    trigger: bool
    reason: str
    accuracy: Optional[float]  # None when the window has no labels
    margin: float
    baseline_margin: Optional[float]


class DriftMonitor:
    def __init__(
        self,
        *,
        window: int = 512,
        min_samples: int = 64,
        min_labelled: int = 32,
        accuracy_threshold: float = 0.90,
        margin_fraction: float = 0.6,
    ):
        """``margin_fraction``: trigger when the windowed margin falls
        below this fraction of the frozen baseline margin.
        ``min_labelled``: the accuracy trigger needs at least this many
        labelled rows in the window (labels are sparse in the field; one
        noisy label must not launch a recalibration)."""
        self.window = window
        self.min_samples = min_samples
        self.min_labelled = min_labelled
        self.accuracy_threshold = accuracy_threshold
        self.margin_fraction = margin_fraction
        self._correct: deque = deque(maxlen=window)
        self._margins: deque = deque(maxlen=window)
        self._baseline_margin: Optional[float] = None

    # -- ingest --------------------------------------------------------------

    def observe(
        self,
        class_sums: np.ndarray,  # int[B, M] engine output
        preds: np.ndarray,  # int[B] served predictions
        labels: Optional[np.ndarray] = None,  # int[B] when ground truth exists
    ) -> None:
        sums = np.asarray(class_sums)
        if sums.ndim != 2 or sums.shape[0] != np.asarray(preds).shape[0]:
            raise ValueError(
                f"class_sums {sums.shape} does not match preds "
                f"{np.asarray(preds).shape}"
            )
        if sums.shape[1] >= 2:
            top2 = np.partition(sums, -2, axis=1)[:, -2:]
            self._margins.extend((top2[:, 1] - top2[:, 0]).tolist())
        else:
            self._margins.extend(sums[:, 0].tolist())
        if labels is not None:
            self._correct.extend(
                (np.asarray(preds) == np.asarray(labels)).tolist()
            )

    def freeze_baseline(self) -> float:
        """Snapshot the current margin as the healthy reference (call after
        a deploy, on traffic the model is known to serve well)."""
        self._baseline_margin = self.margin
        return self._baseline_margin

    def reset(self) -> None:
        """Clear the windows (call after a recalibration swap so stale
        pre-swap statistics don't immediately re-trigger)."""
        self._correct.clear()
        self._margins.clear()

    # -- statistics ----------------------------------------------------------

    @property
    def n_samples(self) -> int:
        return len(self._margins)

    @property
    def margin(self) -> float:
        return float(np.mean(self._margins)) if self._margins else 0.0

    @property
    def accuracy(self) -> Optional[float]:
        if not self._correct:
            return None
        return float(np.mean(self._correct))

    # -- verdict -------------------------------------------------------------

    def decision(self) -> DriftDecision:
        acc = self.accuracy
        margin = self.margin
        if self.n_samples < self.min_samples:
            return DriftDecision(False, "warmup", acc, margin,
                                 self._baseline_margin)
        if (
            acc is not None
            and len(self._correct) >= self.min_labelled
            and acc < self.accuracy_threshold
        ):
            return DriftDecision(
                True,
                f"accuracy {acc:.3f} < {self.accuracy_threshold}",
                acc, margin, self._baseline_margin,
            )
        if (
            self._baseline_margin is not None
            and self._baseline_margin > 0
            and margin < self.margin_fraction * self._baseline_margin
        ):
            return DriftDecision(
                True,
                f"margin {margin:.2f} < {self.margin_fraction:.2f} x "
                f"baseline {self._baseline_margin:.2f}",
                acc, margin, self._baseline_margin,
            )
        return DriftDecision(False, "healthy", acc, margin,
                             self._baseline_margin)
