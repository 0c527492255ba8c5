"""The closed Fig-8 loop: monitor -> retrain -> compress -> hot-swap, the
port of ``repro.recal.controller``.

``RecalController`` sits between live traffic and a slot of a serving
node (a ``TMServer`` or the ``Accelerator`` façade):

  1. every served batch feeds the ``DriftMonitor`` (class-sum margins +
     the labelled tail) and, when labelled, a bounded replay buffer;
  2. when the monitor triggers, the ``RecalWorker`` fine-tunes on the
     buffered data (incremental ``fit_step``s through its train engine:
     on the card the packed engine's ``tm_train`` kernel);
  3. the ``Compressor`` emits the include stream and PROVES it bit-exact
     against the dense oracle before publication;
  4. the new version is published through the server's drain-then-swap
     path (``register`` with ``recal:`` provenance): queued traffic
     finishes under the old program, the engine is never recompiled;
  5. post-swap validation re-scores a held-out slice of the buffer: if
     the new version regresses past ``regression_margin`` the controller
     rolls the slot back and reverts the worker to its pre-recal state.

Every completed run is a ``RecalEvent`` in ``controller.events`` and a
``recals``/``rollbacks`` tick in the server's metrics.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..prune import PrunePolicy
from .compressor import Compressor
from .monitor import DriftMonitor
from .worker import RecalWorker


@dataclasses.dataclass(frozen=True)
class RecalEvent:
    """One completed trip around the Fig-8 loop."""

    version: int  # slot version published (pre-rollback)
    reason: str
    steps_taken: int
    train_s: float
    compress_s: float
    swap_s: float
    holdout_acc_before: float
    holdout_acc_after: float
    rolled_back: bool
    compression_ratio: float
    # prune-pass stamp (defaults keep pre-prune consumers working)
    pruned_clauses: int = 0
    prune_stages: tuple = ()
    # (knob, provisioned, reclaimable) envelope-renegotiation diagnostics
    reclaimable: tuple = ()


class RecalController:
    def __init__(
        self,
        server,
        slot: str,
        worker: RecalWorker,
        *,
        monitor: Optional[DriftMonitor] = None,
        compressor: Optional[Compressor] = None,
        buffer_batches: int = 32,
        epochs_per_recal: int = 4,
        train_batch_size: int = 128,
        min_buffer_rows: Optional[int] = None,
        holdout_fraction: float = 0.25,
        regression_margin: float = 0.02,
        prune: Optional[PrunePolicy] = None,
    ):
        self.server = server
        self.slot = slot
        self.worker = worker
        self.monitor = monitor or DriftMonitor()
        if compressor is None:
            # stamp publications against the server's negotiated plan and
            # gate on the serving node's own validate_model: the capacity
            # half of the gate is exactly the check the hot-swap repeats
            gate = server if hasattr(server, "validate_model") else None
            if gate is None:
                eng = getattr(server, "engine", None)
                if eng is None:
                    eng = getattr(server, "executor", None)
                gate = eng if hasattr(eng, "validate_model") else None
            compressor = Compressor(
                plan=getattr(server, "capacity", None), engine=gate,
            )
        self.compressor = compressor
        self.epochs_per_recal = epochs_per_recal
        self.train_batch_size = train_batch_size
        # don't retrain off a thin buffer
        self.min_buffer_rows = min_buffer_rows or train_batch_size
        self.holdout_fraction = holdout_fraction
        self.regression_margin = regression_margin
        self._buffer: deque = deque(maxlen=buffer_batches)
        self._refreeze_pending = False
        self.events: list = []
        # the model-compression pass between train and publish: deploy()
        # has no labelled holdout, so only the bit-exact passes run there;
        # recalibrate() hands the policy the holdout slice, enabling the
        # tolerance-gated ranked drop too
        self.prune = prune

    # -- deployment ----------------------------------------------------------

    def deploy(self, provenance: str = "deploy") -> None:
        """Compress the worker's current state and install it into the
        slot (initial deployment or a manual push)."""
        report = self.compressor.compress(
            self.worker.cfg, self.worker.state, prune=self.prune
        )
        self.server.register(
            self.slot,
            report.artifact if report.artifact is not None else report.model,
            provenance=provenance,
        )

    def freeze_baseline(self) -> float:
        """Snapshot the current margin window as the healthy reference."""
        return self.monitor.freeze_baseline()

    # -- the serving tap -----------------------------------------------------

    def observe(
        self, x: np.ndarray, y: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Serve ``x`` through the real batched path, feed the monitor
        (margins from the class sums demuxed into the request handle),
        buffer labelled rows.  With the server's scheduler loop running
        the request is completed BY THE LOOP: the tap blocks on the
        handle instead of driving a flush."""
        x = np.asarray(x, np.uint8)
        handle = self.server.submit(self.slot, x)
        if getattr(self.server, "scheduler_running", False):
            preds = handle.wait(timeout=60.0)
        else:
            self.server.flush()
            preds = handle.result()
        self.monitor.observe(handle.class_sums, preds, y)
        if y is not None:
            self._buffer.append((x, np.asarray(y, np.int32)))
        return preds

    def serve(
        self, x: np.ndarray, y: Optional[np.ndarray] = None
    ) -> tuple:
        """``observe`` + auto-recalibrate: returns (preds, event-or-None)."""
        preds = self.observe(x, y)
        if (
            self._refreeze_pending
            and self.monitor.n_samples >= self.monitor.min_samples
        ):
            # the margin reference tracks the MODEL: re-freeze on the
            # first full post-swap window
            self.monitor.freeze_baseline()
            self._refreeze_pending = False
        decision = self.monitor.decision()
        event = None
        if decision.trigger and self.buffered_rows >= self.min_buffer_rows:
            event = self.recalibrate(reason=decision.reason)
        return preds, event

    @property
    def buffered_rows(self) -> int:
        return sum(x.shape[0] for x, _ in self._buffer)

    # -- the loop body -------------------------------------------------------

    def recalibrate(self, reason: str = "manual") -> RecalEvent:
        """One full trip: fine-tune on the buffer, compress + validate,
        drain-then-swap, post-swap validation, auto-rollback."""
        if not self._buffer:
            raise RuntimeError(
                "cannot recalibrate: no labelled traffic buffered — "
                "pass labels to observe()/serve() first"
            )
        X = np.concatenate([x for x, _ in self._buffer], axis=0)
        Y = np.concatenate([y for _, y in self._buffer], axis=0)
        n_holdout = max(1, int(X.shape[0] * self.holdout_fraction))
        X_train, Y_train = X[:-n_holdout], Y[:-n_holdout]
        X_hold, Y_hold = X[-n_holdout:], Y[-n_holdout:]
        if X_train.shape[0] == 0:  # degenerate tiny buffer: train==holdout
            X_train, Y_train = X_hold, Y_hold

        acc_before = float(
            (self.server.infer(self.slot, X_hold) == Y_hold).mean()
        )

        snap = self.worker.snapshot()
        t0 = time.perf_counter()
        steps = self.worker.fine_tune_epochs(
            X_train, Y_train,
            epochs=self.epochs_per_recal, batch=self.train_batch_size,
        )
        if self.worker.device.type == "cuda":
            # the steps are queued on the card: training ends when they ran
            torch.cuda.synchronize(self.worker.device)
        train_s = time.perf_counter() - t0

        try:
            t0 = time.perf_counter()
            report = self.compressor.compress(
                self.worker.cfg, self.worker.state,
                traffic_sample=X_hold, labels=Y_hold, prune=self.prune,
            )
            compress_s = time.perf_counter() - t0

            t0 = time.perf_counter()
            entry = self.server.register(
                self.slot,
                report.artifact if report.artifact is not None
                else report.model,
                provenance=f"recal:{reason}",
            )
            swap_s = time.perf_counter() - t0
        except ValueError:
            # publication refused (capacity envelope exhausted, or the
            # bit-exactness gate tripped): the live slot is untouched, so
            # revert the worker too
            self.worker.restore(snap)
            raise

        acc_after = float(
            (self.server.infer(self.slot, X_hold) == Y_hold).mean()
        )
        rolled_back = acc_after < acc_before - self.regression_margin
        if rolled_back:
            self.server.rollback(self.slot)
            self.worker.restore(snap)

        self.server.metrics.record_recal(train_s, compress_s)
        self.monitor.reset()
        self._refreeze_pending = not rolled_back
        event = RecalEvent(
            version=entry.version,
            reason=reason,
            steps_taken=steps,
            train_s=train_s,
            compress_s=compress_s,
            swap_s=swap_s,
            holdout_acc_before=acc_before,
            holdout_acc_after=acc_after,
            rolled_back=rolled_back,
            compression_ratio=report.compression_ratio,
            reclaimable=report.shrink,
            pruned_clauses=(
                0 if report.prune is None else report.prune.n_removed
            ),
            prune_stages=(
                () if report.prune is None else report.prune.stages
            ),
        )
        self.events.append(event)
        return event
