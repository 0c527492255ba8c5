"""The Fig-8 Model Training Node as a long-lived worker, the port of
``repro.recal.worker``.

Owns one (``TMConfig``, TA-state) pair and fine-tunes it incrementally on
labelled batches; every update is keyed by a monotone step counter under
the fold-in seeding contract, so a worker checkpoints as the (key, step,
state) triple and resumes bit-exactly, in this package or the reference
(``core.prng.key_data`` and ``convert.key_from_numpy`` carry the key).

HOW each update runs is a ``TrainEngine`` plugin (``train_engine.py``):
the worker holds the engine's internal representation (int8 for the
'packed' engine) on the engine's device, the CUDA card unless
``device="cpu"``, and converts to the canonical ``int32[M, C, 2F]``
tensor only at the ``state``/``snapshot`` boundary.  ``mesh=`` (a
``dist.make_mesh`` mesh) auto-selects the class-sharded 'sharded'
engine.

The old ``RecalWorker(cfg, mesh=..., sharded_batch=...)`` construction
still works (it maps onto the 'sharded' engine) but emits a
``DeprecationWarning``, once per process.
"""

from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..core import prng
from ..core.tm import TMConfig, init_state
from .train_engine import TrainEngineBase, make_train_engine, select_train_engine

# domain-separation tag of the epoch shuffles (the step counter is added)
_EPOCH_SHUFFLE = 0x7E000000

_warned_legacy_sharded = False


def _warn_legacy_sharded() -> None:
    global _warned_legacy_sharded
    if _warned_legacy_sharded:
        return
    _warned_legacy_sharded = True
    warnings.warn(
        "RecalWorker(mesh=..., sharded_batch=...) is deprecated: pass "
        "train_engine='sharded' with engine_options={'batch': ...} (or "
        "just mesh=, which auto-selects the sharded engine)",
        DeprecationWarning,
        stacklevel=3,
    )


class RecalWorker:
    def __init__(
        self,
        cfg: TMConfig,
        state=None,
        *,
        key: Optional[torch.Tensor] = None,
        train_engine: "Optional[str | TrainEngineBase]" = None,
        mesh=None,
        plan=None,
        engine_options: Optional[dict] = None,
        sharded_batch: int = 0,
        device=None,
    ):
        """``train_engine`` names the backend ('reference', 'packed',
        'sharded', or a built ``TrainEngineBase``); ``None`` picks the
        fastest engine eligible for (cfg, mesh) (``select_train_engine``).
        ``engine_options`` go to the plugin constructor verbatim; ``plan``
        opts training batches into the negotiated capacity envelope
        (``CapacityExceeded``).  ``state`` is a canonical tensor or numpy
        array (default: all states N); ``key`` a ``core.prng`` key
        (default ``prng.key(0)``).

        ``sharded_batch`` is the deprecated pre-engine spelling of the
        mesh path; with ``mesh`` it maps to the 'sharded' engine pinned at
        that batch size (and warns, once per process)."""
        self.cfg = cfg
        self.key = key if key is not None else prng.key(0)
        options = dict(engine_options or {})
        if sharded_batch:
            _warn_legacy_sharded()
            if mesh is not None and train_engine is None:
                train_engine = "sharded"
                options.setdefault("batch", int(sharded_batch))
        if train_engine is None:
            train_engine = select_train_engine(cfg, mesh=mesh)
        self.engine = make_train_engine(
            train_engine, cfg, mesh=mesh, plan=plan, device=device, **options
        )
        if state is None:
            state = init_state(cfg, self.key)
        self._internal = self.engine.prepare(state)
        self.step_count = 0

    @property
    def train_engine(self) -> str:
        """Name of the active training backend plugin."""
        return self.engine.name

    @property
    def device(self) -> torch.device:
        return self.engine.device

    # -- canonical-state boundary --------------------------------------------

    @property
    def state(self) -> torch.Tensor:
        """Canonical ``int32[M, C, 2F]`` TA state on the engine's device."""
        return self.engine.canonical(self._internal)

    @state.setter
    def state(self, value) -> None:
        self._internal = self.engine.prepare(value)

    # -- training ------------------------------------------------------------

    def fine_tune(self, xb: np.ndarray, yb: np.ndarray) -> int:
        """One incremental update on a labelled batch; returns the step id
        the batch trained under (for exact replay/resume)."""
        step = self.step_count
        self._internal = self.engine.fit_step(
            self._internal, self.key, np.asarray(xb, np.uint8),
            np.asarray(yb, np.int32), step=step,
        )
        self.step_count += 1
        return step

    def fine_tune_epochs(
        self, x: np.ndarray, y: np.ndarray, *, epochs: int, batch: int
    ) -> int:
        """Epoch loop over a buffered corpus (shuffled per epoch under the
        worker's own key stream); returns the number of steps taken."""
        n = x.shape[0]
        n_batches = max(1, n // batch)
        taken = 0
        for _ in range(epochs):
            shuffle = prng.fold_in(self.key, _EPOCH_SHUFFLE + self.step_count)
            order = prng.permutation(shuffle, n).cpu().numpy()
            for b in range(n_batches):
                idx = order[b * batch:(b + 1) * batch]
                self.fine_tune(x[idx], y[idx])
                taken += 1
        return taken

    # -- snapshots (rollback support) ----------------------------------------

    def snapshot(self) -> np.ndarray:
        """Host copy of the canonical TA state (``restore()`` it to undo
        fine-tuning)."""
        return self.state.cpu().numpy()

    def restore(self, snap) -> None:
        self.state = snap
