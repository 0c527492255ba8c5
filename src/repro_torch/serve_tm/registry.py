"""Named model slots with hot-swap — the Fig-8 reprogram step as an API.

A slot holds one programmed model (the engine's fixed-capacity buffers).
Installing into an existing slot is the runtime recalibration path: pure
data movement, version bump, no recompilation (the server asserts the
engine's compile cache stays at 1).

``install`` accepts a bare ``CompressedModel``, a ``TMProgram`` artifact,
or the artifact's raw ``to_bytes()`` blob — the reprogram-over-the-wire
path: a training node ships bytes, the serving node integrity-checks and
installs them, and the slot entry records which artifact (checksum and
capacity stamp) it is running.

Every install records *provenance* (who produced the model: initial
deploy, a recal pipeline, a rollback) and the previous entries are kept in
a bounded per-slot history (depth is a constructor argument), so the recal
controller can roll a bad swap back WITHOUT re-programming: the old
entry's buffers are still alive and are reinstalled as-is.  A rollback's
provenance nests the restored entry's own provenance, so a
rollback-of-a-rollback reads as the full chain, e.g.
``rollback:v4->v3(rollback:v2->v1(deploy))``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Union

from ..accel.program import TMProgram
from ..core.compress import CompressedModel

# default retained previous versions per slot (override per registry)
DEFAULT_HISTORY_DEPTH = 4

Installable = Union[CompressedModel, TMProgram, bytes]


@dataclasses.dataclass
class SlotEntry:
    name: str
    model: CompressedModel
    program: Any  # backend-specific fixed-capacity buffers
    version: int
    installed_at: float
    provenance: str = "install"
    artifact: Optional[TMProgram] = None  # set when installed from one

    @property
    def n_classes(self) -> int:
        return self.model.n_classes

    @property
    def n_features(self) -> int:
        return self.model.n_features


class ModelRegistry:
    """slot name -> programmed model, for one engine."""

    def __init__(self, executor, history_depth: int = DEFAULT_HISTORY_DEPTH):
        if history_depth < 1:
            raise ValueError(
                f"history_depth must be >= 1 (rollback needs at least one "
                f"retained version), got {history_depth}"
            )
        self._executor = executor
        self.history_depth = history_depth
        self._slots: Dict[str, SlotEntry] = {}
        self._history: Dict[str, List[SlotEntry]] = {}

    def install(
        self, name: str, model: Installable, provenance: str = "install"
    ) -> SlotEntry:
        """Program ``model`` into ``name`` (create or hot-swap).

        ``model`` may be a ``TMProgram`` artifact or its serialized bytes
        (integrity-checked by ``TMProgram.from_bytes``); the underlying
        ``CompressedModel`` is what gets programmed.
        """
        artifact: Optional[TMProgram] = None
        if isinstance(model, (bytes, bytearray, memoryview)):
            model = TMProgram.from_bytes(model)
        if isinstance(model, TMProgram):
            artifact = model
            model = artifact.model
        prev = self._slots.get(name)
        entry = SlotEntry(
            name=name,
            model=model,
            program=self._executor.program(model),
            version=(prev.version + 1) if prev else 1,
            installed_at=time.time(),
            provenance=provenance,
            artifact=artifact,
        )
        if prev is not None:
            self._push_history(name, prev)
        self._slots[name] = entry
        return entry

    def rollback(self, name: str) -> SlotEntry:
        """Reinstall the slot's previous model (the recal safety net).

        Pure data movement squared: the previous entry's programmed
        buffers are reused verbatim — no decode, no reprogram.  The
        version still advances monotonically so observers can tell a
        rollback from time going backwards, and the provenance nests the
        restored entry's own provenance (the full chain survives repeated
        rollbacks).
        """
        hist = self._history.get(name)
        if not hist:
            raise KeyError(
                f"slot {name!r} has no previous version to roll back to"
            )
        prev = hist.pop()
        cur = self.get(name)
        entry = SlotEntry(
            name=name,
            model=prev.model,
            program=prev.program,
            version=cur.version + 1,
            installed_at=time.time(),
            provenance=(
                f"rollback:v{cur.version}->v{prev.version}"
                f"({prev.provenance})"
            ),
            artifact=prev.artifact,
        )
        self._push_history(name, cur)
        self._slots[name] = entry
        return entry

    def _push_history(self, name: str, entry: SlotEntry) -> None:
        hist = self._history.setdefault(name, [])
        hist.append(entry)
        del hist[: -self.history_depth]

    def previous(self, name: str) -> Optional[SlotEntry]:
        """The entry a ``rollback(name)`` would reinstall (None if none)."""
        hist = self._history.get(name)
        return hist[-1] if hist else None

    def history(self, name: str) -> List[SlotEntry]:
        """Retained previous entries, oldest first (excludes the live one)."""
        return list(self._history.get(name, ()))

    def get(self, name: str) -> SlotEntry:
        if name not in self._slots:
            raise KeyError(
                f"no model registered in slot {name!r}; call "
                f"TMServer.register({name!r}, model) first "
                f"(known slots: {sorted(self._slots) or 'none'})"
            )
        return self._slots[name]

    def names(self) -> List[str]:
        return sorted(self._slots)

    def __contains__(self, name: str) -> bool:
        return name in self._slots

    def __len__(self) -> int:
        return len(self._slots)
