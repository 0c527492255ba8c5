"""TMProgram: the versioned, wire-transportable deployment artifact.

ETHEREAL's insight, applied to our Fig-8 loop: the *compressed program*
— not the dense model — is the thing that ships.  A ``TMProgram`` bundles
the uint16 include-instruction stream with the capacity envelope it was
compiled against and a checksum, so a training node can ``to_bytes()`` it
onto the wire and a serving node can ``from_bytes()`` + ``load`` it into
a live accelerator with no shared process state:

    art  = accelerator.compile(model)        # stamp + stream + checksum
    blob = art.to_bytes()                    # -> network / flash / disk
    ...
    art2 = TMProgram.from_bytes(blob)        # integrity-checked
    accelerator.load("slot", art2)           # reprogram: data movement

Layout (all little-endian):

    header   4s  magic  b"TMPG"
             H   format version (1 or 2)
             H   reserved (0)
             I   payload length in bytes
             I   CRC-32 of the payload
    v1       6I  capacity stamp (instruction, feature, class, clause,
    payload      include capacities, batch_words)
             4I  model dims (n_classes, n_clauses, n_features,
                 n_instructions)
             H*  the instruction stream, n_instructions uint16 words
    v2       7I  capacity stamp (v1's six + weight_planes)
    payload  4I  model dims (as v1)
             I   n_weights (per-clause weight count; 0 = weightless)
             H*  the instruction stream, n_instructions uint16 words
             H*  the clause-weight vector, n_weights uint16 words

Version policy (repro.prune weighted clauses): a weightless model whose
envelope has no weight planes beyond the implicit one serializes as v1 —
BYTE-IDENTICAL to every pre-prune artifact (the golden-fixture guarantee).
Weighted models (or plans provisioning ``weight_planes > 1``) emit v2.
``from_bytes`` loads both; the CRC covers the weight vector, so corrupted
weight bytes are refused exactly like corrupted instructions.

``from_bytes`` refuses truncated blobs, wrong magic, future format
versions and checksum mismatches with specific errors — a corrupted
artifact must never reach a live accelerator.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np

from ..core.compress import CompressedModel
from .capacity import CapacityPlan

MAGIC = b"TMPG"
FORMAT_VERSION = 2

# the v1 wire order is FROZEN: exactly the six knobs that existed when v1
# shipped, regardless of what CapacityPlan.KNOBS grows to
_V1_KNOBS = (
    "instruction_capacity", "feature_capacity", "class_capacity",
    "clause_capacity", "include_capacity", "batch_words",
)
_V2_KNOBS = _V1_KNOBS + ("weight_planes",)

_HEADER = struct.Struct("<4sHHII")
_CAPS = struct.Struct("<6I")
_CAPS_V2 = struct.Struct("<7I")
_DIMS = struct.Struct("<4I")
_NWEIGHTS = struct.Struct("<I")


@dataclasses.dataclass(frozen=True, eq=False)
class TMProgram:
    """One deployable program: capacity stamp + instruction stream.

    The stamp records the envelope the artifact was compiled for — a
    serving node whose own plan differs can still load it as long as the
    model fits (``CapacityPlan.validate`` at load time decides)."""

    capacity: CapacityPlan
    model: CompressedModel
    format_version: Optional[int] = None  # None -> minimal covering version

    def __post_init__(self):
        version = self.format_version
        if version is None:
            # emit the OLDEST format that covers the artifact: weightless
            # models in a plane-free envelope stay byte-identical v1
            version = 1 if (
                not self.model.weighted and self.capacity.weight_planes == 1
            ) else 2
            object.__setattr__(self, "format_version", version)
        if version == 1 and self.model.weighted:
            raise ValueError(
                "TMProgram format v1 cannot carry clause weights; "
                "serialize weighted models as v2"
            )

    # -- identity ------------------------------------------------------------

    def __eq__(self, other) -> bool:
        if not (
            isinstance(other, TMProgram)
            and self.format_version == other.format_version
            and self.capacity == other.capacity
            and self.model.n_classes == other.model.n_classes
            and self.model.n_clauses == other.model.n_clauses
            and self.model.n_features == other.model.n_features
            and np.array_equal(self.model.instructions,
                               other.model.instructions)
        ):
            return False
        a, b = self.model.clause_weights, other.model.clause_weights
        if (a is None) != (b is None):
            return False
        return a is None or bool(np.array_equal(a, b))

    __hash__ = None  # mutable-array payload; identity-hashing would lie

    # -- wire format ---------------------------------------------------------

    def _payload(self) -> bytes:
        m = self.model
        caps = self.capacity.as_dict()
        dims = _DIMS.pack(
            m.n_classes, m.n_clauses, m.n_features, m.n_instructions
        )
        stream = np.ascontiguousarray(m.instructions, dtype="<u2").tobytes()
        if self.format_version == 1:
            return (
                _CAPS.pack(*(caps[k] for k in _V1_KNOBS)) + dims + stream
            )
        weights = b"" if m.clause_weights is None else (
            np.ascontiguousarray(m.clause_weights, dtype="<u2").tobytes()
        )
        return (
            _CAPS_V2.pack(*(caps[k] for k in _V2_KNOBS))
            + dims
            + _NWEIGHTS.pack(m.n_weights)
            + stream
            + weights
        )

    @property
    def checksum(self) -> int:
        """CRC-32 of the payload (what the header carries on the wire)."""
        return zlib.crc32(self._payload())

    @property
    def n_bytes(self) -> int:
        if self.format_version == 1:
            return (_HEADER.size + _CAPS.size + _DIMS.size
                    + 2 * self.model.n_instructions)
        return (_HEADER.size + _CAPS_V2.size + _DIMS.size + _NWEIGHTS.size
                + 2 * (self.model.n_instructions + self.model.n_weights))

    def to_bytes(self) -> bytes:
        payload = self._payload()
        header = _HEADER.pack(
            MAGIC, self.format_version, 0, len(payload), zlib.crc32(payload)
        )
        return header + payload

    @classmethod
    def from_bytes(cls, blob: bytes) -> "TMProgram":
        blob = bytes(blob)
        if len(blob) < _HEADER.size:
            raise ValueError(
                f"truncated TMProgram artifact: {len(blob)} bytes is "
                f"smaller than the {_HEADER.size}-byte header"
            )
        magic, version, _, payload_len, crc = _HEADER.unpack_from(blob)
        if magic != MAGIC:
            raise ValueError(
                f"not a TMProgram artifact (magic {magic!r}, "
                f"expected {MAGIC!r})"
            )
        if version > FORMAT_VERSION:
            raise ValueError(
                f"TMProgram format version {version} is newer than this "
                f"runtime understands (<= {FORMAT_VERSION}); upgrade the "
                f"serving node"
            )
        payload = blob[_HEADER.size:]
        if len(payload) != payload_len:
            raise ValueError(
                f"truncated TMProgram artifact: header promises "
                f"{payload_len} payload bytes, got {len(payload)}"
            )
        if zlib.crc32(payload) != crc:
            raise ValueError(
                "TMProgram checksum mismatch — the artifact was corrupted "
                "in transit; refusing to load it into a live accelerator"
            )
        if version == 1:
            caps_s, knobs, n_weights_s = _CAPS, _V1_KNOBS, 0
        else:
            caps_s, knobs, n_weights_s = _CAPS_V2, _V2_KNOBS, _NWEIGHTS.size
        caps = caps_s.unpack_from(payload, 0)
        n_classes, n_clauses, n_features, n_instructions = _DIMS.unpack_from(
            payload, caps_s.size
        )
        n_weights = 0
        if version >= 2:
            (n_weights,) = _NWEIGHTS.unpack_from(
                payload, caps_s.size + _DIMS.size
            )
        expect = (caps_s.size + _DIMS.size + n_weights_s
                  + 2 * (n_instructions + n_weights))
        if payload_len != expect:
            # a CRC-consistent blob can still LIE about its own shape
            # (buggy producer): dims promising more words than present, or
            # trailing words the dims disown — both would ship a wrong
            # model, so both are hard errors
            raise ValueError(
                f"inconsistent TMProgram artifact: dims declare "
                f"{n_instructions} instructions + {n_weights} weights "
                f"({expect} payload bytes) but the payload carries "
                f"{payload_len}"
            )
        stream_off = caps_s.size + _DIMS.size + n_weights_s
        stream = np.frombuffer(
            payload, dtype="<u2", count=n_instructions, offset=stream_off,
        ).astype(np.uint16)
        weights = None
        if n_weights:
            weights = np.frombuffer(
                payload, dtype="<u2", count=n_weights,
                offset=stream_off + 2 * n_instructions,
            ).astype(np.uint16)
        return cls(
            capacity=CapacityPlan(**dict(zip(knobs, caps))),
            model=CompressedModel(
                instructions=stream,
                n_classes=n_classes,
                n_clauses=n_clauses,
                n_features=n_features,
                clause_weights=weights,
            ),
            format_version=version,
        )
