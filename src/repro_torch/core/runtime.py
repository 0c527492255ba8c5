"""Stream protocol + runtime-tunable Accelerator (paper Fig 4 / Fig 8), the
port of ``repro.core.runtime``.

The accelerator is "synthesized" once (fixed buffer capacities chosen like
the eFPGA memory-depth customization of Fig 6), then reprogrammed
arbitrarily many times at runtime via data streams.  Two packet kinds,
distinguished by the header (Fig 4.2/4.3):

  * Instruction stream — carries a new compressed TM model
  * Feature stream     — carries Boolean features for inference

Header layout (64-bit = 4 x uint16 words, the paper's widest option):

  word0: bit15 RESET | bit14 TYPE(1=instr,0=feat) | bits13..0 payload
         TYPE=1: payload = n_classes     TYPE=0: payload = n_features
  word1: TYPE=1: n_clauses per class     TYPE=0: n_datapoints
  word2: count low 16   (TYPE=1: n_instructions, TYPE=0: n_feature_words)
  word3: count high 16

Changing the model, the task (class count), or the input dimensionality is
pure data movement: every inference runs the stream interpreter
(``core.interp.interpret_stream``, the ``interp_stream`` kernel on the
card) on operands of one shape per configuration, so
``compile_cache_size()`` stays 1 across swaps.  The stream builders are
numpy and byte-identical to the reference's.  The accelerator runs on the
CUDA card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .compress import CompressedModel
from .interp import interpret_stream, pack_features

RESET_BIT = 15
TYPE_BIT = 14
PAYLOAD_MASK = 0x3FFF


# ---------------------------------------------------------------------------
# Stream builders (the Fig-8 training node side)
# ---------------------------------------------------------------------------

def build_instruction_stream(model: CompressedModel) -> np.ndarray:
    """CompressedModel -> uint16 stream (header + instruction payload).

    Raises ValueError when a header field does not fit its wire width
    (14-bit class payload, 16-bit clause count, 32-bit instruction count)
    rather than silently wrapping into a corrupt-but-parseable header.
    """
    n = model.n_instructions
    if model.n_classes > PAYLOAD_MASK:
        raise ValueError(
            f"n_classes={model.n_classes} does not fit the 14-bit header "
            f"payload (max {PAYLOAD_MASK})"
        )
    if model.n_clauses > 0xFFFF:
        raise ValueError(
            f"n_clauses={model.n_clauses} does not fit header word1 "
            f"(max {0xFFFF})"
        )
    if n > 0xFFFFFFFF:
        raise ValueError(
            f"n_instructions={n} does not fit the 32-bit count field "
            f"(max {0xFFFFFFFF})"
        )
    header = np.array(
        [
            (1 << RESET_BIT) | (1 << TYPE_BIT) | model.n_classes,
            model.n_clauses,
            n & 0xFFFF,
            (n >> 16) & 0xFFFF,
        ],
        dtype=np.uint16,
    )
    return np.concatenate([header, model.instructions])


def build_feature_stream(x: np.ndarray) -> np.ndarray:
    """Boolean features {0,1}[B, F] -> uint16 stream (header + packed bits).

    Each datapoint's F booleans are packed LSB-first into ceil(F/16) words
    (the paper's "Inference data packets")."""
    x = np.asarray(x, dtype=np.uint16)
    B, F = x.shape
    if F > PAYLOAD_MASK:
        raise ValueError(
            f"n_features={F} does not fit the 14-bit header payload "
            f"(max {PAYLOAD_MASK})"
        )
    if B > 0xFFFF:
        raise ValueError(
            f"n_datapoints={B} does not fit header word1 (max {0xFFFF}); "
            f"stream in chunks"
        )
    wpd = (F + 15) // 16  # words per datapoint
    padded = np.zeros((B, wpd * 16), dtype=np.uint16)
    padded[:, :F] = x
    payload = np.zeros((B, wpd), dtype=np.uint16)
    for w in range(wpd):
        chunk = padded[:, w * 16 : (w + 1) * 16]
        payload[:, w] = (chunk << np.arange(16, dtype=np.uint16)[None, :]).sum(
            axis=1, dtype=np.uint16
        )
    nw = B * wpd
    header = np.array(
        [
            (1 << RESET_BIT) | F,
            B,
            nw & 0xFFFF,
            (nw >> 16) & 0xFFFF,
        ],
        dtype=np.uint16,
    )
    return np.concatenate([header, payload.reshape(-1)])


def parse_header(stream: np.ndarray) -> Tuple[bool, bool, int, int, int]:
    """-> (reset, is_instructions, payload, word1, count)."""
    w0, w1, w2, w3 = (int(stream[i]) for i in range(4))
    reset = bool((w0 >> RESET_BIT) & 1)
    is_instr = bool((w0 >> TYPE_BIT) & 1)
    payload = w0 & PAYLOAD_MASK
    count = w2 | (w3 << 16)
    return reset, is_instr, payload, w1, count


# ---------------------------------------------------------------------------
# The accelerator (Fig 4, base configuration)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """"Synthesis-time" memory-depth customization (paper Fig 6)."""

    instruction_capacity: int = 1 << 15  # instruction memory depth
    feature_capacity: int = 1 << 12  # feature memory depth (Boolean features)
    class_capacity: int = 64  # class-sum accumulator bank depth
    batch_words: int = 1  # W: 32 datapoints per word (paper batches 32)

    @property
    def batch_capacity(self) -> int:
        return self.batch_words * 32

    @property
    def bram_bytes(self) -> int:
        """On-chip memory the configuration claims (Fig 6 x-axis analog)."""
        return (
            self.instruction_capacity * 2
            + self.feature_capacity * self.batch_words * 4
            + self.class_capacity * self.batch_capacity * 4
        )


class Accelerator:
    """Runtime-tunable compressed-TM inference engine on one device.

    Its instruction memory lives on the device at a fixed depth; every
    model/task/dimensionality change is a buffer rewrite.
    """

    def __init__(
        self, config: AcceleratorConfig = AcceleratorConfig(), *, device=None
    ):
        self.config = config
        self.device = resolve_device(device)
        self._imem = torch.zeros(
            config.instruction_capacity, dtype=torch.int32, device=self.device
        )
        self._n_inst = 0
        self._n_classes = 0
        self._n_clauses = 0
        self._n_features = 0
        # counts how many instruction streams programmed the accelerator
        self.programs_loaded = 0
        self._signatures: set = set()

    # -- programming ---------------------------------------------------------

    def feed(self, stream: np.ndarray) -> Optional[np.ndarray]:
        """Consume one stream (header + payload).  Instruction streams
        program the accelerator and return None; feature streams run
        inference and return predictions."""
        reset, is_instr, payload, w1, count = parse_header(stream)
        body = stream[4:]
        if is_instr:
            if count > self.config.instruction_capacity:
                raise ValueError(
                    f"model needs {count} instructions; capacity is "
                    f"{self.config.instruction_capacity} (resynthesize = "
                    f"pick a bigger AcceleratorConfig)"
                )
            if payload > self.config.class_capacity:
                raise ValueError("class count exceeds accumulator bank depth")
            imem = np.zeros(self.config.instruction_capacity, dtype=np.int32)
            imem[:count] = body[:count]
            self._imem = torch.from_numpy(imem).to(self.device)
            self._n_inst = count
            self._n_classes = payload
            self._n_clauses = w1
            self.programs_loaded += 1
            return None
        # feature stream
        n_features, n_points = payload, w1
        if n_features > self.config.feature_capacity:
            raise ValueError("input dimensionality exceeds feature memory")
        if n_points > self.config.batch_capacity:
            raise ValueError("batch exceeds batch words; stream in chunks")
        x = _unpack_feature_payload(body, n_points, n_features)
        return self.infer(x)

    def load_model(self, model: CompressedModel) -> None:
        self.feed(build_instruction_stream(model))

    # -- inference -----------------------------------------------------------

    def _sums(self, x: np.ndarray) -> torch.Tensor:
        c = self.config
        packed = pack_features(
            torch.as_tensor(np.asarray(x)).to(self.device),
            c.feature_capacity, c.batch_words,
        )
        self._signatures.add(
            tuple((tuple(t.shape), t.dtype) for t in (self._imem, packed))
        )
        return interpret_stream(
            self._imem, self._n_inst, packed, x.shape[0], m_cap=c.class_capacity
        )

    def infer(self, x: np.ndarray) -> np.ndarray:
        """{0,1}[B<=batch_capacity, F] -> int32[B] predicted classes."""
        sums = self._sums(x)
        valid = torch.arange(self.config.class_capacity, device=self.device)
        masked = torch.where(
            (valid < self._n_classes)[:, None], sums, torch.iinfo(torch.int32).min
        )
        preds = masked.argmax(dim=0)[: x.shape[0]]
        return preds.cpu().numpy().astype(np.int32)

    def class_sums(self, x: np.ndarray) -> np.ndarray:
        sums = self._sums(x)
        return sums[: self._n_classes, : x.shape[0]].T.cpu().numpy()

    def compile_cache_size(self) -> int:
        """Distinct operand signatures the interpreter ran with (should
        stay 1: the counterpart of the reference's jit cache)."""
        return len(self._signatures)


def _unpack_feature_payload(body: np.ndarray, n_points: int, n_features: int) -> np.ndarray:
    wpd = (n_features + 15) // 16
    words = np.asarray(body[: n_points * wpd], dtype=np.uint16).reshape(
        n_points, wpd
    )
    bits = (words[:, :, None] >> np.arange(16, dtype=np.uint16)[None, None, :]) & 1
    return bits.reshape(n_points, wpd * 16)[:, :n_features].astype(np.uint8)


# ---------------------------------------------------------------------------
# Multi-core configuration (paper Fig 7): class-level parallelism
# ---------------------------------------------------------------------------

class MultiCoreAccelerator:
    """N base cores, each programmed with a disjoint class slice of the same
    model (the AXIS splitter of Fig 7).  All cores live in one process, on
    one device."""

    def __init__(
        self,
        n_cores: int,
        config: AcceleratorConfig = AcceleratorConfig(),
        *,
        device=None,
    ):
        self.n_cores = n_cores
        device = resolve_device(device)
        self.cores = [Accelerator(config, device=device) for _ in range(n_cores)]
        self._class_slices: list[tuple[int, int]] = []

    def load_model(self, model: CompressedModel) -> None:
        from .compress import decode, encode
        from .tm import TMConfig

        acts = decode(model)
        M = model.n_classes
        per = -(-M // self.n_cores)
        self._class_slices = []
        for i, core in enumerate(self.cores):
            lo, hi = i * per, min((i + 1) * per, M)
            self._class_slices.append((lo, hi))
            if lo >= hi:
                continue
            sub_cfg = TMConfig(
                n_classes=hi - lo,
                n_clauses=model.n_clauses,
                n_features=model.n_features,
            )
            core.load_model(encode(sub_cfg, acts[lo:hi]))

    def infer(self, x: np.ndarray) -> np.ndarray:
        if not self._class_slices:
            raise RuntimeError(
                "no model loaded: call MultiCoreAccelerator.load_model() "
                "before infer()"
            )
        all_sums = []
        for core, (lo, hi) in zip(self.cores, self._class_slices):
            if lo >= hi:
                continue
            all_sums.append(core.class_sums(x))  # [B, hi-lo]
        sums = np.concatenate(all_sums, axis=1)
        return np.argmax(sums, axis=1).astype(np.int32)
