"""Data pipeline of the port: deterministic synthetic streams (token LM +
TM datasets), numpy, nothing is downloaded, and the same arrays as
``repro.data.pipeline`` for the same arguments.

Token streams are Zipf-distributed with Markov bigram structure (so
training loss measurably decreases).

Feature/class counts follow the public UCI datasets the paper evaluates
(EMG [10], Human Activity [19], Gesture Phase [14], Sensorless Drives [4],
Gas Sensor Array Drift [24]); the data itself is synthesized with
per-class Gaussian prototypes plus noise, so the pipeline is
self-contained and offline.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class TokenStreamConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class TokenStream:
    """Deterministic, restartable synthetic LM token stream.

    ``state()``/``restore()`` give exact-resume semantics so checkpoint
    restarts do not replay or skip batches."""

    def __init__(self, cfg: TokenStreamConfig, start_step: int = 0):
        self.cfg = cfg
        self._step = start_step

    def state(self) -> int:
        return self._step

    def restore(self, state: int) -> None:
        self._step = state

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 20) ^ self._step)
        self._step += 1
        # zipf body + bigram structure: next token correlated with previous
        base = rng.zipf(cfg.zipf_a, size=(cfg.global_batch, cfg.seq_len))
        base = np.minimum(base - 1, cfg.vocab - 1).astype(np.int32)
        shift = np.roll(base, 1, axis=1)
        mix = rng.random((cfg.global_batch, cfg.seq_len)) < 0.3
        tokens = np.where(mix, (shift * 7 + 13) % cfg.vocab, base)
        return {"tokens": tokens.astype(np.int32)}


def batch_to_device(batch: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """A numpy batch -> the same arrays as tensors on ``device`` (the CUDA
    card unless ``device="cpu"``), the one-device form of ``shard_batch``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in batch.items()}


def batch_rows(mesh, B: int, microbatches: int = 1):
    """-> (the mesh axes a ``B``-row batch's rows split over, this rank's
    global row indices) on a rank mesh, in the reference's microbatch
    layout.

    The reference's step splits the *global* batch into ``microbatches``
    pieces of ``b = B / microbatches`` rows and each piece over the batch
    axes (``batch_axes(mesh, b)``, ``n`` shards).  Shard ``k`` (its index
    major-to-minor over those axes) therefore computes rows ``i*b + k*b/n
    ... i*b + (k+1)*b/n - 1`` of microbatch ``i``, not one contiguous
    block of the batch; its rows are listed microbatch by microbatch, so
    that splitting them into ``microbatches`` equal pieces gives it its
    rows of each microbatch.  A piece the batch axes do not divide stays
    whole on every rank (replicated), as the reference leaves it."""
    from ..dist.sharding import _axis_sizes, batch_axes

    if B % microbatches:
        raise ValueError(f"global batch {B} not divisible by "
                         f"train_microbatches={microbatches}")
    b = B // microbatches
    axes = batch_axes(mesh, b) or ()
    sizes, coords = _axis_sizes(mesh), mesh.coords
    k, n = 0, 1
    for a in axes:
        k = k * sizes[a] + coords[a]
        n *= sizes[a]
    per = b // n
    rows = np.concatenate([np.arange(i * b + k * per, i * b + (k + 1) * per)
                           for i in range(microbatches)])
    return axes, rows


def shard_batch(batch: Dict[str, np.ndarray], mesh, shardings,
                microbatches: int = 1) -> Dict[str, torch.Tensor]:
    """A numpy batch -> tensors placed by ``shardings`` (a dict of
    ``NamedSharding`` with the batch's keys, e.g. ``input_shardings``) on
    ``mesh``.

    On a logical mesh each whole array goes on the mesh's device
    (``dist.sharding.place``; ``microbatches`` plays no part).  On a rank
    mesh each batch-leading array becomes this rank's rows only
    (``batch_rows``: the reference's rows of each of the step's
    ``microbatches``), a ``DTensor`` of the batch's global shape placed
    ``Shard(0)`` over the axes the rows split over (with one microbatch
    its logical array is the batch itself; with several, the batch with
    its rows grouped by shard, each shard's rows microbatch by
    microbatch).  Other arrays are replicated."""
    from ..dist.sharding import NamedSharding, P, from_block, place

    for k, sh in shardings.items():
        if sh.mesh is not mesh:
            raise ValueError(f"input {k!r}: its sharding is on another mesh")
    if not getattr(mesh, "distributed", False):
        return {k: place(batch[k], shardings[k], k) for k in sorted(batch)}
    B = next(np.asarray(v).shape[0] for v in batch.values())
    axes, rows = batch_rows(mesh, B, microbatches)
    out = {}
    for k in sorted(batch):
        arr = np.asarray(batch[k])
        if arr.ndim and arr.shape[0] == B:
            sh = NamedSharding(mesh, P(axes or None, *([None] * (arr.ndim - 1))))
            block = torch.from_numpy(np.ascontiguousarray(arr[rows])).to(mesh.device)
            out[k] = from_block(block, sh, arr.shape)
        else:
            out[k] = place(arr, NamedSharding(mesh, P()), k)
    return out


@dataclasses.dataclass(frozen=True)
class TMDatasetSpec:
    name: str
    n_raw_features: int
    n_classes: int
    thermometer_bits: int
    n_clauses: int  # per class, as used for the paper-scale models


TM_DATASETS = {
    "emg": TMDatasetSpec("emg", 8, 4, 8, 100),
    "har": TMDatasetSpec("har", 561, 6, 2, 100),
    "gesture": TMDatasetSpec("gesture", 18, 5, 6, 100),
    "sensorless": TMDatasetSpec("sensorless", 48, 11, 4, 100),
    "gas": TMDatasetSpec("gas", 128, 6, 4, 100),
    "mnist": TMDatasetSpec("mnist", 784, 10, 1, 200),
}


def make_tm_dataset(
    spec: TMDatasetSpec, n: int, seed: int = 0, drift: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (X float[n, F_raw], y int[n]).

    Class prototypes are keyed by the DATASET identity (so train/test splits
    share a distribution); ``seed`` only draws the samples.  ``drift`` shifts
    the prototypes deterministically (sensor aging / environment change —
    the paper's Fig 8 recalibration trigger).  The identity hash is a stable
    CRC (not the salted builtin ``hash``), so the same dataset is generated
    across processes and machines."""
    proto_seed = zlib.crc32(spec.name.encode()) % (2**31)
    rng_proto = np.random.default_rng(proto_seed)
    protos = rng_proto.normal(size=(spec.n_classes, spec.n_raw_features))
    if drift:
        rng_drift = np.random.default_rng(proto_seed + int(drift * 1000) + 1)
        protos = protos + drift * rng_drift.normal(size=protos.shape)
    rng = np.random.default_rng(seed)
    y = rng.integers(0, spec.n_classes, size=n)
    x = protos[y] + 0.6 * rng.normal(size=(n, spec.n_raw_features))
    return x.astype(np.float32), y.astype(np.int32)


def booleanized_tm_dataset(
    spec: TMDatasetSpec, n: int, seed: int = 0, drift: float = 0.0,
    booleanizer=None,
):
    """-> (X_bool uint8[n, F_bool], y, booleanizer)."""
    from ..core.booleanize import Booleanizer

    x, y = make_tm_dataset(spec, n, seed=seed, drift=drift)
    if booleanizer is None:
        booleanizer = Booleanizer.fit(x, bits=spec.thermometer_bits)
    return booleanizer.transform(x), y, booleanizer
