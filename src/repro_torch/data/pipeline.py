"""TM edge datasets (paper Table 2 dimensionalities), the TM half of
``repro.data.pipeline``: numpy, synthetic, nothing is downloaded, and the
same arrays as the reference for the same arguments.

Feature/class counts follow the public UCI datasets the paper evaluates
(EMG [10], Human Activity [19], Gesture Phase [14], Sensorless Drives [4],
Gas Sensor Array Drift [24]); the data itself is synthesized with
per-class Gaussian prototypes plus noise, so the pipeline is
self-contained and offline.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Tuple

import numpy as np


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
