"""Booleanization: raw features -> Boolean features (paper Fig 2, top), the
port of ``repro.core.booleanize``.

Two standard schemes used across the TM literature:
  * threshold: per-feature mean/quantile thresholding -> 1 bit/feature
  * thermometer: per-feature quantile bins, unary ("thermometer") code ->
    ``bits`` bits/feature — the scheme REDRESS [15] and MATADOR [18] use for
    the UCI edge datasets.

Fitting and transforming are numpy on the host, as in the reference;
``to_device_bool`` moves a result to the device (the CUDA card unless
``device="cpu"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class Booleanizer:
    """Fitted thermometer/threshold booleanizer (host-side, NumPy)."""

    thresholds: np.ndarray  # [F_raw, bits]
    bits: int

    @property
    def n_boolean_features(self) -> int:
        return self.thresholds.shape[0] * self.bits

    @staticmethod
    def fit(x: np.ndarray, bits: int = 1) -> "Booleanizer":
        """x: float[N, F_raw]; quantile thermometer with ``bits`` levels."""
        qs = np.linspace(0.0, 1.0, bits + 2)[1:-1]  # interior quantiles
        th = np.quantile(x, qs, axis=0).T  # [F_raw, bits]
        return Booleanizer(thresholds=np.ascontiguousarray(th), bits=bits)

    def transform(self, x: np.ndarray) -> np.ndarray:
        """float[N, F_raw] -> uint8[N, F_raw*bits] in {0,1}."""
        b = (x[:, :, None] > self.thresholds[None, :, :]).astype(np.uint8)
        return b.reshape(x.shape[0], -1)


def booleanize_images(x: np.ndarray, threshold: float = 0.3) -> np.ndarray:
    """MNIST-style fixed-threshold booleanization (paper's MNIST example)."""
    return (x > threshold).astype(np.uint8)


def to_device_bool(x: np.ndarray, device=None) -> torch.Tensor:
    """{0,1} array -> bool tensor on ``device`` (the card by default)."""
    return torch.as_tensor(np.asarray(x), device=resolve_device(device)).to(torch.bool)
