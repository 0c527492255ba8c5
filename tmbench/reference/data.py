"""Datapoints of a configuration, made from a seed on any device.

A frozen copy of the port's synthetic TM data (``data/pipeline.py``
``make_tm_dataset``, ``core/booleanize.py`` ``Booleanizer``): per-class
Gaussian prototypes keyed by the dataset's name (a CRC, so the same
prototypes on every machine), samples ``prototype[y] + 0.6 * noise``, and
a quantile thermometer code of ``bits`` bits per raw feature.  The
samples are drawn with a ``torch.Generator`` on the device in large
blocks, not with NumPy, so that a pool of a quarter of a million rows
takes a fraction of a second to make; the distribution is the port's.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

NOISE = 0.6  # the port's noise scale around a class prototype


def sub_seed(seed: int, tag: str) -> int:
    """An independent 63-bit seed for one named stream of a run."""
    return (int(seed) * 1_000_003 + zlib.crc32(tag.encode())) % (2**63)


def generator(device, seed: int, tag: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def prototypes(dataset: str, n_classes: int, n_raw: int) -> np.ndarray:
    """float64[M, F_raw]: the class prototypes of ``dataset`` (by name)."""
    rng = np.random.default_rng(zlib.crc32(dataset.encode()) % (2**31))
    return rng.normal(size=(n_classes, n_raw))


def sample(protos: torch.Tensor, y: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """float32[n, F_raw] raw features of the classes ``y``."""
    noise = torch.randn(
        (y.numel(), protos.shape[1]), generator=gen, device=protos.device
    )
    return protos[y] + NOISE * noise


class Thermometer:
    """Quantile thermometer code: raw feature i becomes bits
    ``x_i > t_i1, ..., x_i > t_ib`` at the interior quantiles."""

    def __init__(self, thresholds: torch.Tensor):
        self.thresholds = thresholds  # float32[F_raw, bits]

    @staticmethod
    def fit(x: torch.Tensor, bits: int) -> "Thermometer":
        qs = torch.linspace(0.0, 1.0, bits + 2, device=x.device)[1:-1]
        return Thermometer(torch.quantile(x, qs, dim=0).T.contiguous())

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """float32[n, F_raw] -> uint8[n, F_raw * bits] of {0, 1}."""
        b = x[:, :, None] > self.thresholds[None]
        return b.reshape(x.shape[0], -1).to(torch.uint8)


class DataSource:
    """The datapoints of one configuration for one seed: a booleanizer fit
    on a seeded sample, then rows of given classes or of random classes."""

    FIT_ROWS = 8192

    def __init__(self, config: dict, seed: int, device):
        self.device = torch.device(device)
        self.n_classes = int(config["n_classes"])
        protos = prototypes(
            config["dataset"], self.n_classes, int(config["n_raw_features"])
        )
        self.protos = torch.from_numpy(protos).float().to(self.device)
        self.seed = seed
        g = generator(self.device, seed, "fit")
        y = torch.randint(
            0, self.n_classes, (self.FIT_ROWS,), generator=g, device=self.device
        )
        self.booleanizer = Thermometer.fit(
            sample(self.protos, y, g), int(config["thermometer_bits"])
        )

    def rows_of(self, y: torch.Tensor, tag: str) -> torch.Tensor:
        """uint8[len(y), F] datapoints of the classes ``y``."""
        g = generator(self.device, self.seed, tag)
        return self.booleanizer.transform(sample(self.protos, y, g))

    def pool(self, n_rows: int, block: int = 32768) -> np.ndarray:
        """uint8[n_rows, F] on the host: rows of seeded random classes,
        made on the device ``block`` rows at a time."""
        g = generator(self.device, self.seed, "pool")
        out = None
        for lo in range(0, n_rows, block):
            n = min(block, n_rows - lo)
            y = torch.randint(
                0, self.n_classes, (n,), generator=g, device=self.device
            )
            rows = self.booleanizer.transform(sample(self.protos, y, g)).cpu().numpy()
            if out is None:
                out = np.empty((n_rows, rows.shape[1]), np.uint8)
            out[lo:lo + n] = rows
        return out
