"""The class-sharded Tsetlin Machine train step, the port of
``repro.dist.steps.make_tm_train_step`` (the Fig-8 training node scaled
out over a mesh of the port).

TA state shards its class dim over ``model``; the batch shards over the
non-``model`` axes (``sharding.batch_axes``).  Tile (batch shard ``b``,
class slice ``m``) computes the summed-delta feedback of its batch rows
restricted to its class rows (``core.train.class_slice_delta``, the sum
of the reference's per-sample ``sample_class_delta``) on its device; the
deltas of one class slice are summed across its batch tiles on the
slice's home device (the reference's ``psum``) and one clipped update is
applied.  Integer deltas commute, so the result equals
``core.train.train_batch_parallel`` bit for bit on any mesh.

The LM step functions of the reference (``make_train_step``,
``make_prefill_step``, ``make_decode_step``) belong to the LM scaffolding
and are not here.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.tm import TMConfig
from ..core.train import class_slice_delta, sample_keys
from .sharding import _axis_sizes, batch_shards
from .tm_sharded import _on


def _as_tensor(x, dtype) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, dtype))


class TMTrainStep:
    """``make_tm_train_step``'s step.  ``step(state, key, xb, yb)`` takes
    and returns the canonical ``int32[M, C, 2F]`` state (on the state's
    device); ``split``/``step_slices``/``join`` keep each class slice on
    its home device between steps (the train engine's representation)."""

    def __init__(self, tm_cfg: TMConfig, mesh, batch: int):
        sizes = _axis_sizes(mesh)
        n_model = sizes.get("model", 1)
        M = tm_cfg.n_classes
        if M % n_model:
            raise ValueError(
                f"the model axis size ({n_model}) must divide n_classes={M} "
                f"for the class-sharded TM train step; pad the config or "
                f"shrink the mesh"
            )
        self.cfg, self.mesh, self.batch = tm_cfg, mesh, int(batch)
        self.n_model = n_model
        self.m_local = M // n_model
        self.shards = batch_shards(mesh, self.batch)

    def tile_device(self, coords: dict, m: int) -> torch.device:
        return self.mesh.device_at({**coords, "model": m})

    def home(self, m: int) -> torch.device:
        """The device class slice ``m`` lives on between steps (its tile
        at batch shard 0, whatever the batch)."""
        return self.mesh.device_at({"model": m})

    def split(self, state) -> Tuple[torch.Tensor, ...]:
        """Canonical state -> fresh int32 class slices on their homes."""
        state = _as_tensor(state, np.int32)
        ml = self.m_local
        return tuple(
            state[m * ml:(m + 1) * ml].to(self.home(m), torch.int32, copy=True)
            for m in range(self.n_model)
        )

    @staticmethod
    def join(slices: Sequence[torch.Tensor], device) -> torch.Tensor:
        """Class slices -> the canonical state on ``device``."""
        return torch.cat([s.to(device) for s in slices])

    def step_slices(self, slices, key, xb, yb) -> Tuple[torch.Tensor, ...]:
        """One summed-delta update of the class slices under call key
        ``key``: global sample ``i`` trains under ``fold_in(key, i)``."""
        xb, yb = _as_tensor(xb, np.uint8), _as_tensor(yb, np.int32)
        if xb.shape[0] != self.batch:
            raise ValueError(
                f"the step was built for batch {self.batch}, got {xb.shape[0]}"
            )
        B_l = self.batch // len(self.shards)
        N = self.cfg.n_states
        new = []
        for m, state_m in enumerate(slices):
            total = None
            for coords, shard in self.shards:
                d = self.tile_device(coords, m)
                rows = slice(shard * B_l, (shard + 1) * B_l)
                with _on(d):
                    keys = sample_keys(key.to(d), B_l, offset=shard * B_l)
                    delta = class_slice_delta(
                        self.cfg, state_m.to(d), m * self.m_local, keys,
                        xb[rows].to(d), yb[rows].to(d),
                    ).to(state_m.device)
                total = delta if total is None else total + delta
            new.append((state_m + total).clamp(1, 2 * N))
        return tuple(new)

    def __call__(self, state, key, xb, yb) -> torch.Tensor:
        state = _as_tensor(state, np.int32)
        return self.join(self.step_slices(self.split(state), key, xb, yb),
                         state.device)


def make_tm_train_step(tm_cfg: TMConfig, mesh, *, batch: int) -> TMTrainStep:
    """-> step(state, key, xb, yb) -> state, sharded over ``mesh``.

    ``state`` int32[M, C, 2F] shards classes over ``model``; ``xb``/``yb``
    shard their leading dim over the non-``model`` axes.  Each tile
    computes the summed-delta feedback of its batch shard restricted to
    its class rows, the deltas are summed over the batch shards, and one
    clipped update is applied.  Global sample ``i`` (its position in the
    unsharded batch) trains under ``fold_in(key, i)``, so the result
    equals ``train_batch_parallel(cfg, state, key, xb, yb)`` bit for bit
    whatever the mesh.  Raises ``ValueError`` when the ``model`` axis
    does not divide ``n_classes``."""
    return TMTrainStep(tm_cfg, mesh, batch)
