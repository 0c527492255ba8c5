"""Device meshes of the port and the batch-axis rule, the port of the
mesh half of ``repro.dist.sharding``.

A ``Mesh`` is a grid of ``torch.device``s with named axes (``data``,
``model``, optionally ``pod``).  One process drives every device of it:
the class x batch split of the TM executor and train step needs no
collective for serving and only a sum of integer deltas for training, so
there is no ``torch.distributed`` here.

A device may appear more than once in the grid.  Torch has one CPU
device, so a (2, 2) mesh on the CPU is four tiles of that one device
(the counterpart of the reference tests' forced host devices); on a
single card the same logical mesh runs the class and batch split on
that card.

    mesh = make_mesh((2, 2))                  # the card(s); raises without one
    mesh = make_mesh((2, 2), devices="cpu")   # four tiles of the CPU

``batch_axes`` keeps the reference's semantics.  The parameter,
optimizer and cache rules of the reference (``hint``,
``param_shardings``, ...) belong to the LM scaffolding and are not here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


def _pad_to(x: int, mult: int) -> int:
    """``x`` rounded up to a multiple of ``mult`` (``configs.base._pad_to``)."""
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array of
    ``torch.device`` whose shape is the mesh's, one name per axis."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> dict:
        """axis name -> size (as the reference mesh's ``shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        """Where results of a sharded call are assembled."""
        return self.devices.flat[0]

    def device_at(self, coords: dict) -> torch.device:
        """The device at the named coordinates; unnamed axes take 0."""
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str] = ("data", "model"),
    devices=None,
) -> Mesh:
    """A mesh of ``shape`` with ``axis_names``.

    ``devices`` is ``None`` (the CUDA cards, tile ``i`` on card ``i %
    device_count()``; raises without a card), one device for every tile
    (``"cpu"``, ``"cuda:0"``, a ``torch.device``), or one device per tile
    in row-major order."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axis names repeat: {axis_names}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    n = int(np.prod(shape))
    if devices is None:
        first = resolve_device(None)  # raises without a card
        count = torch.cuda.device_count()
        flat = [torch.device("cuda", (first.index + i) % count) for i in range(n)]
    elif isinstance(devices, (str, torch.device)):
        flat = [resolve_device(devices)] * n
    else:
        flat = [resolve_device(d) for d in np.asarray(devices, dtype=object).flat]
        if len(flat) != n:
            raise ValueError(f"{len(flat)} devices for a mesh of {n} tiles")
    grid = np.empty(n, dtype=object)
    grid[:] = flat
    return Mesh(grid.reshape(shape), axis_names)


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def batch_axes(mesh, B: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes the batch dim shards over, major-to-minor.

    Every non-``model`` axis is taken in mesh order while the running
    product still divides ``B`` — so a (pod, data, model) mesh yields
    ("pod", "data"), a (data, model) mesh yields ("data",), and a batch
    too small for the leading axis stays replicated (None)."""
    sizes = _axis_sizes(mesh)
    chosen = []
    prod = 1
    for name in mesh.axis_names:
        if name == "model":
            continue
        if B % (prod * sizes[name]) == 0:
            chosen.append(name)
            prod *= sizes[name]
        else:
            break
    return tuple(chosen) if chosen else None


def batch_shards(mesh, B: int) -> Tuple[Tuple[dict, int], ...]:
    """((coords of the batch axes, linear shard index), ...) for every
    batch shard of a ``B``-row batch, the index major-to-minor over
    ``batch_axes`` in mesh order (one shard at index 0 when the batch is
    replicated)."""
    bx = batch_axes(mesh, B) or ()
    sizes = _axis_sizes(mesh)
    shards = []
    for i, flat in enumerate(np.ndindex(*(sizes[a] for a in bx))):
        shards.append((dict(zip(bx, flat)), i))
    return tuple(shards)
