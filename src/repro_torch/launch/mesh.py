"""Production mesh construction, the port of ``repro.launch.mesh``.

Meshes are built inside functions, on ``dist.sharding.make_mesh``: the
CUDA cards by default (raises without one), tile ``i`` on card ``i %
device_count()``, so on one card the (16, 16) mesh is 256 tiles of that
card; ``devices="cpu"`` puts every tile on the CPU.
"""

from __future__ import annotations

from ..dist.sharding import make_mesh


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    """16x16 single pod (256 chips) or 2x16x16 multi-pod (512 chips).

    Axes: pod = cross-pod data parallelism, data = in-pod DP/FSDP,
    model = TP/EP.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)


def make_test_mesh(n_data: int = 2, n_model: int = 2, devices=None):
    """Small mesh for CI-scale sharding tests."""
    return make_mesh((n_data, n_model), ("data", "model"), devices=devices)
