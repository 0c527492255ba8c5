"""Production mesh construction and the process group, the port of
``repro.launch.mesh``.

Meshes are built inside functions, on ``dist.sharding.make_mesh``.  With
no process group they are logical meshes: the CUDA cards by default
(raises without one), tile ``i`` on card ``i % device_count()``, so on
one card the (16, 16) mesh is 256 tiles of that card; ``devices="cpu"``
puts every tile on the CPU.  Once ``init_distributed`` has started a
process group they are rank meshes: one process per tile, its world
size the mesh's size.

    python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \\
        --mesh 2x2 --arch stablelm-3b-smoke [--device cpu]
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch

from ..device import resolve_device
from ..dist.sharding import make_mesh


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def init_distributed(device=None, *, init_method: str = None, rank: int = None,
                     world_size: int = None, local_rank: int = None,
                     timeout_s: float = 600.0) -> dict:
    """Start this process's ``torch.distributed`` group (once; a second
    call checks the group against ``device`` and returns).

    Rank, world size and local rank come from the arguments or from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``);
    the rendezvous is ``init_method`` (e.g. a ``file://`` store) or
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).  ``device=None`` is this
    rank's card under NCCL (``cuda:{LOCAL_RANK}`` made current and passed
    as ``device_id``; raises without a card); ``"cpu"`` runs under gloo.
    Returns ``{"rank", "world_size", "local_rank", "backend", "device"}``."""
    dist = torch.distributed
    if _distributed():
        dev = resolve_device(device)
        backend = dist.get_backend()
        want = "gloo" if dev.type == "cpu" else "nccl"
        if backend != want:
            raise ValueError(f"the process group runs {backend}; {dev} needs {want}")
        return {"rank": dist.get_rank(), "world_size": dist.get_world_size(),
                "local_rank": int(os.environ.get("LOCAL_RANK", dist.get_rank())),
                "backend": backend, "device": dev}
    env = os.environ
    rank = int(env["RANK"]) if rank is None and "RANK" in env else rank
    world_size = (int(env["WORLD_SIZE"]) if world_size is None and "WORLD_SIZE" in env
                  else world_size)
    if rank is None or world_size is None:
        raise RuntimeError("init_distributed needs a rank and a world size: launch "
                           "with python -m torch.distributed.run, or pass them")
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if device is None:
        if not torch.cuda.is_available():
            resolve_device(None)  # raises: no card, and no quiet CPU run
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=timeout_s),
                            **kw)
    return {"rank": rank, "world_size": world_size, "local_rank": local_rank,
            "backend": backend, "device": dev}


def make_production_mesh(*, multi_pod: bool = False, devices=None):
    """16x16 single pod (256 chips) or 2x16x16 multi-pod (512 chips); a
    rank mesh under a process group.

    Axes: pod = cross-pod data parallelism, data = in-pod DP/FSDP,
    model = TP/EP.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices, distributed=_distributed())


def make_test_mesh(n_data: int = 2, n_model: int = 2, devices=None):
    """Small mesh for CI-scale sharding tests; a rank mesh under a
    process group."""
    return make_mesh((n_data, n_model), ("data", "model"), devices=devices,
                     distributed=_distributed())
