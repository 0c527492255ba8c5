"""Where the port runs: one rule for every entry point.

``Accelerator``, ``TMServer`` and ``make_engine`` run on the CUDA card
unless the caller asks for the CPU with ``device="cpu"``.  With no card
and no explicit ``"cpu"`` they raise: the port never falls back to the
CPU on its own, so a run that was meant for the card cannot silently
measure the CPU instead.

``"meta"`` (asked for by name only) is the dry run's device
(``launch.dryrun``): shapes and dtypes without storage, so a full-width
step is traced without placing anything anywhere.

Under an initialised ``torch.distributed`` process group (one process
per card, ``launch.mesh.init_distributed``), the default is this rank's
card: ``cuda:{LOCAL_RANK}``, the card ``init_distributed`` made current.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, or this rank's card
    (``LOCAL_RANK``) under an initialised process group (raises without
    a card);
    ``"cpu"`` / ``"meta"`` / ``"cuda"`` / ``"cuda:N"`` / a ``torch.device``
    -> itself, with a CUDA index filled in.  Any other device type
    raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            local = os.environ.get("LOCAL_RANK")
            if local is not None:
                return torch.device("cuda", int(local))
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type in ("cpu", "meta"):
        return dev
    if dev.type != "cuda":
        raise ValueError(
            f"unsupported device {dev}; the port runs on 'cuda' or 'cpu' "
            "(or traces on 'meta')"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run the port on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
