"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
Libraries land in ``build/kernels/`` at the root of the checkout, named by
a hash of their source and flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing is built at import: the first
launch builds, or ``build()`` builds every source at once (one ``nvcc``
process per source, all started together).

The serving nodes of a fleet launch kernels from one scheduler thread
each, so ``build`` and ``load`` run under one lock (two threads that
first launch one kernel at once build it once), and every kernel module's
``launches`` counter is added to under another (``count_launches``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_build_lock = threading.RLock()  # load holds it across its build
_libs: Dict[str, ctypes.CDLL] = {}
_launch_lock = threading.Lock()


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or the
    toolkit's usual install prefix.  Raises when there is none."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME); the CUDA "
        "kernels are built on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source (default: all of ``csrc/``) that has no
    library yet, all ``nvcc`` processes at once.  Returns name -> the
    compiler's output (``-Xptxas -v`` register and shared-memory report;
    empty when the library was already built).  Raises with the
    compiler's output when a build fails."""
    names = kernel_names() if names is None else list(names)
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        logs = {name: "" for name in names}
        try:
            for name in names:
                out = library_path(name)
                if out.exists():
                    continue
                tmp = out.with_name(
                    f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp"
                )
                cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ), tmp, out)
            for name, (proc, tmp, out) in procs.items():
                logs[name] = proc.communicate()[0]
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on csrc/{name}.cu (exit "
                        f"{proc.returncode}):\n{logs[name]}"
                    )
                os.replace(tmp, out)
        finally:
            for proc, tmp, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if tmp.exists():
                    tmp.unlink()
        return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first use, once
    whatever the number of threads asking).  Every source exports
    ``<name>_error_string``, CUDA's text for an error code, which
    ``raise_on`` reads."""
    with _build_lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            text = getattr(lib, f"{name}_error_string")
            text.argtypes = [ctypes.c_int]
            text.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def count_launches(module: str, n: int) -> None:
    """Add ``n`` to the ``launches`` counter of the kernel module named
    ``module`` (its ``__name__``).  ``launches += n`` is a
    read-modify-write that loses counts when several threads launch at
    once; here it runs under one lock."""
    mod = sys.modules[module]
    with _launch_lock:
        mod.launches += n


def raise_on(name: str, err: int, what: str) -> None:
    """Raise when a launch entry of ``csrc/<name>.cu`` returned a CUDA
    error code (0 is success)."""
    if err:
        msg = getattr(load(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} {what} launch failed: {msg} ({err})")


def attributes(name: str, which: int) -> Dict[str, int]:
    """Registers and local (spill) bytes per thread and static shared
    bytes of kernel ``which`` of ``csrc/<name>.cu``, as
    ``cudaFuncGetAttributes`` reads them from the loaded library (a
    source that offers them exports ``<name>_attributes``)."""
    fn = getattr(load(name), f"{name}_attributes")
    fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    vals = [ctypes.c_int() for _ in range(3)]
    raise_on(name, fn(which, *vals), "attributes")
    keys = ("regs", "local_bytes", "shared_bytes")
    return dict(zip(keys, (v.value for v in vals)))


def stream(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device`` as a raw handle for a
    launch entry, read without building a ``torch.cuda.Stream`` object,
    which costs more host time than a small kernel runs."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))
