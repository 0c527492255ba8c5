"""The port's kernel layer under several threads, as a fleet's scheduler
loops drive it: two threads that first launch one kernel at once build
and load its library once, and the kernels' ``launches`` counters lose no
count."""

import importlib
import sys
import threading
import time
import types

import pytest

from repro_torch.kernels import _build

KERNEL_MODULES = ["clause_eval", "clause_matmul", "clause_table", "interp_stream",
                  "tm_interp", "tm_popcount", "tm_train"]


def _run(n, target):
    barrier = threading.Barrier(n)

    def body():
        barrier.wait(timeout=10)
        target()

    threads = [threading.Thread(target=body) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


def test_load_builds_and_loads_once_under_eight_threads(monkeypatch):
    guard = threading.Lock()
    inside, peak, builds, loads, libs = [0], [0], [], [], []

    def fake_build(names=None):
        with guard:
            inside[0] += 1
            peak[0] = max(peak[0], inside[0])
        time.sleep(0.05)  # a build long enough for the others to arrive
        builds.append(list(names))
        with guard:
            inside[0] -= 1
        return {}

    def fake_cdll(path):
        loads.append(path)
        return types.SimpleNamespace(tm_popcount_error_string=types.SimpleNamespace())

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(_build, "_libs", {})
    _run(8, lambda: libs.append(_build.load("tm_popcount")))
    assert builds == [["tm_popcount"]] and peak[0] == 1
    assert loads == [str(_build.library_path("tm_popcount"))]
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)


@pytest.mark.parametrize("name", KERNEL_MODULES)
def test_launch_counters_lose_no_count_under_eight_threads(monkeypatch, name):
    module = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
    monkeypatch.setattr(module, "launches", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        _run(8, lambda: [_build.count_launches(module.__name__, 1)
                         for _ in range(10_000)])
    finally:
        sys.setswitchinterval(interval)
    assert module.launches == 80_000
    _build.count_launches(module.__name__, 2)  # one thread: exactly its counts
    assert module.launches == 80_002
