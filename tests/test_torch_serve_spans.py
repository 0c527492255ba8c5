"""The serving path's span log (``ServeMetrics`` spans) on the CPU
(``device="cpu"``): nothing is recorded or allocated without a profiler;
under one, started on the main thread while the scheduler's thread
serves, every batch is tiled by its five children, requests are children
of the batch that completed them, the ring counts what it overwrites,
and ``profiler_offset_ns()`` puts the spans on the profiler's clock.
"""

import threading

import numpy as np
import pytest
import torch
from torch.autograd import profiler as torch_profiler

from repro_torch.accel import Accelerator
from repro_torch.core import compress, tm
from repro_torch.serve_tm.metrics import SPAN_DTYPE, ServeMetrics, Span

M, C, F = 5, 10, 30
CHILDREN = ("batch.lock_wait", "batch.fill", "batch.launch", "batch.sync",
            "batch.demux")


def _accelerator():
    rng = np.random.default_rng(0)
    acts = rng.random((M, C, 2 * F)) < 0.08
    model = compress.encode(tm.TMConfig(M, C, F), acts)
    acc = Accelerator.for_models([model], batch_words=8, device="cpu")
    acc.load("s", acc.compile(model))
    return acc, rng


def _serve(acc, rng, n=40):
    """Submit ``n`` requests of 1-99 rows from this thread; the running
    scheduler serves them.  -> their handles, each done."""
    handles = [acc.submit("s", rng.integers(0, 2, (int(b), F), dtype=np.uint8))
               for b in rng.integers(1, 100, n)]
    for h in handles:
        h.wait(timeout=60)
    return handles


def _profile_all_threads():
    """A CPU profile that also records the scheduler thread's operators."""
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True),
    )


@pytest.fixture
def served():
    """(accelerator, handles, profile) of a served run under a CPU
    profile started on the main thread."""
    acc, rng = _accelerator()
    acc.start()
    try:
        _serve(acc, rng, 4)  # warm, before the profile: no spans
        assert acc.metrics.spans().size == 0
        with _profile_all_threads() as prof:
            handles = _serve(acc, rng)
    finally:
        acc.stop()
    return acc, handles, prof


def _length(s):
    return int(s["end_ns"]) - int(s["start_ns"])


def test_no_profiler_records_nothing():
    acc, rng = _accelerator()
    acc.start()
    try:
        handles = _serve(acc, rng)
    finally:
        acc.stop()
    assert all(h.status == "done" for h in handles)
    assert acc.metrics.batches > 0
    assert acc.metrics._ring is None
    assert acc.metrics.spans().size == 0 and acc.metrics.spans_dropped == 0


def test_profiler_flag_is_seen_on_every_thread():
    """The served path's switch is the module flag, which every thread
    sees while a profile runs; ``torch.autograd._profiler_enabled()``
    is not (it is false on the scheduler's thread)."""
    seen = {}

    def look():
        seen["flag"] = torch_profiler._is_profiler_enabled

    assert torch_profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t = threading.Thread(target=look)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert torch_profiler._is_profiler_enabled is True
    assert seen == {"flag": True}
    assert torch_profiler._is_profiler_enabled is False


def test_children_tile_each_batch(served):
    acc, _, _ = served
    metrics = acc.metrics
    spans = metrics.spans()
    batches = spans[spans["name"] == "batch"]
    assert batches.size >= 2
    for b in batches:
        children = spans[(spans["parent"] == b["id"])
                         & (spans["name"] != "request")]
        assert tuple(children["name"]) == CHILDREN
        assert (children["tag"] == b["tag"]).all()
        assert children["start_ns"][0] == b["start_ns"]
        assert children["end_ns"][-1] == b["end_ns"]
        covered = sum(_length(c) for c in children)
        assert abs(covered - _length(b)) <= 0.02 * _length(b)
        launch, sync = children[2], children[3]
        engine_s = metrics.engine_s[int(b["tag"]) - 1]
        assert abs((_length(launch) + _length(sync)) / 1e9 - engine_s) <= 0.02 * engine_s
        # the batch carries its rows, the fill the bytes it wrote
        assert children[1]["arg"] == acc.engine.staging.nbytes + b["arg"] * F
    assert (spans[spans["name"] == "front_door"]["cpu_ns"] >= 0).all()


def test_request_spans_name_rid_and_batch(served):
    acc, handles, _ = served
    spans = acc.metrics.spans()
    requests = spans[spans["name"] == "request"]
    by_rid = {int(r["tag"]): r for r in requests}
    assert set(by_rid) == {h.rid for h in handles}
    front = spans[spans["name"] == "front_door"]
    assert set(front["tag"].tolist()) == set(by_rid)
    ids = {int(s["id"]): s for s in spans}
    for h in handles:
        r = by_rid[h.rid]
        assert r["arg"] == h.n_rows
        assert _length(r) == pytest.approx(h.latency_s * 1e9, abs=1e3)
        batch = ids[int(r["parent"])]
        assert batch["name"] == "batch"
        demux = spans[(spans["parent"] == batch["id"])
                      & (spans["name"] == "batch.demux")][0]
        assert demux["start_ns"] <= r["end_ns"] <= demux["end_ns"]


def test_ring_counts_what_it_overwrites():
    m = ServeMetrics()
    m.span_capacity = 64
    for i in range(200):
        m.record_span(Span.LOOP_WAIT, (1000 + i, 0), (2000 + i, 7), tag=i)
    assert m.spans_dropped == 200 - 64
    assert m.spans_dropped_until_ns == 2000 + 135
    kept = m.spans()
    assert kept.dtype == SPAN_DTYPE
    assert kept["id"].tolist() == list(range(136, 200))
    assert kept["tag"].tolist() == list(range(136, 200))
    assert (kept["cpu_ns"] == 7).all() and (kept["name"] == "loop.wait").all()
    assert m.spans(1000 + 150, 1000 + 159)["id"].tolist() == list(range(150, 160))


def test_profiler_events_fall_inside_launch(served):
    """``profiler_offset_ns()`` maps the profiler's events onto the spans'
    clock: the operators of ``pack_literals`` (``literals``' stack) run
    inside ``batch.launch``."""
    acc, _, prof = served
    offset = acc.metrics.profiler_offset_ns()
    spans = acc.metrics.spans()
    launch = spans[spans["name"] == "batch.launch"]
    stacks = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::stack"]
    assert len(stacks) >= launch.size
    for e in stacks:
        start, end = e.start_ns() - offset, e.end_ns() - offset
        assert ((launch["start_ns"] <= start) & (end <= launch["end_ns"])).any()
