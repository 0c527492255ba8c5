"""The readers of the program's span log: the means over a window, the
device trace mapped onto the spans' clock, the clocks' drift and the
windows that are never read."""

from types import SimpleNamespace

import numpy as np
import pytest

from tmbench import harness, spans
from tmbench.trace import DeviceEvent

MS = 1_000_000  # ns
OFFSET = 1_000 * 10**9  # the profiler's clock, ns ahead of the spans'


def _span_log(capacity=None):
    """A program's ``ServeMetrics`` whose clock offset reads ``OFFSET``."""
    from repro_torch.serve_tm.metrics import ServeMetrics

    m = ServeMetrics()
    if capacity:
        m.span_capacity = capacity

    def offset():
        m.span_offsets_ns.append((0, OFFSET))
        return OFFSET

    m.profiler_offset_ns = offset
    return m


def _batch(m, seq, t0_ms, parts_ms, cpu_ms):
    """A batch at ``t0_ms`` tiled by children of ``parts_ms`` ms (lock
    wait, fill, launch, sync, demux) whose thread ran ``cpu_ms``."""
    from repro_torch.serve_tm.metrics import Span

    bounds = [int(t0_ms * MS)]
    for p in parts_ms:
        bounds.append(bounds[-1] + int(p * MS))
    b = m.record_span(Span.BATCH, (bounds[0], 0), (bounds[-1], int(cpu_ms * MS)), tag=seq)
    names = (Span.LOCK_WAIT, Span.FILL, Span.LAUNCH, Span.SYNC, Span.DEMUX)
    for name, a, z in zip(names, bounds, bounds[1:]):
        m.record_span(name, (a, 0), (z, 0), parent=b, tag=seq)
    return bounds


def _dev(a_ms, z_ms):
    """A device operation from ``a_ms`` to ``z_ms`` on the spans' clock."""
    return DeviceEvent("k", (a_ms * MS + OFFSET) / 1e9, (z_ms * MS + OFFSET) / 1e9)


def _span_run(m, events):
    return SimpleNamespace(start=1.0, end=2.0, events=events,
                           clients=SimpleNamespace(acc=SimpleNamespace(metrics=m)))


def _served_window():
    """Two batches in the window [1 s, 2 s], a loop wait between them and
    one batch before it; the trace's steady slice is [1.1 s, 1.9 s]."""
    from repro_torch.serve_tm.metrics import Span

    m = _span_log()
    _batch(m, 1, 500, (50, 50, 50, 50, 50), 250)  # before the window
    _batch(m, 2, 1120, (1, 3, 4, 1, 1), 8)
    m.record_span(Span.LOOP_WAIT, (1130 * MS, 0), (1200 * MS, 0))
    _batch(m, 3, 1200, (2, 6, 8, 2, 2), 10)
    m.record_span(Span.LOOP_YIELD, (1220 * MS, 0), (1220 * MS + MS // 2, 0))
    m.record_span(Span.FRONT_DOOR, (1150 * MS, 0), (1150 * MS + 20_000, 0), tag=7)
    m.record_span(Span.FRONT_DOOR, (1160 * MS, 0), (1160 * MS + 40_000, 0), tag=8)
    events = [_dev(1000, 1001),  # these two set the steady slice's ends
              _dev(1125, 1126), _dev(1126.5, 1127), _dev(1128, 1128.5),
              _dev(1129, 1129.2),  # ends 0.2 ms after its batch's sync
              _dev(1208.5, 1212), _dev(1212.5, 1215), _dev(1216, 1217),
              _dev(1999, 2000)]
    return _span_run(m, events)


def _read(name, run):
    return harness.reader("layer_metrics", name)(run)


def test_span_readers_take_means_over_the_window():
    run = _served_window()
    assert _read("front_door_us", run) == pytest.approx(30.0)
    assert _read("lock_wait_ms_per_batch", run) == pytest.approx(1.5)
    assert _read("fill_ms_per_batch.bulk", run) == pytest.approx(4.5)
    assert _read("launch_ms_per_batch", run) == pytest.approx(6.0)
    assert _read("demux_ms_per_batch", run) == pytest.approx(1.5)
    assert _read("batch_oncpu", run) == pytest.approx(18 / 30)


def test_span_readers_against_the_trace():
    """Device operations and idle time on the profiler's clock, in the
    steady slice [1.1 s, 1.9 s]: seven operations in two batches, one of
    them ending past its batch's device wait; of the slice's 790.8 ms of
    idle, 7.8 ms lie in the first batch (10 ms, 2.2 ms busy), 13 ms in
    the second (20 ms, 7 ms busy) and 70 ms in the loop's wait."""
    run = _served_window()
    assert _read("ops_per_batch", run) == pytest.approx(3.5)
    assert _read("idle_in_batch", run) == pytest.approx((7.8 + 13) / 790.8)
    report = spans.report(run)
    assert report["clocks_agree"] == pytest.approx(6 / 7) and report["ops"] == 7
    assert report["idle_under"]["loop.wait"] == pytest.approx(70 / 790.8)
    assert report["idle_under"]["unattributed"] == pytest.approx(
        1 - (7.8 + 13 + 70) / 790.8)
    assert report["idle_under"]["unspanned"] == pytest.approx(
        1 - (7.8 + 13 + 70 + 0.5) / 790.8)
    assert report["oncpu"]["batch"] == pytest.approx(18 / 30)


def test_span_offset_follows_the_clocks_drift():
    """The offset is drawn straight between the log's first reading and
    the one taken when read."""
    m = _span_log()
    m.span_offsets_ns[:] = [(1000, OFFSET)]
    m.profiler_offset_ns = lambda: m.span_offsets_ns.append((3000, OFFSET + 400))
    s = np.zeros(1, dtype=[("start_ns", np.int64), ("end_ns", np.int64)])
    s["start_ns"], s["end_ns"] = 2000, 3000
    got = spans.on_profiler_clock(_span_run(m, []), s)[0]
    assert got[0] * 1e9 == pytest.approx(2000 + OFFSET + 200, abs=1e-3)
    assert got[1] * 1e9 == pytest.approx(3000 + OFFSET + 400, abs=1e-3)


def test_span_readers_read_no_partial_window():
    from repro_torch.serve_tm.metrics import Span

    names = ("front_door_us", "lock_wait_ms_per_batch", "fill_ms_per_batch",
             "launch_ms_per_batch", "demux_ms_per_batch", "batch_oncpu",
             "ops_per_batch", "idle_in_batch")
    events = [_dev(1000, 1001), _dev(1125, 1126), _dev(1999, 2000)]
    m = _span_log(capacity=8)
    _batch(m, 1, 900, (1, 1, 1, 1, 1), 5)  # six spans before the window
    _batch(m, 2, 1120, (1, 3, 4, 1, 1), 8)  # overwrites four of them
    m.record_span(Span.FRONT_DOOR, (1150 * MS, 0), (1150 * MS + 20_000, 0))
    assert m.spans_dropped == 5
    assert _read("lock_wait_ms_per_batch", _span_run(m, events)) == pytest.approx(1.0)
    _batch(m, 3, 1200, (2, 6, 8, 2, 2), 10)  # overwrites spans of the window
    run = _span_run(m, events)
    assert all(_read(n, run) is None for n in names)
    # a program without a span log, or a window without spans
    assert all(_read(n, SimpleNamespace(start=1.0, end=2.0, events=events)) is None
               for n in names)
    assert all(_read(n, _span_run(_span_log(), events)) is None for n in names)
