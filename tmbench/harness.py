"""One run of one cell: set-up, the measured window, the check, the
result line.

``BENCHMARK.json`` names the cell; the cell names a configuration (its
``file``) and a traffic mix (``traffic/<name>.json``); each metric is
read by ``end_to_end/<name>.py`` or ``layer_metrics/<name>.py``, whose
``read(run)`` returns a number or None (nothing to read: the metric is
left out of the line).  A quantity reported under different end-to-end
metrics in different cells is split by name, ``<quantity>.<part>``; a
split name without a reader of its own is read by the quantity's reader
(of either kind).  A metric with a ``workloads`` list is reported in
those cells alone.  The window is traced with ``--trace 1``, and also
with ``--trace 0`` where the cell reports an end-to-end metric whose
``source`` is ``device_trace``.  A reader sees the finished ``Run``:

  run.config, run.traffic, run.seconds, run.device, run.setup_s
  run.start, run.end  the window on the host clock
  run.requests        [clients.Request] sent in the window
  run.done            the requests that completed inside the window
  run.served          ServeMetrics counters over the window and its drain:
                      rows, padded_rows, engine_s (a list)
  run.events          device operations of the traced window (None
                      untraced or on the CPU)
  run.traced_s        host seconds the profiler ran

A configuration is weightless (``"weighted": false``, no
``clause_weights``) or weighted (``"weighted": true`` with
``"clause_weights": {"dist", "min", "max"}``, 1 <= min <= max <= 65535):
each clause then votes ``weight * pol``, the weights drawn on the device
from the seed's own ``clause_weights`` stream (``weights.clause_weights``),
encoded into the served program and handed to the reference as they
were drawn.  A configuration whose two keys disagree is refused before
anything is made.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check, trace
from .clients import WAIT_S, Clients
from .pulse import Pulse
from .reference.classsums import class_sums, predictions
from .reference.data import DataSource
from .weights import clause_weights, include_actions, weight_spec

HERE = Path(__file__).resolve().parent
SLOT = "model"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, workload: str):
    """(BENCHMARK.json, its cell, the cell's configuration, its traffic)."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"tmbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(root / entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


KINDS = ("end_to_end", "layer_metrics")


def reader(kind: str, name: str):
    """``read`` of ``<kind>/<name>.py``; for a split name without a file of
    its own, of the quantity's file, ``<kind>/<quantity>.py`` first."""
    quantity = name.split(".")[0]
    other = KINDS[1 - KINDS.index(kind)]
    paths = (HERE / kind / f"{name}.py", HERE / kind / f"{quantity}.py",
             HERE / other / f"{quantity}.py")
    path = next((p for p in paths if p.is_file()), paths[0])
    spec = importlib.util.spec_from_file_location(f"tmbench_{kind}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def applies(metric: dict, cell: dict) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is reported in a cell."""
    return cell["name"] in metric.get("workloads", [cell["name"]])


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Run:
    """Set-up, window and check of one cell on one device."""

    def __init__(self, config, traffic, seed, device, trace_on=False, t_start=None):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.trace_on = trace_on and self.device.type == "cuda"  # the window is profiled
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.events = None
        self.traced_s = None

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.accel import Accelerator
        from repro_torch.core.compress import encode
        from repro_torch.core.tm import TMConfig

        cfg, dev = self.config, self.device
        self.phases = {"imports": time.perf_counter() - self.t_start}
        t = time.perf_counter()
        if int(cfg["n_raw_features"]) * int(cfg["thermometer_bits"]) != int(cfg["n_features"]):
            raise ValueError("n_features is not n_raw_features x thermometer_bits")
        weight_spec(cfg)
        source = DataSource(cfg, self.seed, dev)
        actions = include_actions(cfg, source, self.seed)
        self.pool = source.pool(int(cfg["pool_rows"]))
        self.actions = actions.cpu()
        weights = clause_weights(cfg, self.seed, dev)
        self.weights = None if weights is None else weights.cpu()
        del source, actions, weights
        self.phases["data"] = time.perf_counter() - t
        t = time.perf_counter()
        tm = TMConfig(
            n_classes=int(cfg["n_classes"]), n_clauses=int(cfg["n_clauses"]),
            n_features=int(cfg["n_features"]),
        )
        model = encode(tm, self.actions.numpy(),
                       None if self.weights is None else self.weights.numpy())
        self.acc = Accelerator.for_models(
            [model], batch_words=int(self.traffic["batch_words"]), device=dev
        )
        self.acc.load(SLOT, self.acc.compile(model).to_bytes())
        self.acc.start()
        self.phases["model"] = time.perf_counter() - t
        t = time.perf_counter()
        if self.trace_on:  # the profiler's own start-up, outside the window
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
                self.acc.submit(SLOT, self.pool[:32]).wait(timeout=WAIT_S)
        self.clients = Clients(self.acc, SLOT, self.pool, self.traffic, self.seed)
        self.clients.warm_up()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        self.phases["warmup"] = time.perf_counter() - t

    # -- the window --------------------------------------------------------

    def _counters(self) -> dict:
        m = self.acc.metrics
        with self.acc.server.scheduler.lock:  # no batch half recorded
            return {"rows": m.rows, "padded_rows": m.padded_rows,
                    "engine_n": len(m.engine_s)}

    def run_window(self, seconds: float) -> None:
        self.seconds = float(seconds)
        before = self._counters()
        prof = None
        if self.trace_on:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            t_prof = time.perf_counter()
        self.pulse = Pulse(self.acc.metrics)
        self.start = time.perf_counter()
        self.end = self.start + self.seconds
        self.setup_s = self.start - self.t_start
        self.requests = self.clients.run(self.end, self.pulse.watch(self.start, self.end))
        after = self._counters()
        if prof is not None:
            torch.cuda.synchronize(self.device)
            prof.stop()
            self.traced_s = time.perf_counter() - t_prof
            self.events = trace.device_events(prof)
        m = self.acc.metrics
        self.served = {k: after[k] - before[k] for k in ("rows", "padded_rows")}
        self.served["engine_s"] = m.engine_s[before["engine_n"]:after["engine_n"]]
        self.done = [r for r in self.requests if r.ok and r.completed_at <= self.end]

    def close_program(self) -> None:
        """Read the peak, stop the scheduler and free the program's state."""
        dev = self.device
        self.memory_peak = (
            torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        )
        self.acc.stop()
        del self.acc
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def reference(self):
        """(int32[pool, M] sums, int32[pool] predictions) of every pool row."""
        x = torch.from_numpy(self.pool).to(self.device)
        sums = class_sums(self.actions.to(self.device), x,
                          weights=self.weights).cpu().numpy()
        return sums, predictions(sums)

    def answers(self):
        """(the answers kept of the completed requests, requests lost)."""
        got = [(r.off, r.n, r.sums, r.preds) for r in self.requests
               if r.ok and r.sums is not None]
        return got, sum(not r.ok for r in self.requests)


def metric_values(bench, cell, run, kind):
    """{name: {"value", "unit"}} of the cell's metrics of one kind."""
    key = "end_to_end" if kind == "end_to_end" else "per_layer"
    out = {}
    for m in bench[key]:
        if not applies(m, cell):
            continue
        value = reader(kind, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(root, workload, seed, seconds, trace_on, device, t_start=None, out=sys.stdout):
    """Run one cell and print its result line; returns the result."""
    bench, cell, config, traffic = find_cell(Path(root), workload)
    device_e2e = any(m["source"] == "device_trace" and applies(m, cell)
                     for m in bench["end_to_end"])
    run = Run(config, traffic, seed, device, trace_on or device_e2e, t_start)
    run.setup()
    run.run_window(seconds)
    run.close_program()
    ref_sums, ref_preds = run.reference()
    got, lost = run.answers()
    verdict = check.compare(got, lost, ref_sums, ref_preds)
    kind = "layer_metrics" if trace_on else "end_to_end"
    dev = run.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": 1,
        "memory_peak_bytes": int(run.memory_peak),
    }
    result = {
        "correct": verdict["correct"],
        "attempted": len(run.requests),
        "failed": lost,
        "metrics": metric_values(bench, cell, run, kind),
        "device": device_info,
    }
    if trace_on and run.events is not None:
        device_info["busy_s"] = trace.busy_seconds(run.events)
        device_info["window_s"] = run.traced_s
        result["breakdown"] = {
            "device_ops": trace.top_ops(run.events),
            "idle_gaps": trace.idle_gaps(run.events),
        }
    result["checks"] = verdict["checks"]
    found = forbidden_modules()  # after the window and every reader
    if found:
        print(f"tmbench: the run loaded {', '.join(found)}", file=sys.stderr)
        raise SystemExit(3)
    print("tmbench: set-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in run.phases.items()), file=sys.stderr)
    per_s = np.zeros(int(np.ceil(run.seconds)))
    for r in run.done:
        per_s[min(int(r.completed_at - run.start), per_s.size - 1)] += r.n
    print("tmbench: each second of the window:\nrows "
          + " ".join(f"{v:.0f}" for v in per_s), file=sys.stderr)
    for line in run.pulse.lines():
        print(line, file=sys.stderr)
    print(f"tmbench: {verdict['rows_checked']} rows of {len(got)} requests "
          f"checked against the reference", file=sys.stderr)
    for name, c in verdict["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return result
