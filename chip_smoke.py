#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or ``repro``.
At the paper's MNIST-scale width (10 classes x 200 clauses x 784
features, ~17k includes, 8192 datapoints per flush) it

  1. builds every kernel under src/repro_torch/csrc (``nvcc``, sm_90a);
  2. holds each kernel against its plain PyTorch twin on the card with
     ``torch.equal`` (integer sums: tolerance 0), one weight plane and
     three, plus a ragged batch and a program with a zero-include class;
  3. serves the main path through ``Accelerator``: compile -> bytes ->
     load -> submit (1, 37, 8192 rows) -> flush, a hot-swap under queued
     traffic, a rollback and the scheduler loop, every prediction held
     to the dense ``batch_class_sums`` oracle; the kernels' launch counts
     are zeroed just before and read just after;
  4. times each kernel, its plain twin, the staging copy and one flush
     with CUDA events (median of 30) and works out each kernel's bound;

and prints a ``{"kernels": [...]}`` line, the card's name and power limit
from ``nvidia-smi``, and last ``{"ok": true, "device": {...}}``.  Any
failed phase exits nonzero before the result lines; so does a machine
without CUDA, or a directory that lacks the repo's ``src/repro_torch``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# no int32 ALU rate is published beside the tensor-core rates; the fp32
# non-tensor rate (67 TFLOP/s) is the highest candidate, so the bound
# derived from it stays a lower bound on time
PEAK_OPS_PER_S = 67e12
REPS = 30


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this run needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.accel import Accelerator, CapacityPlan
    from repro_torch.core import (
        TMConfig,
        batch_class_sums_weighted,
        decode_to_plan,
        encode,
        from_u32,
        pack_literals,
        state_from_actions,
    )
    from repro_torch.kernels import _build
    from repro_torch.kernels.tm_popcount import kernel as tmk
    from repro_torch.kernels.tm_popcount.ops import plan_to_popcount_operands

    if any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules):
        fail("the port pulled in jax or the reference package")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.3f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    # -- the paper-MNIST models (seed 0 is benchmarks' synthetic model) -----
    cfg = TMConfig(n_classes=10, n_clauses=200, n_features=784)

    def paper_mnist(seed: int, weighted: bool):
        rng = np.random.default_rng(seed)
        acts = rng.random((10, 200, 1568)) < 17000 / 3136000
        w = rng.integers(1, 8, (10, 200)) if weighted else None
        return acts, w, encode(cfg, acts, w)

    acts_a, _, model_a = paper_mnist(0, False)
    acts_b, w_b, model_b = paper_mnist(1, True)
    plan_a, plan_b = decode_to_plan(model_a), decode_to_plan(model_b)
    print(
        f"model a: {plan_a.n_includes} includes, {plan_a.n_clauses_total} "
        f"clauses; model b: {plan_b.n_includes} includes, weight planes "
        f"{model_b.weight_planes}"
    )
    rng = np.random.default_rng(2)
    X = rng.integers(0, 2, (8192, 784), dtype=np.uint8)
    lits = pack_literals(torch.from_numpy(X).to(dev))  # [1568, 256]
    # model a alone negotiates I_cap 16928; the served plan holds a and b
    I_CAP, M_CAP = 16928, 10
    served = CapacityPlan.for_models([model_a, model_b], batch_words=256)
    I_SERVED = served.instruction_capacity
    print(f"served plan: {served.as_dict()}")

    def operands(plan, i_cap, planes):
        li, last, mp, mn = plan_to_popcount_operands(
            plan, i_cap, M_CAP, l2_cap=1568, weight_planes=planes
        )
        return [
            torch.from_numpy(li).to(dev), torch.from_numpy(last).to(dev),
            from_u32(mp, dev), from_u32(mn, dev),
        ]

    # -- 2. kernel vs plain twin -------------------------------------------
    acts_z = acts_a.copy()
    acts_z[3] = False  # class 3 has no includes: a lone EXTEND
    plan_z = decode_to_plan(encode(cfg, acts_z))
    cases = {
        "P=1 W=256": (operands(plan_a, I_CAP, None), lits),
        "P=3 W=256": (operands(plan_b, I_SERVED, 3), lits),
        "main path a@P=3": (operands(plan_a, I_SERVED, 3), lits),
        "ragged I_cap=16921 W=37": (
            operands(plan_a, 16921, None), lits[:, :37].contiguous()
        ),
        "zero-include class": (operands(plan_z, I_CAP, None), lits),
    }
    max_err = 0
    for name, (ops, packed) in cases.items():
        got = tmk.tm_popcount(*ops, packed)
        want = tmk.tm_popcount_plain(*ops, packed)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            fail(f"kernel != plain twin on {name}: max abs err {err}")
        if name == "zero-include class" and bool(got[3].any()):
            fail("the zero-include class has nonzero sums")
        print(f"parity {name}: equal, sums shape {tuple(got.shape)}")

    # -- 3. the main path through Accelerator ------------------------------
    def oracle(acts, w, x):
        state = state_from_actions(cfg, torch.from_numpy(acts).to(dev))
        wt = None if w is None else torch.from_numpy(w).to(dev)
        out = [
            batch_class_sums_weighted(
                cfg, state, torch.from_numpy(x[i:i + 32]).to(dev), wt
            )
            for i in range(0, x.shape[0], 32)
        ]
        return torch.cat(out).cpu().numpy()

    X512 = X[:512]
    sums_a, sums_b = oracle(acts_a, None, X512), oracle(acts_b, w_b, X512)
    pred_a, pred_b = sums_a.argmax(1), sums_b.argmax(1)

    acc = Accelerator(served)
    if acc.engine.name != "popcount" or acc.engine.device.type != "cuda":
        fail(f"default Accelerator runs {acc!r}")
    print(f"accelerator: {acc!r}")
    blob = acc.compile(model_a).to_bytes()
    tmk.launches = 0
    acc.load("mnist", blob)
    handles = [acc.submit("mnist", r) for r in (X[:1], X[1:38], X)]
    acc.flush()
    preds = [h.result() for h in handles]
    if not (np.array_equal(preds[0], pred_a[:1])
            and np.array_equal(preds[1], pred_a[1:38])
            and np.array_equal(preds[2][:512], pred_a)):
        fail("served predictions differ from the dense oracle (model a)")
    if not np.array_equal(acc.class_sums("mnist", X512), sums_a):
        fail("served class sums differ from the dense oracle (model a)")
    queued = acc.submit("mnist", X512)  # drained under model a by the swap
    acc.load("mnist", acc.compile(model_b), provenance="swap")
    if not np.array_equal(queued.result(), pred_a):
        fail("traffic queued before the hot-swap was not served by model a")
    h = acc.submit("mnist", X512)
    acc.flush()
    if not np.array_equal(h.result(), pred_b):
        fail("predictions after the hot-swap differ from model b's oracle")
    acc.rollback("mnist")
    acc.start()
    h = acc.submit("mnist", X512)
    got = h.wait(timeout=120)
    acc.stop()
    if not np.array_equal(got, pred_a):
        fail("predictions after the rollback differ from model a's oracle")
    torch.cuda.synchronize()
    main_launches = tmk.launches
    if acc.compile_cache_size() != 1:
        fail(f"compile_cache_size() == {acc.compile_cache_size()}, not 1")
    if main_launches == 0:
        fail("the main path never launched the tm_popcount kernel")
    print(
        f"serve: {acc.metrics_snapshot()['requests_completed']} requests, "
        f"hot-swap + rollback exact, compile_cache_size 1, tm_popcount "
        f"launches {main_launches}"
    )

    # -- 4. timings --------------------------------------------------------
    def kernel_bound(ops, packed):
        """(bound ms, what bounds it, bytes, operations) on these inputs:
        each input read once and the sums written once; one AND per
        include and batch word, and per nonzero (plane, class, chunk)
        mask pair two ANDs and two popcounts per datapoint."""
        li, last, mp, mn = ops
        planes = 1 if mp.dim() == 2 else mp.shape[0]
        l2, w = packed.shape
        ends = torch.nonzero(last == 1)
        n_inc = int(ends[-1]) + 1 if ends.numel() else 0
        nnz = int(((mp | mn) != 0).sum())
        m_cap, chunks = mp.shape[-2], mp.shape[-1]
        n_bytes = 4 * (
            l2 * w + 2 * li.numel() + int((last == 1).sum())
            + 2 * planes * m_cap * chunks + m_cap * 32 * w
        )
        n_ops = n_inc * w + 4 * nnz * 32 * w
        t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_OPS_PER_S
        return (
            max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", n_bytes, n_ops,
        )

    timings = {}
    for name in ("P=1 W=256", "P=3 W=256", "main path a@P=3"):
        ops, packed = cases[name]
        # as the engine calls it: the clause table built at program time
        ends = torch.nonzero(ops[1] == 1).flatten().to(torch.int32)
        table = {"clause_end": ends, "n_clauses": ends.numel()}
        k_ms = median_ms(lambda: tmk.tm_popcount(*ops, packed, **table))
        p_ms = median_ms(lambda: tmk.tm_popcount_plain(*ops, packed), reps=20)
        bound_ms, bound_by, n_bytes, n_ops = kernel_bound(ops, packed)
        timings[name] = (k_ms, p_ms, bound_ms, bound_by)
        print(
            f"time {name}: kernel {k_ms:.6f} ms, plain {p_ms:.6f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}; {n_bytes} B, {n_ops} ops)"
        )
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            for _ in range(REPS):
                tmk.tm_popcount(*ops, packed, **table)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "kernel" in ev.key and ev.count:
                us = getattr(ev, "device_time_total", 0) / ev.count
                print(f"profile {name}: {ev.key} {us:.3f} us/launch x{ev.count}")
    staging = acc.engine.staging_tensor
    x_dev = torch.empty_like(staging, device=dev)
    h2d_ms = median_ms(lambda: x_dev.copy_(staging, non_blocking=True))
    print(f"time H2D staging copy {tuple(staging.shape)} uint8: {h2d_ms:.6f} ms")
    flush_s = []
    for _ in range(20):
        t0 = time.perf_counter()
        acc.submit("mnist", X)
        acc.flush()
        flush_s.append(time.perf_counter() - t0)
    flush_ms = statistics.median(flush_s) * 1e3
    print(f"time flush of 8192 rows (submit + flush, host clock): {flush_ms:.6f} ms")
    activities = [
        torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA
    ]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        acc.submit("mnist", X)
        acc.flush()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [
        (getattr(ev, "self_device_time_total", 0), ev.key, ev.count)
        for ev in prof.key_averages()
    ]
    dev = sorted((d for d in dev if d[0] > 0), reverse=True)
    busy_us = sum(d[0] for d in dev)
    print(
        f"profile flush: wall {wall_us:.1f} us, device busy {busy_us:.1f} us "
        f"(idle share {1 - busy_us / wall_us:.3f})"
    )
    for us, key, count in dev[:8]:
        print(f"profile flush: {us:.1f} us  x{count}  {key[:90]}")

    # -- 5. result lines ---------------------------------------------------
    k_ms, p_ms, bound_ms, bound_by = timings["main path a@P=3"]
    print(json.dumps({"kernels": [{
        "name": "tm_popcount",
        "route": "cuda",
        "source": "src/repro_torch/csrc/tm_popcount.cu",
        "replaces": "src/repro/kernels/tm_popcount/kernel.py:128",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
