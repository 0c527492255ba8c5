#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX or ``repro``.
At the paper's MNIST-scale width (10 classes x 200 clauses x 784
features, ~17k includes, 8192 datapoints per flush) it

  1. builds every kernel under src/repro_torch/csrc (``nvcc``, sm_90a)
     and prints the registers and local (spill) bytes of every kernel,
     and the SASS opcode counts of ``tm_train``'s kernels (per threefry
     draw too) where ``cuobjdump`` is found;
  2. holds each kernel against its plain PyTorch twin on the card with
     ``torch.equal`` (integer sums: tolerance 0), one weight plane and
     three, plus a ragged batch, a program with a zero-include class, and
     two programs built on the host as the engine builds them;
  2b. holds the packing kernel (``pack_phase``) to its eager twin at the
     served shapes (8192 and 32768 rows x 784 features, 8192 x 1122) and
     times each beside its bytes bound and the twin's time;
  3. serves the main path through ``Accelerator``: compile -> bytes ->
     load -> submit (1, 37, 8192 rows) -> flush, a hot-swap under queued
     traffic, a rollback and the scheduler loop, every prediction held
     to the dense ``batch_class_sums`` oracle; the launch counts of
     ``tm_popcount`` and ``pack_literals`` are zeroed just before and
     read just after;
  3b. dense vs compressed (the paper's Fig 6 / Fig 9 comparison): one
     model evaluated four ways on all 8192 rows -- ``tm_dense_class_sums``
     (clause_eval), ``tm_matmul_class_sums`` (clause_matmul),
     ``tm_compressed_class_sums`` (tm_interp) and the served
     ``tm_popcount`` sums -- all ``torch.equal`` and equal to the oracle;
     the three kernels' launch counts are zeroed just before and read
     just after; then each is ``torch.equal`` to its plain twin at full
     width, on the shapes that break its tiling (ragged and small clause,
     literal and batch counts; for clause_eval L2 off the 16-byte loads,
     NC = 1 and W = 1; for tm_interp a clause of 71 includes, clauses out
     of class order with class ids out of range, W = 1 and m_cap above
     the model's classes) and on a zero-include class, and is timed
     (CUDA events, median of 30; plain twins median of 10) beside its
     bound and, for clause_matmul, ``torch._int_mm`` on int8 operands
     (the faster of its two layouts of the second operand, also profiled
     for its device time); clause_eval and tm_interp are profiled alone
     for their device time and device operations per call;
  3c. Fig-8 recalibration (``fig8_phase``) at the same width with the
     paper's n_states 128, T 15, s 3.9: ``tm_train`` (through
     ``fused_train_batch``) ``torch.equal`` to its plain twin over three
     chained steps from model a's state and from an all-excluded state at
     B = 128, 200 and 37, and its wrapper to ``tm_train_plain`` on the
     same clause words; the packed train engine equal to the reference
     engine; then a ``RecalController`` over an ``Accelerator`` deploys
     model a, observes 512 labelled rows (one batch served by the
     scheduler loop), recalibrates (fine-tune epochs on the packed
     engine), publishes the ``TMProgram`` and hot-swaps it under queued
     traffic, serves sums equal to the oracle of the published state and
     is rolled back to model a, with ``compile_cache_size()`` 1 and the
     launches of ``clause_eval``, ``tm_train`` and ``tm_popcount`` zeroed
     before the loop and read after it; last ``fit_step`` per engine,
     ``tm_train`` and its twin are timed, ``tm_train`` profiled and the SM
     clock read (``nvidia-smi``) while it runs;
     Six more configurations (no boost of true positives, s 1 and 10, T 1,
     N 8, a mix) are held to the twin over two chained steps at B = 128;
  3d. the paper's stream interpreter and pruning (``stream_phase``):
     ``interp_stream`` ``torch.equal`` to its plain twin at W = 256, on a
     ragged 37 rows and at W = 1, weighted and not, and equal to the
     oracle; the tables of its decode launch equal to
     ``decode_stream_plain``'s; ``clause_fire_counts`` on the card equal to its plain
     version; then, with the launches of ``clause_eval``,
     ``interp_stream`` and ``tm_popcount`` zeroed before and read after:
     the ``interp`` and ``plan`` engines serve 8192 rows of models a -> b
     -> a equal to the popcount-served sums and the oracle with
     ``compile_cache_size()`` 1; ``core.runtime.Accelerator`` (batch_words
     256), fed model a's instruction stream and a feature stream of 8192
     rows, predicts the oracle's argmax, and ``MultiCoreAccelerator(4)``
     the same; ``prune_exact`` and ``merge_weighted`` of a model seeded
     with every dead-clause species serve the unpruned oracle on popcount
     (two weight planes or more), interp and plan; ``prune_ranked`` at
     tolerance 0.02 on 512 rows labelled by model b keeps its tolerance;
     a ``RecalController(prune=PrunePolicy(tolerance=0.02))`` deploys,
     recalibrates, publishes a weighted (v2) ``TMProgram`` and hot-swaps
     it under queued traffic, serving the oracle of the published pruned
     weights; the engines' flush, ``interp_stream`` (events, profiler per
     launch, bound) and the policy are timed;
  3e. the fleet (``fleet_phase``): four nodes on the card (``TMServer``
     on the ``interp``, ``plan``, ``popcount`` and ``sharded`` engines,
     the bench's cycle, the sharded node on a (1, 2) mesh of the card),
     their scheduler loops running, through the
     scenarios of benchmarks/tm_fleet.py: pools of 1, 2 and 4 nodes route
     48 requests of 37..8192 rows (every reply equal to the oracle, rows/s
     on the host clock); ``RolloutManager`` ships model b canary -> wave
     -> fleet under router traffic (nothing dropped, every reply a's or
     b's oracle, every stage bit-exact; ``install_s``/``verify_s`` and the
     device's idle share over the rollout); b with its class rows rotated
     aborts at the canary and the canary rolls back; four ``ChaosNode``s
     lose no critical request while one is killed and revived (quarantine
     within 3 consecutive failures, recovery by a half-open probe); the
     launches of ``tm_popcount``, ``interp_stream`` and ``clause_table``
     are zeroed before the phase and read after it;
  3f. multi-device (``sharded_phase``): ``clause_table`` ``torch.equal``
     to its plain twin and to the dense oracle on models a and b's
     weighted clause tables at 8192 rows, on model a's table over
     literals whose last row (the one the pads name) is random, on
     tm-paper (10 x 128 x 784, lc_cap 160, batch 8192) and tm-xl (64 x
     512 x 4096, lc_cap 328, batch 32768), random plans at their
     densities with planted inputs, each timed (events, profiler, bound;
     registers, shared bytes, spills, grid and cluster); with the launches of
     ``clause_table`` zeroed before and read after, ``build_tm_sharded``
     on tm-paper and tm-xl on the logical meshes (1, 1), (1, 2), (2, 1),
     (2, 2) of the card (and (1, 4), which does not divide 10 classes)
     equal to the dense oracle, one launch per tile, and the ``sharded``
     engine serving a -> b -> a at 8192 rows per flush through
     ``TMServer(engine="sharded", mesh=(2, 2))`` and ``Accelerator(mesh=
     (1, 1))``, equal to the oracle with ``compile_cache_size()`` 1 (each
     flush timed, its device idle share profiled); then the sharded train
     engine on a (2, 2) mesh over three chained steps at B = 128 equal to
     the packed engine, and a recal loop with ``RecalWorker(mesh=)``
     publishing the packed loop's ``TMProgram`` bytes;
  3g. the LM trunk (``lm_phase``; no kernel of its own: cuBLAS products
     and the reference's two attention paths in plain PyTorch): the
     stablelm-3b, starcoder2-7b, moonshot-v1-16b-a3b and internvl2-26b
     smoke archs' ``loss``, ``prefill`` and a decode step on the card
     against the CPU from the same fp32 parameters (1e-3), one bf16 train
     step each; 60 steps of stablelm-3b-smoke at lr 3e-3 lowering the loss
     by more than 0.9 nats; stablelm-3b at full width and depth in bf16:
     ``Server(batch=4, prompt_cap=4000, gen_cap=96)`` generating 96 tokens
     (prefill on the streaming path, decode on the plain path with
     ``kv_len``; prefill and decode timed, peak memory), three
     ``make_train_step`` steps at B = 4, S = 4096 with 4 microbatches (ms,
     tokens/s, model-FLOPs share, peak memory) and one profiled; the
     streaming attention held to the plain one at one layer's width in
     fp32 and both timed in bf16 beside
     ``scaled_dot_product_attention`` (a library column only); the
     ``repro_torch.launch.serve`` CLI;
  3h. the recurrent and encoder-decoder families (``recurrent_phase``;
     no kernel of their own: the reference's scans as Python loops):
     the xlstm-125m, zamba2-2.7b and whisper-medium smoke archs' loss,
     prefill logits and every cache leaf, and three chained decode steps
     on the card against the CPU from the same fp32 parameters (1e-3),
     one bf16 train step each; at full width in bf16 from random
     weights, zamba2-2.7b and xlstm-125m served by ``Server(batch=4,
     prompt_cap=1000, gen_cap=24)`` and whisper-medium by
     ``make_prefill_step`` on frames [4, 1500, 1024] and 4 x 448 tokens
     (384 prompt) then 63 ``make_decode_step`` steps: prefill ms,
     decode ms per step, tokens/s, peak memory, profiles of a decode
     step and of the prefill (the recurrent ones at 32 and 64 positions,
     for their launches per position); one layer of Zamba2's SSD and
     xLSTM's mLSTM and sLSTM at full width (B = 4, S = 1,024) and 30
     chained decode steps of each, timed beside their bounds;
  3i. the LM on a mesh (``mesh_phase``; no kernel of its own): one MoE
     layer of moonshot-v1-16b-a3b at full width (D 2048, 64 experts of F
     1408, top-6) on x [4, 1024, 2048]: ``moe_ffn_ep`` on logical meshes
     (1, 1), (1, 2), (1, 4) and (2, 2) of the card against ``moe_ffn``
     (on each data half for (2, 2)) in fp32 within 1e-5 of the largest
     |y|, timed in bf16 beside ``moe_ffn`` and the layer's bound; the
     whole moonshot-v1-16b-a3b (48 layers, bf16, random weights) served
     by ``Server(batch=4, prompt_cap=1000, gen_cap=24)`` with no mesh and
     on meshes (1, 1) and (1, 4) (finite logits, tokens in range, every
     MoE layer through ``moe_ffn_ep`` on a mesh; prefill and decode
     times, peak memory, idle shares, the meshes' logits and tokens
     against no mesh); xlstm-125m at full width trained by
     ``repro_torch.launch.train.main`` (``--mesh 1x1 --batch 4 --seq 256
     --steps 4``, a checkpoint every 2 steps), rerun after step 4 is
     deleted (``[restore] step 2``, the same losses and grad norms), the
     step-4 state resharded onto a (2, 1) mesh (every leaf equal) and one
     more step there giving the (1, 1) continuation's loss;
  3j. the dry run (``dryrun_phase``, right after 3g; no kernel of its
     own): ``launch.dryrun.run_cell`` traces 3g's stablelm-3b prefill (4
     x 4,096) and train step (B = 4, S = 4,096) on a (1, 1) mesh of spec
     arithmetic on the host (nothing placed on the card), then one real
     step of each runs on the card under ``FlopCounterMode``: the card's
     flop count equals the record's ``flops_per_device`` exactly, the
     params and optimizer state on the card equal the record's argument
     bytes less the inputs, and 3g's measured times are not under the
     record's lower bound ``max(t_compute, t_memory_lower)`` (the fused
     memory term of ``analysis.report.enrich``; the ratios to it and to
     the unfused ``max(t_compute, t_memory)``, the model-FLOPs share and
     peak memory beside argument + temp printed); ``dryrun_tm`` of
     tm-paper and tm-xl on (1, 1): 3f's ``clause_table`` device µs not
     under the record's ``t_memory`` (its operands once, its sums once;
     the ratio to the capacity bound printed beside); and ``python -m
     repro_torch.launch.dryrun --arch stablelm-3b --shape train_4k``
     (pod16x16, full width) runs in a process that sees no card, timed;
  3k. the LM train path on a rank mesh (``rank_phase``, after 3i; no
     kernel of its own: NCCL's collectives where the reference has
     GSPMD's): ``torch.cuda.device_count()`` processes, one per card,
     under NCCL (``launch.mesh.init_distributed``), each running
     ``repro_torch.launch.train.main`` on an (N, 1) rank mesh (also
     (2, 2) where there are four cards; otherwise a line says no
     multi-card mesh was available) at 3g's arch and shape (stablelm-3b,
     B = 4, S = 4,096, bf16, seed-0 weights, the same batches): three
     steps whose losses and grad norms equal 3g's one-device steps
     within ``LM_TOL``, step ms (slowest rank), peak memory, and the
     last step profiled (idle share, top device operations, collective
     bytes per kind);
  3l. LM serving on a rank mesh (``rank_phase``'s first mesh, in 3k's
     ranks once ``launch.train.main`` returns, the trained state dropped;
     no kernel of its own): 3g's arch at full width in bf16 from
     ``init_params(cfg, 0)``, placed by ``param_shardings`` on a (1, N)
     rank mesh of the N cards (``model`` split where there are cards for
     it; otherwise a line says no multi-card mesh was available) and
     served by ``Server(batch=4, prompt_cap=4000, gen_cap=96)`` from 3g's
     prompts: its 16 tokens equal 3g's first 16 exactly; the server's
     own prefill and decode steps in that ``generate`` timed (host clock
     to a synchronise), its last decode step profiled (idle share,
     collective bytes per kind), peak memory, and the rank's cache bytes
     against ``_memory_of``'s decode alias bytes (they must agree); on a
     (1, 1) mesh the rank decode step timed in turns with the one-device
     step in the same process;
  4. times each kernel, its plain twin, the staging copy and one flush
     with CUDA events (median of 30) and works out each kernel's bound;

and prints a ``{"kernels": [...]}`` line (all eight kernels), the card's name and power limit
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
sys.path.insert(0, str(ROOT / "src"))
try:  # the card's rates (main() fails first where the repo is not beside it)
    # no int32 ALU rate is published beside the tensor-core rates; the fp32
    # non-tensor rate (PEAK_FP32_FLOPS) is the highest candidate, so the
    # bound derived from it stays a lower bound on time
    from repro_torch.analysis.roofline import (
        HBM_BW, PEAK_FLOPS, PEAK_FP32_FLOPS, PEAK_INT8_OPS, model_flops,
    )
except ImportError:
    HBM_BW = PEAK_FLOPS = PEAK_FP32_FLOPS = PEAK_INT8_OPS = model_flops = None
REPS = 30
PLAIN_REPS = 10


def bound(n_bytes: int, n_ops: int, peak_ops: float = PEAK_FP32_FLOPS):
    """(bound ms, what bounds it): the larger of bytes over the memory
    rate and operations over the given peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BW, n_ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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


def clocks_during(fn, seconds: float = 1.5):
    """The SM clock (MHz, ``nvidia-smi``), sampled every ~0.2 s while
    ``fn`` runs back to back for ``seconds``."""
    import threading

    import torch

    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=30)
            samples.append(smi.stdout.strip())
            stop.wait(0.2)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join()
    return samples


def device_per_call(prof, calls: int):
    """(device us, device operations, [(name, events, total us)]) per call
    of ``calls`` profiled calls: each kernel's mean time over the events
    the profiler kept, times its launches per call.  The profiler can miss
    the first launch of a session, so a kernel's events are not divided by
    ``calls``."""
    us, n_ops, ops = 0.0, 0, []
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", 0)
        if total > 0:
            per_call = max(1, round(ev.count / calls))
            us += total / ev.count * per_call
            n_ops += per_call
            ops.append((ev.key, ev.count, total))
    return us, n_ops, ops


def device_ops(prof):
    """[(device us, name, count)] of the operations that ran on the card in
    a profile, largest first: the kernels and copies themselves.  The CPU
    operators that launched them report the same device time as their
    own, so they are left out (summing both would count each twice)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops = [(ev.self_device_time_total, ev.key, ev.count)
           for ev in prof.key_averages()
           if ev.device_type == cuda and ev.self_device_time_total > 0]
    return sorted(ops, reverse=True)


def span_us(prof, first: str, last: str):
    """(median us, count) of one call's device span, from the earlier
    start to the later end of its two kernels: each kernel whose name
    holds ``first`` with the kernel whose name holds ``last`` that starts
    nearest to it.  The second is launched early (programmatic dependent
    launch), so the two overlap and the second's own time includes its
    wait for the first.  The median, because the profiler's first
    buffer request can hold one call's second launch back by
    milliseconds."""
    def launches(key):
        return [e.time_range for e in prof.events() if key in e.name]

    seconds = launches(last)
    spans = []
    for a in launches(first):
        b = min(seconds, key=lambda t: abs(t.start - a.start), default=None)
        if b is not None:
            spans.append(max(a.end, b.end) - min(a.start, b.start))
    return (statistics.median(spans) if spans else float("nan")), len(spans)


def cuobjdump():
    """Path of ``cuobjdump`` (the CUDA toolkit's, else the copy Triton
    ships), or None."""
    import os
    import shutil

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cands = [shutil.which("cuobjdump"), os.path.join(home, "bin", "cuobjdump")]
    try:
        import triton

        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if c and os.access(c, os.X_OK)), None)


_BRANCHES = ("BRA", "BRX", "EXIT", "RET", "CALL", "BSSY", "BSYNC", "WARPSYNC",
             "BAR", "JMP")


def sass_blocks(library: str, kernel: str):
    """[(opcode, ...)] straight-line blocks of the SASS of the first kernel
    whose mangled name holds ``kernel`` in a built library (cuobjdump
    -sass), split at branches and branch targets; a string that says why
    when the SASS cannot be read.  Opcodes keep their modifiers
    (``IMAD.IADD``, ``SHF.L.W.U32``) and drop predicates."""
    import re

    tool = cuobjdump()
    if tool is None:
        return "cuobjdump not found"
    try:
        run = subprocess.run([tool, "-sass", library], capture_output=True,
                             text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"cuobjdump failed: {e}"
    if run.returncode != 0:
        return f"cuobjdump exited {run.returncode}: {run.stderr.strip()[:200]}"
    text = run.stdout
    body, inside, seen = [], False, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line and not seen  # the first match alone
            seen = seen or inside
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if inside and m:
            body.append((int(m.group(1), 16), m.group(3), m.group(4)))
    targets = {int(t, 16) for _, op, rest in body if op.split(".")[0] in _BRANCHES
               for t in re.findall(r"0x([0-9a-f]+)", rest)}
    blocks, cur = [], []
    for addr, op, _ in body:
        if addr in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append(op)
        if op.split(".")[0] in _BRANCHES:
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    return blocks


def print_sass(tag: str, library: str, kernel: str):
    """Print the opcode counts of ``kernel`` in ``library``: the whole
    kernel, and the largest straight-line block, where a whole inlined
    threefry draw sits; says why and returns when the SASS cannot be
    read, as a missing SASS count fails nothing."""
    from collections import Counter

    blocks = sass_blocks(library, kernel)
    if isinstance(blocks, str):
        print(f"sass {tag} {kernel}: {blocks}, no SASS counts")
        return
    whole = Counter(op for b in blocks for op in b)
    big = max(blocks, key=len, default=[])
    print(f"sass {tag} {kernel}: {sum(whole.values())} instructions in "
          f"{len(blocks)} blocks: {dict(whole.most_common())}")
    print(f"sass {tag} {kernel} largest block: {len(big)} instructions: "
          f"{dict(Counter(big).most_common())}")
    # a threefry draw rotates 20 times (SHF.L.W, or IMAD.WIDE.U32 where a
    # rotate is a multiply): the block's draws, and its counts per draw
    rotates = sum(n for op, n in Counter(big).items()
                  if op.startswith(("SHF.L.W", "IMAD.WIDE.U32")))
    if rotates >= 20:
        draws = round(rotates / 20)
        per = {op: round(n / draws, 2) for op, n in Counter(big).most_common()}
        print(f"sass {tag} {kernel} per draw ({draws} in the block): "
              f"{round(len(big) / draws, 2)} instructions: {per}")


# integer operations of one threefry2x32 hash under a key already
# scheduled (the counter's high word is 0, so x0 starts as the key word:
# 1 key add, 20 rounds of add + funnel shift + XOR, 5 injections of 2
# adds), of scheduling a key once for all its hashes (2 XORs and the 5
# constants key + n the injections add), and of turning a hash's words
# into a compared uniform (XOR, shift, OR, subtract, compare)
OPS_PER_HASH = 71
OPS_PER_KEY = 7
OPS_PER_UNIFORM = 5


def train_work(cfg, packed, clause_words, packed_lits, yb, key):
    """(bytes, operations, hashes) that one ``tm_train`` call needs on
    these inputs, whatever implements it: state in and out, clause words,
    literals and labels each moved once; the hashes of the key derivation
    (16 per sample, under 14 keys per sample and the call key), one
    selection uniform per (sample, row whose update lands, clause), and
    for each selected Type I clause the uniforms its branch reads (every
    literal when the clause did not fire; the 0-literals, and the
    1-literals unless the increment is certain, when it fired); 4
    operations per selected (sample, row, clause) and literal for the
    delta and its clip.  The selection is ``core.train.feedback_masks``."""
    import torch
    from repro_torch.core.train import (
        _sample_rows, feedback_masks, feedback_thresholds, sample_keys,
    )
    from repro_torch.kernels.tm_train.kernel import sample_bits

    C, L = cfg.n_clauses, cfg.n_literals
    dev = packed.device
    B = yb.shape[0]
    rows, lands, row_keys = _sample_rows(cfg, sample_keys(key.to(dev), B), yb)
    sat, lits = sample_bits(clause_words.reshape(cfg.n_classes, C, -1),
                            packed_lits, rows, torch.arange(B, device=dev))
    type1, type2 = feedback_masks(cfg, row_keys, sat,
                                  torch.tensor((True, False), device=dev))
    type1, type2 = type1 & lands[..., None], type2 & lands[..., None]
    strengthen, _ = feedback_thresholds(cfg)
    zeros = (~lits).sum(dim=1)  # 0-literals per sample
    fired = zeros if strengthen >= 1.0 else torch.full_like(zeros, L)
    per_clause = torch.where(sat, fired[:, None, None], L)
    draws = int((type1 * per_clause).sum()) + C * int(lands.sum())
    hashes = draws + 16 * B
    n_ops = (OPS_PER_HASH * hashes + OPS_PER_KEY * (14 * B + 1)
             + OPS_PER_UNIFORM * draws
             + 4 * int((type1 | type2).sum()) * L + 2 * B * C)
    n_bytes = (2 * packed.numel() + 4 * clause_words.numel()
               + 4 * packed_lits.numel() + 4 * B)
    return n_bytes, n_ops, hashes


def fig8_phase(dev, acts_a, X, pred_b):
    """Phase 3c: Fig-8 recalibration at the width of model a's actions
    (the paper's: n_states 128, T 15, s 3.9), on ``dev``.  Returns the
    ``tm_train`` row of the kernels line."""
    import numpy as np
    import torch
    from repro_torch.accel import Accelerator, CapacityPlan, TMProgram
    from repro_torch.core import TMConfig, batch_class_sums, encode, include_actions
    from repro_torch.core import prng, state_from_actions
    from repro_torch.kernels.clause_eval import kernel as cek
    from repro_torch.kernels.tm_popcount import kernel as tmk
    from repro_torch.kernels.tm_train import kernel as ttk
    from repro_torch.kernels.tm_train import pack_ta_state, unpack_ta_state
    from repro_torch.recal import (
        Compressor, RecalController, RecalWorker, make_train_engine,
    )

    M, C, L = acts_a.shape
    cfg = TMConfig(n_classes=M, n_clauses=C, n_features=L // 2)
    state_a = state_from_actions(cfg, torch.from_numpy(acts_a).to(dev))
    starts = {"model a": state_a,
              "all excluded": torch.ones_like(state_a)}
    rng = np.random.default_rng(4)

    def batch(n):
        x = torch.from_numpy(rng.integers(0, 2, (n, L // 2), dtype=np.uint8)).to(dev)
        y = torch.from_numpy(rng.integers(0, M, n).astype(np.int32)).to(dev)
        return x, y

    # -- 1. kernel vs plain twin over chained steps ------------------------
    key = prng.key(5)
    max_err = 0
    for start, state0 in starts.items():
        for B in (128, 200, 37):
            got = want = pack_ta_state(cfg, state0).contiguous()
            for step in range(3):
                x, y = batch(B)
                kb = prng.fold_in(key, step)
                got = ttk.fused_train_batch(cfg, got, kb, x, y)
                want = ttk.fused_train_batch_plain(cfg, want, kb, x, y)
                torch.cuda.synchronize()
                err = int((got.int() - want.int()).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    fail(f"tm_train != plain twin from {start}, B={B}, step "
                         f"{step}: max abs err {err}")
            moved = int((got != pack_ta_state(cfg, state0)).sum())
            print(f"parity tm_train from {start} B={B}: 3 chained steps equal, "
                  f"{moved} TAs moved")
    # configurations off the paper's defaults: no boost of true positives
    # (the strengthen < 1 branch), s = 1 and 10, T = 1, N = 8, and a mix,
    # on batches of their own (the draws of ``batch`` stay as they were)
    rng_k = np.random.default_rng(5)
    for kw in (dict(boost_true_positive=False), dict(specificity=1.0),
               dict(specificity=10.0), dict(threshold=1), dict(n_states=8),
               dict(boost_true_positive=False, specificity=1.5, threshold=3,
                    n_states=8)):
        cfg_k = TMConfig(n_classes=M, n_clauses=C, n_features=L // 2, **kw)
        got = want = pack_ta_state(
            cfg_k, state_from_actions(cfg_k, torch.from_numpy(acts_a).to(dev))
        ).contiguous()
        for step in range(2):
            x = torch.from_numpy(rng_k.integers(0, 2, (128, L // 2), dtype=np.uint8)).to(dev)
            y = torch.from_numpy(rng_k.integers(0, M, 128).astype(np.int32)).to(dev)
            kb = prng.fold_in(key, 20 + step)
            got = ttk.fused_train_batch(cfg_k, got, kb, x, y)
            want = ttk.fused_train_batch_plain(cfg_k, want, kb, x, y)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(got, want):
                fail(f"tm_train != plain twin at {kw}, step {step}: max abs err {err}")
        print(f"parity tm_train {kw} B=128: 2 chained steps equal")
    # the kernel's wrapper and its plain version on the same clause words
    p0 = pack_ta_state(cfg, state_a).contiguous()
    x128, y128 = batch(128)
    plits = ttk._pack_batch(x128)
    cw = ttk.packed_clause_words(p0.reshape(M, C, L) >= 0, plits)
    kb = prng.fold_in(key, 9)
    tm_args = (cfg, p0, cw, plits, y128, kb)
    if not torch.equal(ttk.tm_train(*tm_args), ttk.tm_train_plain(*tm_args)):
        fail("tm_train != tm_train_plain on the same clause words")
    print("parity tm_train wrapper vs tm_train_plain: equal")

    # -- 2. the packed engine against the reference engine ----------------
    engines = {name: make_train_engine(name, cfg, device=dev)
               for name in ("packed", "reference")}
    steps = [batch(128) for _ in range(2)]
    finals = {}
    for name, eng in engines.items():
        internal = eng.prepare(state_a)
        for j, (x, y) in enumerate(steps):
            internal = eng.fit_step(internal, key, x, y, step=j)
        finals[name] = eng.canonical(internal)
    if not torch.equal(finals["packed"], finals["reference"]):
        fail("the packed engine's state != the reference engine's")
    print("engines: packed == reference (parallel=True) after 2 steps at B=128")

    # -- 3. the loop: deploy, observe, recalibrate, swap, rollback --------
    X512, n_train, epochs = X[:512], 384, 2

    def oracle(state, x):
        return torch.cat([
            batch_class_sums(cfg, state, torch.from_numpy(x[i:i + 32]).to(dev))
            for i in range(0, x.shape[0], 32)
        ]).cpu().numpy()

    # the loop's machine: model a's actions with its TAs 8 states from the
    # decision boundary, as a trained machine's sit (not on it, where one
    # push flips an action)
    include = torch.from_numpy(acts_a).to(dev)
    state_t = torch.where(include, cfg.n_states + 8, cfg.n_states - 7).to(torch.int32)
    # training is deterministic: a throw-away worker takes the steps the
    # recalibration will take, so the plan is negotiated for the model it
    # publishes (a CapacityExceeded would fail the phase)
    rehearsal = RecalWorker(cfg, state_t, key=prng.key(6), device=dev)
    rehearsal.fine_tune_epochs(X512[:n_train], pred_b[:n_train], epochs=epochs,
                               batch=128)
    model_a = encode(cfg, acts_a)
    model_r = encode(cfg, include_actions(cfg, rehearsal.state).cpu().numpy())
    plan = CapacityPlan.for_models([model_a, model_r], batch_words=256)
    print(f"recal plan: {plan.as_dict()}; the recalibrated model has "
          f"{int(include_actions(cfg, rehearsal.state).sum())} includes")
    acc = Accelerator(plan, device=dev)
    queued = {}

    class QueueBeforeSwap(Compressor):
        """Queues traffic right after the publication gate, so the
        hot-swap drains it under the old program."""

        def compress(self, *args, **kwargs):
            report = super().compress(*args, **kwargs)
            if kwargs.get("traffic_sample") is not None:
                queued["handle"] = acc.submit("mnist", X512)
            return report

    worker = RecalWorker(cfg, state_t, key=prng.key(6), device=dev)
    default = RecalWorker(cfg, state_t) if dev.type == "cuda" else worker
    if default.train_engine != "packed" or default.device != dev:
        fail(f"the default worker runs {default.train_engine} on {default.device}")
    ctl = RecalController(
        acc, "mnist", worker, compressor=QueueBeforeSwap(plan=plan, engine=acc),
        buffer_batches=4, epochs_per_recal=epochs, train_batch_size=128,
        regression_margin=1.0,  # the rollback below is forced
    )
    torch.cuda.synchronize()
    for mod in (cek, ttk, tmk):
        mod.launches = 0
    ctl.deploy()
    sums_a = oracle(state_a, X512)
    if not np.array_equal(acc.class_sums("mnist", X512), sums_a):
        fail("the deployed model's sums differ from the oracle of model a")
    acc.start()  # the first batch is served by the scheduler loop
    ctl.observe(X512[:128], pred_b[:128])
    acc.stop()
    for i in range(128, 512, 128):
        ctl.observe(X512[i:i + 128], pred_b[i:i + 128])
    event = ctl.recalibrate(reason="smoke")
    published = worker.state
    torch.cuda.synchronize()
    if event.rolled_back or event.steps_taken != epochs * n_train // 128:
        fail(f"recalibration went wrong: {event}")
    if not np.array_equal(queued["handle"].result(), sums_a.argmax(1)):
        fail("traffic queued before the swap was not served by the old model")
    if not torch.equal(published, rehearsal.state):
        fail("the recalibration did not reproduce the throw-away worker's state")
    blob = TMProgram(capacity=plan, model=model_r).to_bytes()
    if acc.installed_artifact("mnist").to_bytes() != blob:
        fail("the installed artifact is not the recalibrated model's TMProgram")
    if not np.array_equal(acc.class_sums("mnist", X512), oracle(published, X512)):
        fail("served sums after the swap differ from the oracle of the published state")
    if not acc.registry.get("mnist").provenance.startswith("recal:"):
        fail(f"provenance {acc.registry.get('mnist').provenance!r} after the swap")
    acc.rollback("mnist")
    if not np.array_equal(acc.class_sums("mnist", X512), sums_a):
        fail("the forced rollback did not restore model a")
    if acc.compile_cache_size() != 1:
        fail(f"compile_cache_size() == {acc.compile_cache_size()} in the recal loop")
    torch.cuda.synchronize()
    counts = {"clause_eval": cek.launches, "tm_train": ttk.launches,
              "tm_popcount": tmk.launches}
    for name, n in counts.items():
        if n == 0:
            fail(f"the recal loop never launched {name}")
    print(f"recal loop: deploy, 4 observes (one by the scheduler loop), "
          f"{event.steps_taken} fine-tune steps, swap under queued traffic, "
          f"rollback; holdout acc {event.holdout_acc_before:.4f} -> "
          f"{event.holdout_acc_after:.4f}; train_s {event.train_s:.6f}, "
          f"compress_s {event.compress_s:.6f}, swap_s {event.swap_s:.6f}; "
          f"compression ratio {event.compression_ratio:.3f}; "
          f"compile_cache_size 1; launches {counts}")

    # -- 4. times at B = 128 ----------------------------------------------
    packed_eng, ref_eng = engines["packed"], engines["reference"]
    int_p, int_r = packed_eng.prepare(state_a), ref_eng.prepare(state_a)
    x, y = steps[0]
    fit_ms = {
        "packed engine (clause_eval + tm_train kernels)": median_ms(
            lambda: packed_eng.fit_step(int_p, key, x, y, step=0)),
        "plain twin (fused_train_batch_plain)": median_ms(
            lambda: ttk.fused_train_batch_plain(cfg, int_p, prng.fold_in(key, 0), x, y),
            reps=3, warmup=1),
        "reference engine (parallel=True)": median_ms(
            lambda: ref_eng.fit_step(int_r, key, x, y, step=0), reps=3, warmup=1),
    }
    seq = make_train_engine("reference", cfg, parallel=False, device=dev)
    int_s = seq.prepare(state_a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq.fit_step(int_s, key, x, y, step=0)
    torch.cuda.synchronize()
    fit_ms["reference engine (parallel=False, one call, host clock)"] = (
        time.perf_counter() - t0) * 1e3
    for name, ms in fit_ms.items():
        print(f"time fit_step B=128 {name}: {ms:.6f} ms")
    k_ms = median_ms(lambda: ttk.tm_train(*tm_args))
    print(f"clock 3c: SM clock (MHz) during back-to-back tm_train calls: "
          f"{clocks_during(lambda: ttk.tm_train(*tm_args))}")
    p_ms = median_ms(lambda: ttk.tm_train_plain(*tm_args), reps=3, warmup=1)
    n_bytes, n_ops, hashes = train_work(*tm_args)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"time tm_train B=128: kernel {k_ms:.6f} ms, plain {p_ms:.6f} ms "
          f"(median of 3), bound {bound_ms:.6f} ms ({bound_by}; {n_bytes} B, "
          f"{n_ops} ops, {hashes} hashes)")
    for what, fn in (("tm_train", lambda: ttk.tm_train(*tm_args)),
                     ("fit_step packed", lambda: packed_eng.fit_step(
                         int_p, key, x, y, step=0))):
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        us, n_ops, ops = device_per_call(prof, 10)
        for key_name, count, total in ops:
            if key_name.startswith("(anonymous namespace)::"):
                print(f"profile 3c {what}: {key_name[23:60]} {total / count:.3f} "
                      f"us/launch x{count}")
        print(f"profile 3c: {what} {us:.3f} us on the device per call, "
              f"{n_ops} device operations per call")
    return ("tm_train", "src/repro/kernels/tm_train/kernel.py:88", counts["tm_train"],
            max_err,
            (k_ms, p_ms, bound_ms, bound_by, None))


def dense_sums(cfg, acts, w, x, dev, chunk=256):
    """int32 [B, M] dense oracle sums of ``acts`` (weights ``w``) on the
    card, ``chunk`` rows at a time (each chunk holds chunk x M x C x 2F
    booleans)."""
    import numpy as np
    import torch
    from repro_torch.core import batch_class_sums_weighted, state_from_actions

    state = state_from_actions(cfg, torch.from_numpy(acts).to(dev))
    wt = None if w is None else torch.from_numpy(np.asarray(w, np.int32)).to(dev)
    return torch.cat([
        batch_class_sums_weighted(cfg, state, torch.from_numpy(x[i:i + chunk]).to(dev), wt)
        for i in range(0, x.shape[0], chunk)
    ]).cpu().numpy()


def messy_actions(acts):
    """Model a's actions seeded with every dead-clause species, as
    tests/test_prune.py:80 seeds them: all-excluded rows, a contradictory
    clause, a cancelling duplicate pair and a same-parity pair."""
    acts = acts.copy()
    C = acts.shape[1]
    acts[:, C - 1, :] = False
    acts[0, 1] = False
    acts[0, 1, 0] = acts[0, 1, 1] = True
    acts[1, 0] = acts[1, 1] = False
    acts[1, 0, 2] = acts[1, 1, 2] = True
    acts[2, 0] = acts[2, 2] = False
    acts[2, 0, 4] = acts[2, 2, 4] = True
    return acts


def stream_phase(dev, cfg, served, models, X, pred_b, oracles):
    """Phase 3d: the paper's stream interpreter and pruning on the card, at
    the width of models a and b (``models``: name -> (actions, weights,
    model); ``oracles``: name -> their dense sums on ``X``).  Returns the
    ``interp_stream`` row of the kernels line."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import prune
    from repro_torch.accel import Accelerator, CapacityPlan
    from repro_torch.core import decode_to_plan, decode_weights, encode, prng
    from repro_torch.core import runtime
    from repro_torch.core.interp import pack_features
    from repro_torch.kernels.clause_eval import kernel as cek
    from repro_torch.kernels.interp_stream import kernel as isk
    from repro_torch.kernels.tm_popcount import kernel as tmk
    from repro_torch.kernels.tm_train import kernel as ttk
    from repro_torch.prune.rank import clause_fire_counts_plain
    from repro_torch.recal import Compressor, RecalController, RecalWorker

    M, C, L = cfg.n_classes, cfg.n_clauses, cfg.n_literals
    I_CAP = served.instruction_capacity
    acts_a, _, model_a = models["a"]
    model_b = models["b"][2]
    Xt = torch.from_numpy(X).to(dev)

    def imem_of(model):
        imem = np.zeros(I_CAP, np.int32)
        imem[: model.n_instructions] = model.instructions
        return torch.from_numpy(imem).to(dev)

    def wmem_of(model):
        wmem = np.ones(I_CAP, np.int32)
        wmem[: model.n_weights] = model.clause_weights
        return torch.from_numpy(wmem).to(dev)

    # -- 1. the new kernel against its twin ------------------------------
    feats = pack_features(Xt, L // 2, 256)  # [784, 256]
    feats37 = pack_features(Xt[:37], L // 2, 2)
    stream_cases = {
        "model a W=256": (imem_of(model_a), model_a.n_instructions, feats, None),
        "model b (weighted) W=256": (imem_of(model_b), model_b.n_instructions,
                                     feats, wmem_of(model_b)),
        "model a ragged 37 rows": (imem_of(model_a), model_a.n_instructions,
                                   feats37, None),
        "model b W=1": (imem_of(model_b), model_b.n_instructions,
                        feats[:, :1].contiguous(), wmem_of(model_b)),
    }
    stream_err = 0
    for name, (imem, n_inst, f, wmem) in stream_cases.items():
        got = isk.interp_stream(imem, n_inst, f, wmem, m_cap=M)
        want = isk.interpret_stream_plain(imem, n_inst, f, wmem, M)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        stream_err = max(stream_err, err)
        if not torch.equal(got, want):
            fail(f"interp_stream != its plain twin on {name}: max abs err {err}")
        print(f"parity interp_stream {name}: equal, sums shape {tuple(got.shape)}")
    # launch A's tables against the plain decode, on the served memory and
    # cut short (the evaluation reads nothing else)
    for name in ("model a W=256", "model b (weighted) W=256"):
        imem, n_inst, f, wmem = stream_cases[name]
        for n in (n_inst, n_inst // 3):
            got_t = isk.decode_stream(imem, n, f.shape[0], M, wmem)
            want_t = isk.decode_stream_plain(imem, n, f.shape[0], M, wmem)
            torch.cuda.synchronize()
            if got_t.n_mid != want_t.n_mid or not all(
                torch.equal(a, b) for a, b in zip(got_t[:-1], want_t[:-1])
            ):
                fail(f"interp_stream's decode tables != decode_stream_plain on "
                     f"{name}, {n} instructions")
        print(f"parity interp_stream decode {name}: tables equal "
              f"({got_t.include_row.numel()} includes, {got_t.clause_row.numel()} "
              f"clauses at {n} instructions; all instructions too)")
    oracle_a, oracle_b = oracles["a"], oracles["b"]
    got = isk.interp_stream(*stream_cases["model a W=256"][:2], feats, m_cap=M)
    if not np.array_equal(got.T.cpu().numpy(), oracle_a):
        fail("interp_stream's sums of model a differ from the dense oracle")
    # the traffic sweep of pruning against its plain version
    for B in (512, 37):
        got = prune.clause_fire_counts(cfg, acts_a, X[:B], device=dev)
        want = clause_fire_counts_plain(cfg, acts_a, X[:B], device=dev)
        if not np.array_equal(got, want):
            fail(f"clause_fire_counts on the card != its plain version at B={B}")
        print(f"parity clause_fire_counts B={B}: equal, {int(got.sum())} firings")

    # the loop's machine: model a's actions 8 states off the boundary.  Its
    # class 9 holds 30 identical positive clauses that fire iff feature 60
    # is 1 and 30 identical negative ones that fire iff it is 0 (features
    # 0..59 are set to 1 in the loop's traffic, and every clause of the
    # class includes them) beside 140 contradictory clauses, and the label
    # is 9 exactly where feature 60 is 1.  Its training sum is then +30 or
    # -30 (|sum| >= T), so no feedback ever selects its clauses: the prune
    # pass merges each group into one clause of weight 30, the ranked drop
    # keeps both (they decide half the labels), and every publication is
    # weighted (v2)
    K = M - 1
    acts_l = acts_a.copy()
    acts_l[K] = False
    acts_l[K, :, 0:120:2] = True
    acts_l[K, 0:60:2, 120] = True  # x60
    acts_l[K, 1:60:2, 121] = True  # NOT x60
    acts_l[K, 60:, 122] = acts_l[K, 60:, 123] = True  # x61 AND NOT x61
    X_loop = X[:512].copy()
    X_loop[:, :60] = 1
    y_loop = np.where(X_loop[:, 60] == 1, K,
                      np.where(pred_b[:512] == K, 0, pred_b[:512])).astype(np.int32)
    state_l = torch.where(torch.from_numpy(acts_l).to(dev), cfg.n_states + 8,
                          cfg.n_states - 7).to(torch.int32)
    policy = prune.PrunePolicy(tolerance=0.02)
    n_train, epochs = 384, 2
    rehearsal = RecalWorker(cfg, state_l, key=prng.key(7), device=dev)
    rehearsal.fine_tune_epochs(X_loop[:n_train], y_loop[:n_train], epochs=epochs,
                               batch=128)
    model_l = encode(cfg, acts_l)
    model_r = encode(cfg, (rehearsal.state > cfg.n_states).cpu().numpy())
    loop_plan = dataclasses.replace(
        CapacityPlan.for_models([model_l, model_r], batch_words=256), weight_planes=8
    )
    messy = messy_actions(acts_a)
    torch.cuda.synchronize()

    # -- 2. the main path of the phase, its launches counted ---------------
    mods = {"clause_eval": cek, "interp_stream": isk, "tm_popcount": tmk,
            "tm_train": ttk}
    for mod in mods.values():
        mod.launches = 0
    pop = Accelerator(served, device=dev)
    engines = {name: Accelerator(served, engine=name, device=dev)
               for name in ("interp", "plan")}
    blobs = {k: pop.compile(models[k][2]).to_bytes() for k in ("a", "b")}
    for step, k in enumerate("aba"):
        pop.load("mnist", blobs[k], provenance=f"swap {step}")
        want = pop.class_sums("mnist", X)
        if not np.array_equal(want, oracles[k]):
            fail(f"popcount-served sums of model {k} differ from the oracle")
        for name, acc in engines.items():
            acc.load("mnist", blobs[k], provenance=f"swap {step}")
            if not np.array_equal(acc.class_sums("mnist", X), want):
                fail(f"the {name} engine's sums of model {k} (swap {step}) differ "
                     f"from the popcount-served sums")
    for name, acc in engines.items():
        if acc.compile_cache_size() != 1:
            fail(f"the {name} engine has {acc.compile_cache_size()} operand signatures")
    print(f"engines interp, plan: 8192 rows of models a -> b -> a equal to popcount "
          f"and the oracle, compile_cache_size 1")

    # the paper's base runtime: an instruction stream, then a feature stream
    base = runtime.Accelerator(runtime.AcceleratorConfig(batch_words=256), device=dev)
    base.feed(runtime.build_instruction_stream(model_a))
    preds = base.feed(runtime.build_feature_stream(X))
    if not np.array_equal(preds, oracle_a.argmax(1)):
        fail("core.runtime.Accelerator's predictions differ from the oracle")
    multi = runtime.MultiCoreAccelerator(
        4, runtime.AcceleratorConfig(batch_words=256), device=dev)
    multi.load_model(model_a)
    if not np.array_equal(multi.infer(X), preds):
        fail("MultiCoreAccelerator(4) disagrees with the single core")
    if base.compile_cache_size() != 1:
        fail(f"core.runtime.Accelerator has {base.compile_cache_size()} signatures")
    print("base runtime: stream-fed predictions of 8192 rows equal the oracle; "
          "4 cores equal 1")

    # the exact passes: served bit-exactly on every engine
    t0 = time.perf_counter()
    exact = prune.prune_exact(cfg, messy)
    merged = prune.merge_weighted(cfg, exact.actions, exact.weights)
    exact_s = time.perf_counter() - t0
    m_exact = encode(cfg, exact.actions, exact.weights)
    m_merged = encode(cfg, merged.actions, merged.weights)
    prune_plan = CapacityPlan.for_models(
        [encode(cfg, messy), m_exact, m_merged], batch_words=256)
    if prune_plan.weight_planes < 2:
        fail(f"the merged model needs {prune_plan.weight_planes} weight plane(s)")
    oracle_m = dense_sums(cfg, messy, None, X, dev)
    for name in ("popcount", "interp", "plan"):
        acc = Accelerator(prune_plan, engine=name, device=dev)
        for label, model in (("exact", m_exact), ("merged", m_merged)):
            acc.load("m", acc.compile(model))
            if not np.array_equal(acc.class_sums("m", X), oracle_m):
                fail(f"the {label} model served on {name} differs from the "
                     f"unpruned oracle")
    print(f"prune_exact + merge_weighted: {exact.report.n_dead} dead, "
          f"{merged.report.n_merged} merged ({exact_s:.6f} s on the host); served "
          f"at weight_planes {prune_plan.weight_planes} on popcount, interp and "
          f"plan equal to the unpruned oracle on 8192 rows")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ranked = prune.prune_ranked(cfg, acts_a, X[:512], pred_b[:512], tolerance=0.02,
                                device=dev)
    ranked_s = time.perf_counter() - t0
    rep = ranked.report
    if rep.pruned_accuracy < rep.baseline_accuracy - 0.02:
        fail(f"prune_ranked broke its tolerance: {rep}")
    print(f"prune_ranked tolerance 0.02 on 512 rows labelled by model b: "
          f"{rep.n_clauses_before} -> {rep.n_clauses_after} clauses, accuracy "
          f"{rep.baseline_accuracy:.4f} -> {rep.pruned_accuracy:.4f}, "
          f"{ranked_s:.6f} s")

    # the loop with pruning: recalibrate -> publish (v2) -> swap under traffic
    acc = Accelerator(loop_plan, device=dev)
    queued = {}

    class QueueBeforeSwap(Compressor):
        """Queues traffic right after the publication gate, so the
        hot-swap drains it under the old program."""

        def compress(self, *args, **kwargs):
            report = super().compress(*args, **kwargs)
            if kwargs.get("traffic_sample") is not None:
                queued["handle"] = acc.submit("mnist", X_loop)
            return report

    worker = RecalWorker(cfg, state_l, key=prng.key(7), device=dev)
    ctl = RecalController(
        acc, "mnist", worker, compressor=QueueBeforeSwap(plan=loop_plan, engine=acc),
        buffer_batches=4, epochs_per_recal=epochs, train_batch_size=128,
        regression_margin=1.0, prune=policy,
    )
    ctl.deploy()
    deployed = acc.installed_artifact("mnist").model
    old = acc.class_sums("mnist", X_loop)
    if not np.array_equal(old, dense_sums(cfg, acts_l, None, X_loop, dev)):
        fail("the deployed (exact + merged) model differs from the loop's oracle")
    for i in range(0, 512, 128):
        ctl.observe(X_loop[i:i + 128], y_loop[i:i + 128])
    event = ctl.recalibrate(reason="smoke")
    torch.cuda.synchronize()
    art = acc.installed_artifact("mnist")
    if event.rolled_back or event.prune_stages != ("exact", "merge", "ranked"):
        fail(f"the pruned recalibration went wrong: {event}")
    if art.format_version != 2 or not art.model.weighted:
        fail(f"the pruned recalibration published format v{art.format_version}")
    if not np.array_equal(queued["handle"].result(), old.argmax(1)):
        fail("traffic queued before the pruned swap was not served by the old model")
    if not torch.equal(worker.state, rehearsal.state):
        fail("the recalibration did not reproduce the throw-away worker's state")
    pub_acts, pub_w = decode_weights(art.model)
    served_sums = acc.class_sums("mnist", X_loop)
    if not np.array_equal(served_sums, dense_sums(cfg, pub_acts, pub_w, X_loop, dev)):
        fail("served sums after the pruned swap differ from the oracle of the "
             "published pruned weights")
    if acc.compile_cache_size() != 1:
        fail(f"compile_cache_size() == {acc.compile_cache_size()} in the pruned loop")
    torch.cuda.synchronize()
    counts = {name: mod.launches for name, mod in mods.items()}
    for name in ("clause_eval", "interp_stream", "tm_popcount"):
        if counts[name] == 0:
            fail(f"phase 3d never launched {name}")
    print(f"pruned recal loop: deployed {deployed.n_instructions} instructions "
          f"(weighted {deployed.weighted}); {event.steps_taken} steps, stages "
          f"{event.prune_stages}, {event.pruned_clauses} clauses pruned, published "
          f"v{art.format_version} with {art.model.n_weights} weights (max "
          f"{int(art.model.clause_weights.max())}); holdout acc "
          f"{event.holdout_acc_before:.4f} -> {event.holdout_acc_after:.4f}; train_s "
          f"{event.train_s:.6f}, compress_s (with pruning) {event.compress_s:.6f}, "
          f"swap_s {event.swap_s:.6f}; compile_cache_size 1; launches {counts}")

    # -- 3. times ------------------------------------------------------------
    for name, e in engines.items():
        e.load("mnist", blobs["a"])

        def flush(e=e):
            e.submit("mnist", X)
            e.flush()

        print(f"time flush of 8192 rows on the {name} engine (submit + flush, "
              f"CUDA events): {median_ms(flush, reps=PLAIN_REPS, warmup=2):.6f} ms "
              f"(median of {PLAIN_REPS})")
        with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA,
        ]) as prof:
            t0 = time.perf_counter()
            flush()
            wall_us = (time.perf_counter() - t0) * 1e6
        ops = device_ops(prof)
        busy_us = sum(op[0] for op in ops)
        print(f"profile 3d flush {name}: wall {wall_us:.1f} us, device busy "
              f"{busy_us:.1f} us (idle share {1 - busy_us / wall_us:.3f})")
        for us, key, count in ops[:6]:
            print(f"profile 3d flush {name}: {us:.1f} us  x{count}  {key[:80]}")
    imem_a, n_a = stream_cases["model a W=256"][:2]
    k_ms = median_ms(lambda: isk.interp_stream(imem_a, n_a, feats, m_cap=M))
    p_ms = median_ms(lambda: isk.interpret_stream_plain(imem_a, n_a, feats, None, M),
                     reps=3, warmup=1)
    plan_a = decode_to_plan(model_a)
    W = feats.shape[1]
    # each live instruction, the feature memory and the sums moved once;
    # one AND per include and word, 32 adds per finalized clause and word
    n_bytes = 4 * (n_a + feats.numel() + M * 32 * W)
    n_ops = (plan_a.n_includes + 32 * plan_a.n_clauses_total) * W
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"time interp_stream model a W=256: kernel {k_ms:.6f} ms, plain "
          f"{p_ms:.6f} ms (median of 3), bound {bound_ms:.6f} ms ({bound_by}; "
          f"{n_bytes} B, {n_ops} ops)")
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        for _ in range(10):
            isk.interp_stream(imem_a, n_a, feats, m_cap=M)
        torch.cuda.synchronize()
    us, n_dev, ops = device_per_call(prof, 10)
    for key_name, count, total in ops:
        print(f"profile 3d interp_stream: {key_name[:60]} {total / count:.3f} "
              f"us/launch x{count}")
    span, n_span = span_us(prof, "decode_kernel", "evaluate_kernel")
    print(f"profile 3d: interp_stream {us:.3f} us on the device per call, "
          f"{n_dev} device operations per call; span decode..evaluate "
          f"{span:.3f} us (median of {n_span})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy.apply(cfg, acts_a, X=X[:512], y=pred_b[:512], device=dev)
    print(f"time PrunePolicy(tolerance=0.02).apply on model a, 512 labelled rows: "
          f"{time.perf_counter() - t0:.6f} s (host clock)")
    return ("interp_stream", "src/repro/core/interp.py:82", counts["interp_stream"],
            stream_err, (k_ms, p_ms, bound_ms, bound_by, None))


def fleet_phase(dev, cfg, served, models, X, oracles):
    """Phase 3e: the fleet (``repro_torch.fleet``) at the width of models a
    and b (``models``: name -> (actions, weights, model); ``oracles``: name
    -> the dense int32 [8192, 10] sums).  Four nodes on the card: ``TMServer``
    on the ``interp``, ``plan``, ``popcount`` and ``sharded`` engines (the
    bench's cycle; the sharded node on a (1, 2) mesh of the card); the four
    scenarios of benchmarks/tm_fleet.py, the launches of ``tm_popcount``,
    ``interp_stream`` and ``clause_table`` counted."""
    import threading
    from collections import Counter

    import numpy as np
    import torch
    from repro_torch.accel import TMProgram
    from repro_torch.core import encode
    from repro_torch.fleet import (
        ChaosNode,
        FleetHealth,
        FleetPool,
        RetryPolicy,
        RolloutAborted,
        RolloutManager,
        Router,
    )
    from repro_torch.dist import make_mesh
    from repro_torch.kernels.clause_table import kernel as ctk
    from repro_torch.kernels.interp_stream import kernel as isk
    from repro_torch.kernels.tm_popcount import kernel as tmk
    from repro_torch.serve_tm import TMServer

    t_phase = time.perf_counter()
    n_rows = X.shape[0]
    arts = {k: TMProgram(capacity=served, model=models[k][2]) for k in "ab"}

    def replied(h, timeout=120.0):
        """The predictions of a routed request; a request that failed or
        never completed fails the phase."""
        try:
            return h.wait(timeout=timeout)
        except Exception as e:
            fail(f"phase 3e: a request routed to {getattr(h, 'routed_to', '?')} "
                 f"failed: {type(e).__name__}: {e}")

    def exact(k, h, preds, off):
        want = oracles[k][off:off + h.n_rows]
        return (np.array_equal(preds, want.argmax(1))
                and np.array_equal(np.asarray(h.class_sums), want))

    torch.cuda.synchronize()
    for mod in (tmk, isk, ctk):
        mod.launches = 0
    nodes = {f"n{i}": TMServer(served, engine=e, device=dev)
             for i, e in enumerate(("interp", "plan", "popcount"))}
    nodes["n3"] = TMServer(served, engine="sharded", mesh=make_mesh((1, 2), devices=dev))
    engines = [n.executor.name for n in nodes.values()]
    if engines != ["interp", "plan", "popcount", "sharded"]:
        fail(f"phase 3e nodes run {engines}")
    for node in nodes.values():
        node.register("mnist", arts["a"])
    # bounded retries outlast a full lane (admission control) while the
    # loops drain it
    retry = RetryPolicy(max_attempts=12, backoff_max_s=0.05)

    # -- 1. pool sweep: 48 requests of 37..8192 rows over 1, 2, 4 nodes ----
    rng = np.random.default_rng(11)
    sizes = rng.integers(37, n_rows + 1, 48)
    offs = [int(rng.integers(0, n_rows - r + 1)) for r in sizes]
    rates = {}
    for n in (1, 2, 4):
        pool = FleetPool({name: nodes[name] for name in list(nodes)[:n]})
        router = Router(pool, retry=retry)
        pool.start_all()
        t0 = time.perf_counter()
        handles = [(router.submit("mnist", X[o:o + r]), o) for o, r in zip(offs, sizes)]
        replies = [(h, replied(h), o) for h, o in handles]
        torch.cuda.synchronize()
        routed_s = time.perf_counter() - t0
        rates[n] = len(handles) / routed_s
        pool.stop_all()
        if not all(exact("a", h, p, o) for h, p, o in replies):
            fail(f"phase 3e pool of {n}: a reply differs from model a's oracle")
        health = router.health.summary()
        print(f"fleet 3e pool {n} {engines[:n]}: {int(sizes.sum())} rows in 48 "
              f"requests, {routed_s:.6f} s, {sizes.sum() / routed_s:.1f} rows/s, "
              f"{rates[n]:.1f} requests/s "
              f"(host clock, loops running); routed "
              f"{dict(Counter(h.routed_to for h, _ in handles))}; overloads "
              f"{sum(s['overloads'] for s in health.values())}, retries "
              f"{sum(s['retries'] for s in health.values())}; every reply "
              f"equal to the oracle")

    # seconds between requests for an offered load of a quarter of the
    # requests four nodes routed (a flush costs about the same host time
    # whatever its rows): a load above the service rate grows every queue
    # without bound, and a hot-swap drains its node's queue to empty
    # before it installs
    pace = 1 / (0.25 * rates[4])

    # -- 2. rollout a -> b under router traffic -----------------------------
    pool = FleetPool(nodes)
    router = Router(pool, retry=retry)
    holdout = X[:512]
    y_b = oracles["b"][:512].argmax(1)
    block = 1024
    traffic, traffic_errors, stop = [], [], threading.Event()

    def keep_traffic():
        i = 0
        while not stop.is_set():
            off = (i % (n_rows // block)) * block
            try:
                traffic.append((router.submit("mnist", X[off:off + block]), off))
            except Exception as e:  # read and failed on below
                traffic_errors.append(e)
            i += 1
            time.sleep(pace)

    pool.start_all()
    thread = threading.Thread(target=keep_traffic, daemon=True)
    thread.start()
    time.sleep(0.05)  # traffic in flight before the rollout starts
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        try:
            report = RolloutManager(pool, gate_timeout_s=60.0).rollout(
                "mnist", arts["b"], holdout_x=holdout, holdout_y=y_b,
                min_accuracy=0.99)
        except RolloutAborted as e:
            fail(f"phase 3e: the rollout of model b aborted: {e}")
        torch.cuda.synchronize()
        rollout_s = time.perf_counter() - t0
    time.sleep(0.05)  # traffic after the rollout, on model b
    stop.set()
    thread.join(timeout=30)
    if thread.is_alive() or traffic_errors:
        fail(f"phase 3e: the traffic thread failed: {traffic_errors[:3]}")
    on = Counter()
    for h, off in traffic:
        preds = replied(h)
        k = next((k for k in "ab" if exact(k, h, preds, off)), None)
        if k is None:
            fail("phase 3e: a reply during the rollout is neither a's nor b's oracle")
        on[k] += 1
    if not (report.completed and [s.stage for s in report.stages]
            == ["canary", "wave", "fleet"]
            and all(s.bit_exact and s.checksum_ok and s.passed for s in report.stages)):
        fail(f"phase 3e: the rollout's stages failed their gates: {report.stages}")
    if any(node.installed_checksum("mnist") != arts["b"].checksum
           for node in nodes.values()):
        fail("phase 3e: a node is not on model b after the rollout")
    ops = device_ops(prof)
    busy_us = sum(op[0] for op in ops)
    print(f"fleet 3e rollout a -> b: {len(traffic)} requests of {block} rows under "
          f"traffic, 0 dropped, {on['a']} on a and {on['b']} on b, each equal to "
          f"its oracle; rollout {rollout_s:.6f} s")
    for s in report.stages:
        print(f"fleet 3e rollout stage {s.stage} {list(s.nodes)}: install_s "
              f"{s.install_s:.6f}, verify_s {s.verify_s:.6f}, accuracy "
              f"{s.accuracy}, bit_exact {s.bit_exact}, checksum_ok {s.checksum_ok}")
    print(f"profile 3e rollout: wall {rollout_s * 1e6:.1f} us, device busy "
          f"{busy_us:.1f} us (idle share {1 - busy_us / (rollout_s * 1e6):.3f})")
    for us, key, count in ops[:6]:
        print(f"profile 3e rollout: {us:.1f} us  x{count}  {key[:80]}")

    # -- 3. canary failure: b with its class rows rotated -------------------
    acts_b, w_b, _ = models["b"]
    rotated = TMProgram(capacity=served, model=encode(
        cfg, np.roll(acts_b, 1, axis=0), np.roll(w_b, 1, axis=0)))
    try:
        RolloutManager(pool, gate_timeout_s=60.0).rollout(
            "mnist", rotated, holdout_x=holdout, holdout_y=y_b)
        fail("phase 3e: the rotated model passed the canary's gate")
    except RolloutAborted as e:
        aborted = e
    pool.stop_all()
    if aborted.stage != "canary" or aborted.report.rolled_back != ("n0",):
        fail(f"phase 3e: the canary failure aborted wrong: {aborted}")
    if any(node.installed_checksum("mnist") != arts["b"].checksum
           for node in nodes.values()):
        fail("phase 3e: a node is not back on model b after the canary failure")
    if not nodes["n0"].registry.get("mnist").provenance.startswith("rollback:"):
        fail("phase 3e: the canary has no rollback provenance")
    print(f"fleet 3e canary failure: aborted at {aborted.stage} "
          f"(canary accuracy {aborted.report.stages[-1].accuracy}, baseline "
          f"{aborted.report.baseline_accuracy}), rolled back "
          f"{list(aborted.report.rolled_back)}, every node on b's checksum")

    # -- 4. chaos: kill a node mid-traffic, revive it -----------------------
    victim = "n1"
    chaos = {name: ChaosNode(
        node, name=name, seed=100 + i, error_rate=0.03, latency_rate=0.04,
        latency_s=0.0005, overload_rate=0.02,
        hang_rate=0.05 if name == victim else 0.0,  # kill() resolves its hangs
    ) for i, (name, node) in enumerate(nodes.items())}
    cpool = FleetPool(chaos)

    class Witness(FleetHealth):
        """Notes the victim's consecutive failures at each quarantine (two
        threads record outcomes, so a later read could count more)."""

        def quarantine(self, name, reason=""):
            if name == victim:
                quarantines.append((time.perf_counter(),
                                    self.summary()[name]["consecutive_failures"]))
            super().quarantine(name, reason)

    quarantines, t_kill, down_at_kill = [], None, None
    health = Witness(pool=cpool, consecutive_failures=3, probe_after_s=0.05,
                     heartbeat_timeout_s=600.0)
    router = Router(cpool, health=health, retry=RetryPolicy(
        max_attempts=6, backoff_base_s=0.002, backoff_max_s=0.02))
    rows = served.batch_capacity // 4
    blocks = [int(o) for o in rng.integers(0, n_rows - rows + 1, 8)]
    n_critical, background = 96, []
    kill_at, revive_at = n_critical // 3, 2 * n_critical // 3
    counts = Counter()

    def load():
        i = 0
        while not stop_load.is_set():
            off = blocks[i % len(blocks)]
            try:
                background.append(router.submit("mnist", X[off:off + rows]))
            except Exception:
                pass  # best-effort load: overload or exhausted retries
            i += 1
            time.sleep(pace)

    def critical(i):
        off = blocks[i % len(blocks)]
        for attempt in range(12):
            counts["resubmits"] += attempt > 0
            try:
                h = router.submit("mnist", X[off:off + rows], priority="critical",
                                  timeout_ms=2000.0)
            except Exception:
                counts["structured_errors"] += 1
                time.sleep(0.002)
                continue
            try:
                preds = h.wait(timeout=1.0)
            except TimeoutError:
                continue  # a hung handle: the retry moves on
            except Exception:
                counts["structured_errors"] += 1
                continue
            return "correct" if exact("b", h, preds, off) else "incorrect"
        return "lost"

    stop_load = threading.Event()
    cpool.start_all()
    thread = threading.Thread(target=load, daemon=True)
    t0 = time.perf_counter()
    thread.start()
    for i in range(n_critical):
        if i == kill_at:
            down_at_kill = health.state(victim)
            t_kill = time.perf_counter()
            chaos[victim].kill()
        if i == revive_at:
            chaos[victim].revive()
            chaos[victim].rates["hang"] = 0.0
            time.sleep(health.probe_after_s + 0.02)  # the cooldown elapses
        counts[critical(i)] += 1
    stop_load.set()
    thread.join(timeout=30)
    unresolved = 0
    for h in background:
        try:
            h.wait(timeout=60.0)
        except TimeoutError:
            unresolved += 1
        except Exception:
            pass  # a structured failure (NodeDown, EngineFault) is terminal
    cpool.stop_all()
    chaos_s = time.perf_counter() - t0
    vict = health.summary()[victim]
    if thread.is_alive() or counts["lost"] or counts["incorrect"] or unresolved:
        fail(f"phase 3e chaos: {dict(counts)}, {unresolved} unresolved handles")
    after_kill = [n for t, n in quarantines if t >= t_kill]
    if down_at_kill != "quarantined" and not (after_kill and after_kill[0] <= 3):
        fail(f"phase 3e chaos: the victim was not quarantined within 3 "
             f"consecutive failures of its kill: {after_kill}, {vict}")
    if vict["probes"] < 1 or vict["state"] in ("quarantined", "half_open"):
        fail(f"phase 3e chaos: the victim did not recover through a probe: {vict}")
    faults = Counter(f for c in chaos.values() for _, _, f in c.fault_log)
    print(f"fleet 3e chaos: {n_critical} critical requests of {rows} rows, "
          f"{counts['correct']} correct, 0 lost, 0 incorrect, "
          f"{counts['resubmits']} resubmits, {counts['structured_errors']} "
          f"structured errors; {len(background)} background requests, 0 "
          f"unresolved; victim {victim} ({down_at_kill} when killed at request "
          f"{kill_at}) quarantined after {after_kill[:1]} consecutive failures, "
          f"{len(quarantines)} quarantine(s) in all, revived at {revive_at}, "
          f"{vict['probes']} probe(s), ends {vict['state']}; faults "
          f"{dict(faults)}; {chaos_s:.6f} s")

    torch.cuda.synchronize()
    launched = {"tm_popcount": tmk.launches, "interp_stream": isk.launches,
                "clause_table": ctk.launches}
    caches = {name: node.compile_cache_size() for name, node in nodes.items()}
    if any(n != 1 for n in caches.values()):
        fail(f"phase 3e: compile_cache_size() after the swaps: {caches}")
    for name, n in launched.items():
        if n == 0:
            fail(f"phase 3e never launched {name}")
    print(f"fleet 3e: compile_cache_size 1 on every node; launches {launched}; "
          f"phase {time.perf_counter() - t_phase:.3f} s")


def plan_from_actions(acts):
    """The ``DecodedPlan`` that ``decode_to_plan(encode(cfg, acts))`` gives
    for the include actions ``acts`` (bool tensor [M, C, 2F], any device),
    read off the actions directly: tm-xl's 5.4M includes are too many for
    the host walks of ``encode`` and the decode.  Phase 3f checks the two
    equal at tm-paper."""
    import torch
    from repro_torch.core.compress import DecodedPlan

    M, C, L2 = acts.shape
    nz = torch.nonzero(acts.reshape(M * C, L2))  # sorted by (clause, literal)
    rows, clause_id = torch.unique_consecutive(nz[:, 0], return_inverse=True)
    pol = torch.where(rows % C % 2 == 0, 1, -1)
    return DecodedPlan(
        lit_idx=nz[:, 1].int().cpu().numpy(),
        clause_id=clause_id.int().cpu().numpy(),
        clause_class=(rows // C).int().cpu().numpy(),
        clause_pol=pol.int().cpu().numpy(),
        n_classes=M, n_features=L2 // 2,
    )


def random_tm(scfg, seed, dev):
    """(include actions bool[M, C, 2F], planted inputs bool[B, F]) of a
    sharded configuration, on ``dev``: each feature is in a clause with
    probability 2 x ``density`` and as one of its two literals (so the
    literal density is ``density`` and no clause holds a literal and its
    negation); input row r sets the features of one random clause so that
    clause fires on it, the rest of the row random.  Random rows alone
    would fire no clause of ~80-160 includes."""
    import torch

    M, C, F, B = scfg.n_classes, scfg.n_clauses, scfg.n_features, scfg.batch
    g = torch.Generator(device=dev).manual_seed(seed)
    feat = torch.rand((M, C, F), generator=g, device=dev) < 2 * scfg.density
    neg = torch.rand((M, C, F), generator=g, device=dev) < 0.5
    acts = torch.stack([feat & ~neg, feat & neg], dim=-1).reshape(M, C, 2 * F)
    x = torch.rand((B, F), generator=g, device=dev) < 0.5
    k = torch.randint(0, M * C, (B,), generator=g, device=dev)
    inc = acts.reshape(M * C, F, 2)[k]
    x = torch.where(inc[..., 0], True, torch.where(inc[..., 1], False, x))
    return acts, x


def clause_table_work(idx, pol, packed1):
    """(bytes, operations) the ``clause_table`` function needs on these
    inputs: each input read once and the sums written once; per row with
    a nonzero polarity and batch word, the ANDs until the running AND is
    zero (or every slot), and one add per set bit of its clause word."""
    import torch
    from repro_torch.core import popcount

    M, C, lc = idx.shape
    n, w = packed1.shape
    n_bytes = 4 * (idx.numel() + pol.numel() + packed1.numel() + M * w * 32)
    rows = idx.reshape(M * C, lc)[pol.reshape(-1) != 0].long()
    rows = torch.where(rows < 0, rows + n, rows)
    ones = torch.full((1, w), -1, dtype=torch.int32, device=packed1.device)
    table = torch.cat([packed1, ones])  # out of range reads as all ones
    rows = torch.where((rows >= 0) & (rows < n), rows, n)
    n_ops = 0
    for k0 in range(0, rows.shape[0], 4096):
        r = rows[k0:k0 + 4096]
        acc = torch.full((r.shape[0], w), -1, dtype=torch.int32, device=r.device)
        ands = torch.zeros((r.shape[0], w), dtype=torch.int64, device=r.device)
        for j in range(lc):
            ands += acc != 0
            acc &= table[r[:, j]]
        n_ops += int(ands.sum()) + int(popcount(acc).sum())
    return n_bytes, n_ops


def sharded_phase(dev, cfg, served, models, X, oracles, configs=None):
    """Phase 3f: multi-device on the card.  ``clause_table`` against its
    twin (models a and b's weighted tables at the served plan, a's over a
    random pads' row, tm-paper and tm-xl with planted inputs), ``build_tm_sharded`` on logical meshes
    of ``dev`` against the dense oracle, the ``sharded`` engine serving a
    -> b -> a through ``TMServer`` and ``Accelerator``, and the sharded
    train engine and a recal loop with ``RecalWorker(mesh=)`` against the
    packed engine.  ``configs``: the sharded configurations (default
    ``TM_CONFIGS``).  Returns the ``clause_table`` row of the kernels
    line and each case's (µs per ``clause_table`` call, how it was
    taken): the device time from the profiler, or the CUDA events time
    when three profiles kept no device event."""
    import ctypes

    import numpy as np
    import torch
    from repro_torch.accel import Accelerator, CapacityPlan, TMProgram, select_engine
    from repro_torch.core import (
        TMConfig, batch_class_sums, decode_to_plan, encode, include_actions,
        pack_literals, prng, state_from_actions,
    )
    from repro_torch.dist import build_tm_sharded, make_mesh, operands_from_plan
    from repro_torch.core.bits import from_u32
    from repro_torch.dist import TM_CONFIGS, fill_clause_tables
    from repro_torch.kernels import _build
    from repro_torch.kernels.clause_eval import kernel as cek
    from repro_torch.kernels.clause_eval.ops import tm_dense_class_sums
    from repro_torch.kernels.clause_eval.ref import class_sums_from_clause_words
    from repro_torch.kernels.clause_table import kernel as ctk
    from repro_torch.kernels.clause_table.ref import clause_table_plain
    from repro_torch.recal import (
        Compressor, RecalController, RecalWorker, make_train_engine,
    )
    from repro_torch.serve_tm import TMServer

    t_phase = time.perf_counter()
    configs = TM_CONFIGS if configs is None else configs
    n_rows = X.shape[0]
    ones = torch.full((1, n_rows // 32), -1, dtype=torch.int32, device=dev)
    packed1_x = torch.cat([pack_literals(torch.from_numpy(X).to(dev)), ones])

    # -- 1. clause_table against its twin ----------------------------------
    cases, max_err = {}, 0
    for k in "ab":
        idx, pol = fill_clause_tables(
            decode_to_plan(models[k][2]), served.class_capacity,
            served.clause_capacity, served.include_capacity,
            2 * served.feature_capacity)
        cases[f"served {k}"] = (torch.from_numpy(idx).to(dev),
                                torch.from_numpy(pol).to(dev), packed1_x,
                                oracles[k].T)
    # model a's table over literals whose last row, the one its pads name,
    # is random and not all ones; the oracle is the dense path over each
    # table row's own slots, the pads' row as one more literal
    idx, pol = cases["served a"][:2]
    M, C, lc = idx.shape
    if 2 * served.feature_capacity != packed1_x.shape[0] - 1:
        fail("phase 3f: the served tables' pads do not name the last literal row")
    rand_row = np.random.default_rng(9).integers(0, 2**32, (1, n_rows // 32),
                                                 dtype=np.uint64)
    p1_pads = torch.cat([packed1_x[:-1], from_u32(rand_row.astype(np.uint32), dev)])
    slots = torch.zeros((M * C, p1_pads.shape[0]), dtype=torch.int32, device=dev)
    slots.scatter_(1, idx.reshape(M * C, lc).long(), 1)
    cases["served a, random pad row"] = (
        idx, pol, p1_pads, class_sums_from_clause_words(
            cek.clause_eval(slots, p1_pads), pol.reshape(-1), M))
    del slots
    tms_inputs = {}
    for name, scfg in configs.items():
        acts, x = random_tm(scfg, seed=len(name), dev=dev)
        plan = plan_from_actions(acts)
        if scfg.n_classes * scfg.n_clauses <= 2048:  # the host walks at tm-paper
            tcfg = TMConfig(scfg.n_classes, scfg.n_clauses, scfg.n_features)
            ref = decode_to_plan(encode(tcfg, acts.cpu().numpy()))
            for f in ("lit_idx", "clause_id", "clause_class", "clause_pol"):
                if not np.array_equal(getattr(ref, f), getattr(plan, f)):
                    fail(f"phase 3f: plan_from_actions != decode_to_plan(encode) ({f})")
        idx, pol = fill_clause_tables(plan, scfg.n_classes, scfg.n_clauses,
                                      scfg.lc_cap, 2 * scfg.n_features)
        packed = pack_literals(x)
        p1 = torch.cat([packed, torch.full((1, packed.shape[1]), -1,
                                           dtype=torch.int32, device=dev)])
        # the dense oracle: clause_eval's dense path over the include
        # actions, and the boolean batch_class_sums on the first 64 rows
        dense = tm_dense_class_sums(acts.to(torch.int32), packed,
                                    n_classes=scfg.n_classes)
        tcfg = TMConfig(scfg.n_classes, scfg.n_clauses, scfg.n_features)
        state = state_from_actions(tcfg, acts)
        head = torch.cat([batch_class_sums(tcfg, state, x[i:i + 1])
                          for i in range(64)])
        if not torch.equal(head.T, dense[:, :64]):
            fail(f"phase 3f {name}: the two dense oracles differ")
        fired = float((dense != 0).any(dim=0).float().mean())
        print(f"sharded 3f {name}: {scfg.n_classes} x {scfg.n_clauses} x "
              f"{scfg.n_features}, {plan.n_includes} includes (max "
              f"{int(plan.includes_per_clause().max())} per clause, lc_cap "
              f"{scfg.lc_cap}), batch {scfg.batch}; rows with a nonzero sum "
              f"{fired:.4f}")
        cases[name] = (torch.from_numpy(idx).to(dev), torch.from_numpy(pol).to(dev),
                       p1, dense)
        tms_inputs[name] = (scfg, plan, x.to(torch.uint8).cpu().numpy(), dense)
        del acts, state
    rows, device_us = {}, {}
    attrs = [_build.attributes("clause_table", which) for which in (0, 1)]
    lib = _build.load("clause_table")
    resident = {}
    for vec in (1, 4):
        for split in range(1, 9):
            n = ctypes.c_int()
            _build.raise_on("clause_table", lib.clause_table_max_clusters(
                vec, split, ctypes.byref(n)), "max_clusters")
            resident[vec, split] = n.value * split
    print(f"sharded 3f clause_table resident blocks by split 1..8 (clusters x "
          f"split, cudaOccupancyMaxActiveClusters): vec1 "
          f"{[resident[1, s] for s in range(1, 9)]}, vec4 "
          f"{[resident[4, s] for s in range(1, 9)]}")
    for name, (idx, pol, p1, want) in cases.items():
        got = ctk.clause_table(idx, pol, p1)
        plain = clause_table_plain(idx, pol, p1)
        torch.cuda.synchronize()
        err = int((got - plain).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, plain):
            fail(f"phase 3f: clause_table != plain twin on {name}: max abs err {err}")
        want = want.cpu() if torch.is_tensor(want) else torch.from_numpy(want)
        if not torch.equal(got[: want.shape[0], : want.shape[1]].cpu(), want):
            fail(f"phase 3f: clause_table on {name} differs from the dense oracle")
        k_ms = median_ms(lambda: ctk.clause_table(idx, pol, p1))
        p_ms = median_ms(lambda: clause_table_plain(idx, pol, p1),
                         reps=3 if p1.numel() > 1 << 22 else PLAIN_REPS, warmup=1)
        for _ in range(3):  # the profiler now and then keeps no device event
            with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]
            ) as prof:
                for _ in range(10):
                    ctk.clause_table(idx, pol, p1)
                torch.cuda.synchronize()
            us, n_dev, _ = device_per_call(prof, 10)
            if n_dev:
                break
        # without device events the events time (wrapper included, never
        # under the device time) stands in
        device_us[name] = ((us, "on the device") if n_dev else
                           (k_ms * 1e3, "by CUDA events, no device event kept"))
        n_bytes, n_ops = clause_table_work(idx, pol, p1)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        rows[name] = (k_ms, p_ms, bound_ms, bound_by, None)
        M, C, _ = idx.shape
        vec, split = ctk.clause_table_shape(M, C, p1.shape[1],
                                            p1.data_ptr() % 16 == 0)
        attr = attrs[vec == 4]
        print(f"time 3f clause_table {name} {tuple(idx.shape)} x "
              f"{tuple(p1.shape)}: kernel {k_ms:.6f} ms, {us:.3f} us on the "
              f"device ({n_dev} operation), plain {p_ms:.6f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}; {n_bytes} B, {n_ops} ops); "
              f"vec{vec}: numRegs {attr['regs']}, sharedSizeBytes "
              f"{attr['shared_bytes']}, localSizeBytes (spills) "
              f"{attr['local_bytes']}, grid ({-(-p1.shape[1] // (32 * vec)) * split}, "
              f"{M}) in clusters of ({split}, 1, 1); equal to the twin and "
              f"the oracle")
    del cases

    # -- 2. the main path: build_tm_sharded and the engine, launches counted
    torch.cuda.synchronize()
    ctk.launches = 0
    meshes = [(1, 1), (1, 2), (2, 1), (2, 2)]
    for name, (scfg, plan, x_np, dense) in tms_inputs.items():
        for shape in meshes + ([(1, 4)] if name == "tm-paper" else []):
            mesh = make_mesh(shape, devices=dev)
            fn, _ = build_tm_sharded(scfg, mesh)
            ops = operands_from_plan(scfg, plan, x_np, mesh)
            before = ctk.launches
            t0 = time.perf_counter()
            sums = fn(*ops)
            torch.cuda.synchronize()
            call_s = time.perf_counter() - t0
            tiles = ctk.launches - before
            if tiles != len(fn.shards) * fn.n_model:
                fail(f"phase 3f {name} {shape}: {tiles} clause_table launches")
            if not (torch.equal(sums[:, : scfg.n_classes].T, dense)
                    and not sums[:, scfg.n_classes:].any()):
                fail(f"phase 3f: build_tm_sharded {name} on {shape} differs "
                     f"from the dense oracle")
            print(f"sharded 3f build_tm_sharded {name} mesh {shape} (Mp "
                  f"{fn.Mp}, batch axes {fn.bx}): {tiles} tiles, equal to the "
                  f"dense oracle; first call {call_s * 1e3:.3f} ms (host clock, "
                  f"packing the int8 literals included)")
            del ops
    del tms_inputs

    # the sharded engine serving a -> b -> a, 8192 rows per flush
    arts = {k: TMProgram(capacity=served, model=models[k][2]) for k in "ab"}
    nodes = {
        "TMServer (2, 2)": TMServer(served, engine="sharded",
                                    mesh=make_mesh((2, 2), devices=dev)),
        "Accelerator (1, 1)": Accelerator(served, mesh=make_mesh((1, 1), devices=dev)),
    }
    for label, node in nodes.items():
        mesh = node.executor.mesh if isinstance(node, TMServer) else node.engine.mesh
        if select_engine(served, mesh=mesh) != "sharded":
            fail(f"phase 3f: select_engine with a mesh picks "
                 f"{select_engine(served, mesh=mesh)}")
        for k in "aba":
            node.register("mnist", arts[k].to_bytes())
            h = node.submit("mnist", X)
            node.flush()
            if not (np.array_equal(np.asarray(h.class_sums), oracles[k])
                    and np.array_equal(h.result(), oracles[k].argmax(1))):
                fail(f"phase 3f: {label} serving model {k} differs from the oracle")
        if node.compile_cache_size() != 1:
            fail(f"phase 3f: {label} compile_cache_size() {node.compile_cache_size()}")
    torch.cuda.synchronize()
    main_launches = ctk.launches
    if main_launches == 0:
        fail("phase 3f never launched clause_table")
    print(f"sharded 3f serve: TMServer(engine='sharded', mesh (2, 2)) and "
          f"Accelerator(mesh (1, 1)) serve a -> b -> a, 8192 rows per flush, "
          f"equal to the oracle, compile_cache_size 1; clause_table launches "
          f"{main_launches}")
    for label, node in nodes.items():
        flush_s = []
        for _ in range(20):
            t0 = time.perf_counter()
            node.submit("mnist", X)
            node.flush()
            flush_s.append(time.perf_counter() - t0)
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            node.submit("mnist", X)
            node.flush()
            wall_us = (time.perf_counter() - t0) * 1e6
        ops = device_ops(prof)
        busy_us = sum(op[0] for op in ops)
        print(f"time 3f flush of 8192 rows, {label} (submit + flush, host "
              f"clock): {statistics.median(flush_s) * 1e3:.6f} ms; profile: wall "
              f"{wall_us:.1f} us, device busy {busy_us:.1f} us (idle share "
              f"{1 - busy_us / wall_us:.3f})")
        for us, key, count in ops[:5] + [op for op in ops[5:] if "clause_table" in op[1]]:
            print(f"profile 3f flush {label}: {us:.1f} us  x{count}  {key[:80]}")

    # -- 3. the sharded train engine and a recal loop ----------------------
    acts_a = models["a"][0]
    M, C, L = acts_a.shape
    tcfg = TMConfig(n_classes=M, n_clauses=C, n_features=L // 2)
    state_a = state_from_actions(tcfg, torch.from_numpy(acts_a).to(dev))
    tmesh = make_mesh((2, 2), devices=dev)
    rng = np.random.default_rng(8)
    steps = [(rng.integers(0, 2, (128, L // 2), dtype=np.uint8),
              rng.integers(0, M, 128).astype(np.int32)) for _ in range(3)]
    key = prng.key(5)
    engines = {"sharded": make_train_engine("sharded", tcfg, mesh=tmesh, batch=128),
               "packed": make_train_engine("packed", tcfg, device=dev)}
    finals = {}
    for name, eng in engines.items():
        internal = eng.prepare(state_a)
        for j, (x, y) in enumerate(steps):
            internal = eng.fit_step(internal, key, x, y, step=j)
        finals[name] = eng.canonical(internal)
    if not torch.equal(finals["sharded"], finals["packed"]):
        fail("phase 3f: the sharded train engine's state != the packed engine's")
    moved = int((finals["sharded"] != state_a).sum())
    print(f"sharded 3f train: 3 chained steps at B=128 on mesh (2, 2), equal to "
          f"the packed engine ({moved} TAs moved)")
    fit_ms = {name: median_ms(lambda: eng.fit_step(eng.prepare(state_a), key,
                                                   *steps[0], step=0),
                              reps=3 if name == "sharded" else REPS, warmup=1)
              for name, eng in engines.items()}
    for name, ms in fit_ms.items():
        print(f"time 3f fit_step B=128 {name} engine (prepare included): {ms:.6f} ms")

    X512, n_train, epochs = X[:512], 384, 2
    pred_b = oracles["b"][:512].argmax(1).astype(np.int32)
    include = torch.from_numpy(acts_a).to(dev)
    state_t = torch.where(include, tcfg.n_states + 8, tcfg.n_states - 7).to(torch.int32)
    rehearsal = RecalWorker(tcfg, state_t, key=prng.key(6), device=dev)
    rehearsal.fine_tune_epochs(X512[:n_train], pred_b[:n_train], epochs=epochs, batch=128)
    model_r = encode(tcfg, include_actions(tcfg, rehearsal.state).cpu().numpy())
    plan = CapacityPlan.for_models([models["a"][2], model_r], batch_words=256)
    published = {}
    for name in ("packed", "sharded"):
        acc = Accelerator(plan, mesh=make_mesh((1, 2), devices=dev))
        worker = (RecalWorker(tcfg, state_t, key=prng.key(6), mesh=tmesh)
                  if name == "sharded" else
                  RecalWorker(tcfg, state_t, key=prng.key(6), device=dev))
        if worker.train_engine != name:
            fail(f"phase 3f: the {name} loop's worker runs {worker.train_engine}")
        ctl = RecalController(
            acc, "mnist", worker, compressor=Compressor(plan=plan, engine=acc),
            buffer_batches=4, epochs_per_recal=epochs, train_batch_size=128,
            regression_margin=1.0,  # both loops publish, whatever the holdout
        )
        ctl.deploy()
        for i in range(0, 512, 128):
            ctl.observe(X512[i:i + 128], pred_b[i:i + 128])
        event = ctl.recalibrate(reason="smoke")
        torch.cuda.synchronize()
        if event.rolled_back or event.steps_taken != epochs * n_train // 128:
            fail(f"phase 3f: the {name} recalibration went wrong: {event}")
        published[name] = acc.installed_artifact("mnist").to_bytes()
        print(f"sharded 3f recal loop ({name} worker, sharded serving engine on "
              f"(1, 2)): {event.steps_taken} steps, holdout acc "
              f"{event.holdout_acc_before:.4f} -> {event.holdout_acc_after:.4f}; "
              f"train_s {event.train_s:.6f}, compress_s {event.compress_s:.6f}, "
              f"swap_s {event.swap_s:.6f}")
    if published["sharded"] != published["packed"]:
        fail("phase 3f: the sharded loop published other bytes than the packed loop")
    print(f"sharded 3f recal: both loops published the same {len(published['packed'])}"
          f" TMProgram bytes; phase {time.perf_counter() - t_phase:.3f} s")
    k_ms, p_ms, bound_ms, bound_by, lib = rows["served a"]
    return ("clause_table", "src/repro/dist/tm_sharded.py:151", main_launches,
            max_err, (k_ms, p_ms, bound_ms, bound_by, lib)), device_us


# ---------------------------------------------------------------------------
# phase 3g: the LM trunk (no kernel of its own: cuBLAS products, the
# reference's two attention paths in plain PyTorch)
# ---------------------------------------------------------------------------

SMOKE_ARCHS = ("stablelm-3b-smoke", "starcoder2-7b-smoke",
               "moonshot-v1-16b-a3b-smoke", "internvl2-26b-smoke")
LM_TOL = 1e-3  # card vs CPU in fp32, TF32 off (PyTorch's default)
ATTN_TOL, ATTN_GRAD_TOL = 1e-4, 5e-4  # streaming vs plain on the card, fp32


PACK_SHAPES = ((8192, 784), (32768, 784), (8192, 1122))


def pack_phase(dev, shapes=PACK_SHAPES):
    """The served packing kernel (``kernels.pack_literals``) against its
    eager twin at the served shapes (mnist-sensors' and mnist-bulk's
    batches at 784 features, and HAR's 1,122, whose rows take byte
    loads): ``torch.equal`` on bytes half zero and half in [1, 256), then
    each timed (CUDA events, median of REPS, wrapper included; the twin
    median of PLAIN_REPS) beside its bytes bound (F bytes read and F / 4
    written a row) and profiled for its device time per launch.  Returns
    the ``{"kernels"}`` timings at the first shape."""
    import numpy as np
    import torch

    from repro_torch.kernels.pack_literals import kernel as plk

    timings = {}
    for b, f in shapes:
        rng = np.random.default_rng(b + f)
        nonzero = rng.integers(1, 256, (b, f), dtype=np.uint8)
        x = torch.from_numpy(
            np.where(rng.random((b, f)) < 0.5, 0, nonzero).astype(np.uint8)
        ).to(dev)
        before = plk.launches
        got = plk.pack_literals(x)
        want = plk.pack_literals_plain(x)
        torch.cuda.synchronize()
        if plk.launches != before + 1:
            fail(f"pack_literals {b}x{f}: {plk.launches - before} launches, not 1")
        if not torch.equal(got, want):
            fail(f"pack_literals {b}x{f}: {int((got != want).sum())} words "
                 "differ from the plain twin")
        k_ms = median_ms(lambda: plk.pack_literals(x))
        p_ms = median_ms(lambda: plk.pack_literals_plain(x), reps=PLAIN_REPS)
        n_bytes = b * f + 4 * 2 * f * (b // 32)
        bound_ms, bound_by = bound(n_bytes, 0)
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            for _ in range(REPS):
                plk.pack_literals(x)
            torch.cuda.synchronize()
        kernel_us = [us / n for name, (us, n) in _device_events(prof).items()
                     if "pack_literals_kernel" in name]
        device_us = kernel_us[0] if len(kernel_us) == 1 else float("nan")
        print(f"time pack_literals {b}x{f}: kernel {k_ms:.6f} ms, device "
              f"{device_us:.3f} us/launch ({bound_ms * 1e3 / device_us:.1%} of its "
              f"roofline), plain {p_ms:.6f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}; {n_bytes} B)")
        timings[(b, f)] = (k_ms, p_ms, bound_ms, bound_by, None)
    return timings[shapes[0]]


def card_identity() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def events_ms(fn):
    """(fn's result, its time in ms by CUDA events, synchronised)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def launch_us(dev, n=2000):
    """Host microseconds per launch of a one-element in-place add (``n``
    launches, host clock to a synchronise): what a launch costs the host
    in this process, the floor under a launch-bound step."""
    import torch

    x = torch.zeros(1, device=dev)
    for _ in range(50):
        x.add_(1)
    sync = torch.cuda.synchronize if x.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    sync()
    return (time.perf_counter() - t0) / n * 1e6


def profile_device(tag, fn, card, top=5):
    """Run ``fn`` once under ``torch.profiler`` (host and device) and
    print its wall time, the device's busy time and idle share, and its
    ``top`` longest device operations.  Returns ``fn``'s result."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = device_ops(prof)
    busy = sum(o[0] for o in ops)
    print(f"profile {tag}: wall {wall_us:.1f} us, device busy {busy:.1f} us "
          f"(idle share {1 - busy / wall_us:.3f}) [{card}]")
    for us, key, count in ops[:top]:
        print(f"profile {tag}: {us:.1f} us  x{count}  {key[:90]} [{card}]")
    return out


def np_lm_params(cfg, seed, std=0.3):
    """fp32 numpy parameters of ``cfg``'s tree, normal at ``std`` (at the
    init scale 0.02 every smoke model predicts close to uniform)."""
    import numpy as np
    from repro_torch.models.api import abstract_params
    from repro_torch.tree import flatten, unflatten

    rng = np.random.default_rng(seed)
    return unflatten((p, (rng.normal(size=s.shape) * std).astype(np.float32))
                     for p, s in flatten(abstract_params(cfg)))


def lm_phase(dev, card, arch="stablelm-3b", serve=(4, 4000, 96), train=(4, 4096),
             attn_seq=4096):
    """Phase 3g: the LM trunk on ``dev``.  The four smoke archs against
    the CPU from the same fp32 parameters, one bf16 train step each, the
    loss falling over 60 steps of stablelm-3b-smoke; then
    ``arch`` at full width and depth in bf16: ``Server`` (batch,
    prompt_cap, gen_cap = ``serve``) generating ``gen_cap`` tokens, three
    ``make_train_step`` steps at (batch, seq) = ``train`` with the arch's
    microbatches, one of them profiled; the streaming attention held to
    the plain one at one layer's width and both timed beside
    ``scaled_dot_product_attention``; and the serving CLI.  ``card``
    (name, power limit) goes on every line with a number.  Returns
    ``arch``'s params (after the train steps) and the shapes and median
    ms of its prefill and train step, for phase 3j, and the train steps'
    (loss, grad norm) and peak memory, for phase 3k, and the served tokens,
    prefill and decode ms and peak memory, for phase 3l."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
    from repro_torch.dist.steps import make_train_step, opt_config_for
    from repro_torch.launch.serve import Server
    from repro_torch.models import api, dense
    from repro_torch.models import common as cm
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("3g: TF32 matmuls are on; the fp32 comparisons need them off")

    # -- smoke archs: the card against the CPU, then one bf16 train step --
    for name in SMOKE_ARCHS:
        cfg = get(name)
        tree = np_lm_params(cfg, 0)
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
        if cfg.family == "vlm":
            batch["patches"] = rng.normal(
                size=(2, cfg.n_patches, cfg.d_model)).astype(np.float32)
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        outs = {}
        for d in (cpu, dev):
            params = lm_params_from_numpy(cfg, tree, device=d)
            b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
            loss = dense.loss(cfg, params, b).detach()
            logits, cache = dense.prefill(cfg, params, b)
            logits2, cache = dense.decode(cfg, params, cache, {
                "token": torch.from_numpy(tok).to(d), "pos": 15})
            outs[d.type] = [t.float().cpu() for t in (loss, logits, cache["k"], logits2)]
        errs = [float((a - b).abs().max()) for a, b in zip(outs["cpu"], outs[dev.type])]
        print(f"lm 3g {name}: card vs cpu fp32 (TF32 off) max abs err loss {errs[0]:.3e}, "
              f"prefill logits {errs[1]:.3e}, cache {errs[2]:.3e}, decode logits "
              f"{errs[3]:.3e} (tolerance {LM_TOL}) [{card}]")
        if not all(np.isfinite(errs)) or max(errs) > LM_TOL:
            fail(f"3g: {name} on the card differs from the CPU: {errs}")
        params = dense.init_params(cfg, 0, device=dev)
        before = {p: t.clone() for p, t in params.state_dict().items()}
        opt = opt_config_for(cfg)
        step = make_train_step(cfg, opt, device=dev)
        params, _, m = step(params, adamw.init(opt, params), batch)
        changed = sum(not torch.equal(before[p], t) for p, t in params.state_dict().items())
        print(f"lm 3g {name}: bf16 train step loss {float(m['loss']):.6f}, grad_norm "
              f"{float(m['grad_norm']):.6f}, {changed}/{len(before)} leaves changed "
              f"[{card}]")
        if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])) or not changed:
            fail(f"3g: {name}'s bf16 train step: {m}, {changed} leaves changed")

    # -- training converges (the reference's tiny-training test) ----------
    cfg = get("stablelm-3b-smoke")
    params = dense.init_params(cfg, 0, device=dev)
    opt = adamw.AdamWConfig(lr=3e-3)
    state = adamw.init(opt, params)
    step = make_train_step(cfg, opt, device=dev)
    stream = TokenStream(TokenStreamConfig(cfg.vocab, 64, 16, seed=1))
    losses = []
    for _ in range(60):
        params, state, m = step(params, state, stream.next_batch())
        losses.append(float(m["loss"]))
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"lm 3g converge: stablelm-3b-smoke lr 3e-3, 60 steps of "
          f"TokenStream(512, 64, 16, seed=1): first 5 {first:.4f}, last 5 {last:.4f} "
          f"nats (drop {first - last:.4f}, needs > 0.9) [{card}]")
    if not first - last > 0.9:
        fail(f"3g: the loss fell by {first - last:.4f} nats, not > 0.9: {losses}")

    # -- arch at full width and depth: serve ------------------------------
    cfg = get(arch)
    n_params = api.count_params(cfg)
    B, prompt_cap, gen_cap = serve
    torch.cuda.reset_peak_memory_stats()
    params = dense.init_params(cfg, 0, device=dev)
    server = Server(cfg, batch=B, prompt_cap=prompt_cap, gen_cap=gen_cap, device=dev)
    server.load_weights(params)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, prompt_cap)).astype(
        np.int32)
    paths = {"streaming": 0, "plain": 0, "plain with kv_len": 0}
    flash, plain = cm._flash_attention, cm._plain_attention

    def count_flash(*a):
        paths["streaming"] += 1
        return flash(*a)

    def count_plain(*a, **k):
        paths["plain with kv_len" if k["kv_len"] is not None else "plain"] += 1
        return plain(*a, **k)

    cm._flash_attention, cm._plain_attention = count_flash, count_plain
    try:
        tokens, gen_ms = events_ms(lambda: server.generate(prompts, gen_cap))
    finally:
        cm._flash_attention, cm._plain_attention = flash, plain
    print(f"lm 3g serve {arch}: {n_params} params, Server(batch={B}, "
          f"prompt_cap={prompt_cap}, gen_cap={gen_cap}), cache_cap "
          f"{server.cache_cap}: generate {tokens.shape} in {gen_ms:.3f} ms; "
          f"attention calls {paths} [{card}]")
    want = {"streaming": cfg.n_layers, "plain": 0,
            "plain with kv_len": cfg.n_layers * (gen_cap - 1)}
    if server.cache_cap > cm.ATTN_CHUNK_THRESHOLD and paths != want:
        fail(f"3g: the serve took attention paths {paths}, not {want}")
    if tokens.shape != (B, gen_cap) or tokens.min() < 0 or tokens.max() >= cfg.padded_vocab:
        fail(f"3g: generated tokens out of range: {tokens.shape}, {tokens.min()}..{tokens.max()}")
    padded = np.zeros((B, server.cache_cap), np.int32)
    padded[:, :prompt_cap] = prompts
    batch = {"tokens": torch.from_numpy(padded).to(dev)}
    prefill_ms = []
    for _ in range(3):
        cache = None
        (logits, cache), ms = events_ms(lambda: server.prefill(params, batch))
        prefill_ms.append(ms)
    if not torch.isfinite(logits).all():
        fail("3g: prefill logits are not finite")
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    serve_launch_us = launch_us(dev)
    decode_ms = []
    for i in range(gen_cap - 1):
        (tok, cache), ms = events_ms(lambda: server.decode(
            params, cache, {"token": tok, "pos": prompt_cap + i}))
        decode_ms.append(ms)
        tok = tok[:, None]
    p_ms, d_ms = statistics.median(prefill_ms), statistics.median(decode_ms)
    tok, cache = profile_device("3g decode step", lambda: server.decode(
        params, cache, {"token": tok, "pos": prompt_cap + gen_cap - 2}), card)
    cache = None
    logits, cache = profile_device(
        "3g prefill", lambda: server.prefill(params, batch), card)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"lm 3g serve {arch}: prefill {p_ms:.3f} ms (median of 3: {prefill_ms}) for "
          f"{B} x {server.cache_cap} positions, {B * server.cache_cap / p_ms * 1e3:.1f} "
          f"tok/s; decode {d_ms:.3f} ms per step (median of {len(decode_ms)}), "
          f"{B / d_ms * 1e3:.1f} tok/s; peak memory {peak:.3f} GiB; a launch costs the "
          f"host {serve_launch_us:.2f} us here [{card}]")
    server_cap, serve_peak = server.cache_cap, peak
    del server, cache, logits, batch

    # -- arch at full width and depth: train ------------------------------
    Bt, St = train
    mb = cfg.train_microbatches
    torch.cuda.reset_peak_memory_stats()
    opt = opt_config_for(cfg)
    state = adamw.init(opt, params)
    step = make_train_step(cfg, opt, microbatches=mb, device=dev)
    stream = TokenStream(TokenStreamConfig(cfg.vocab, St, Bt, seed=0))
    step_ms, train_metrics = [], []
    for _ in range(3):
        batch = stream.next_batch()
        (params, state, m), ms = events_ms(lambda: step(params, state, batch))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        step_ms.append(ms)
        train_metrics.append((loss, gnorm))
        print(f"lm 3g train {arch}: step {int(state.step)} loss {loss:.6f} grad_norm "
              f"{gnorm:.6f} in {ms:.3f} ms [{card}]")
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"3g: full-width train step not finite: {loss}, {gnorm}")
    s_ms = statistics.median(step_ms)
    tok_s = Bt * St / s_ms * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"lm 3g train {arch}: B={Bt} S={St} microbatches={mb}, {s_ms:.3f} ms per "
          f"step (median of 3), {tok_s:.1f} tok/s; peak memory {peak:.3f} GiB [{card}]")
    share = model_flops(cfg, ShapeSpec("train", St, Bt, "train"), n_params) / (
        PEAK_FLOPS * s_ms / 1e3)
    print(f"lm 3g train {arch}: model-FLOPs share 6 x {n_params} x {tok_s:.1f} tok/s "
          f"/ {PEAK_FLOPS / 1e12:.1f}e12 = {share:.4f} ({PEAK_FLOPS / 1e12:.1f} TFLOP/s: "
          f"H100 SXM dense bf16, NVIDIA's datasheet) [{card}]")
    batch = stream.next_batch()
    params, state, m = profile_device(
        "3g train step", lambda: step(params, state, batch), card)
    del state, step, m

    # -- attention at one layer's full width ------------------------------
    H, hd = cfg.n_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, attn_seq, H, hd), generator=g, device=dev)
               for _ in range(3))
    out_f = cm._flash_attention(q, k, v, True, 0, 0)
    out_p = cm._plain_attention(q, k, v, causal=True, q_offset=0, window=0, kv_len=None)
    fwd_err = float((out_f - out_p).abs().max())
    grads = []
    for fn in (lambda *a: cm._flash_attention(*a, True, 0, 0),
               lambda *a: cm._plain_attention(*a, causal=True, q_offset=0, window=0,
                                              kv_len=None)):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(torch.sum(torch.sin(fn(*args))), args))
    grad_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(*grads))
    print(f"lm 3g attention B=1 S={attn_seq} H={H} hd={hd} fp32: streaming vs plain "
          f"forward max abs err {fwd_err:.3e} (tolerance {ATTN_TOL}), backward "
          f"{grad_err:.3e} of the largest gradient (tolerance {ATTN_GRAD_TOL}) "
          f"[{card}]")
    if not fwd_err <= ATTN_TOL or not grad_err <= ATTN_GRAD_TOL:
        fail(f"3g: streaming attention differs from plain: {fwd_err}, {grad_err}")
    del grads, out_f, out_p
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    with torch.no_grad():
        times = {
            "streaming": median_ms(lambda: cm._flash_attention(qb, kb, vb, True, 0, 0)),
            "plain": median_ms(lambda: cm._plain_attention(
                qb, kb, vb, causal=True, q_offset=0, window=0, kv_len=None)),
            "sdpa (library)": median_ms(lambda: F.scaled_dot_product_attention(
                qb.transpose(1, 2), kb.transpose(1, 2), vb.transpose(1, 2),
                is_causal=True)),
        }
    # causal attention: QK^T and PV over the lower triangle; q, k, v read
    # and the output written once, bf16
    n_ops = 2 * 2 * attn_seq * attn_seq * H * hd // 2
    bound_ms, bound_by = bound(4 * attn_seq * H * hd * 2, n_ops, PEAK_FLOPS)
    print(f"time 3g attention bf16 B=1 S={attn_seq} H={H} hd={hd} causal (median of "
          f"{REPS}): " + ", ".join(f"{k} {t:.6f} ms" for k, t in times.items())
          + f"; bound {bound_ms:.6f} ms ({bound_by}) [{card}]")

    # -- the serving CLI ----------------------------------------------------
    import os

    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "stablelm-3b-smoke", "--batch", "2", "--prompt-len", "16", "--gen", "4",
         *(["--device", "cpu"] if dev.type == "cpu" else [])],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    print(f"lm 3g cli: rc {cli.returncode}: {cli.stdout.strip().splitlines()[:1]}")
    if cli.returncode != 0 or "generated (2, 4)" not in cli.stdout:
        fail(f"3g: the serving CLI failed: {cli.stdout} {cli.stderr}")
    torch.cuda.empty_cache()
    print(f"lm 3g: phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"arch": arch, "params": params, "prefill": (B, server_cap),
            "prefill_ms": p_ms, "train": (Bt, St), "train_ms": s_ms,
            "train_metrics": train_metrics, "train_peak_gib": peak,
            "serve": serve, "tokens": tokens, "serve_decode_ms": d_ms,
            "serve_peak_gib": serve_peak, "serve_launch_us": serve_launch_us}


# ---------------------------------------------------------------------------
# phase 3j: the dry run (launch.dryrun, dryrun_tm) held against the card
# ---------------------------------------------------------------------------

def dryrun_phase(dev, card, lm, table_us, cli_cell=("stablelm-3b", "train_4k")):
    """Phase 3j: the dry run against the card.  ``lm`` is ``lm_phase``'s
    return (the full-width params of its arch, the shapes and median ms
    of its prefill and train step); ``table_us`` is phase 3f's (µs, how
    taken) per ``clause_table`` call by case.  For each of 3g's two steps,
    ``run_cell`` traces the cell on a (1, 1) mesh of spec arithmetic
    (nothing placed on the card), then one real step runs on the card
    under ``FlopCounterMode``.  It fails if the card's flop count is not
    the record's ``flops_per_device`` exactly (the count depends only on
    shapes: a difference is a different program), if the bytes of the
    params and optimizer state on the card are not the record's argument
    bytes less the inputs, if the dry run moved the card's allocated
    bytes, or if 3g's measured time is under the record's lower bound
    ``max(t_compute, t_memory_lower)`` (an impossible reading: the count
    is wrong).  ``t_memory_lower`` is ``report.enrich``'s fused term
    (arguments and outputs once, the peak of live temporaries once each
    way); the record's ``t_memory`` counts every aten op's inputs and
    outputs, an unfused upper bound on the traffic, so the time over
    ``max(t_compute, t_memory)`` is printed beside and not gated.  It
    also prints the model-FLOPs share and the peak memory beside
    argument + temp.  ``dryrun_tm`` of tm-paper and tm-xl on (1, 1): 3f's
    ``clause_table`` device µs at the same batch must be at or above the
    record's ``t_memory`` (the executor's operands read once and its sums
    written once); the ratio to the record's capacity bound
    ``max(t_compute, t_memory)`` (every slot ANDed, which ``clause_table``
    need not do) is printed beside.  Last, the CLI
    traces ``cli_cell`` on the production mesh in a process that sees no
    card, timed."""
    import os

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis.report import enrich
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.dist.steps import make_prefill_step, make_train_step, opt_config_for
    from repro_torch.dist.tm_sharded import dryrun_tm
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves

    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    t_phase = time.perf_counter()
    arch, params = lm["arch"], lm["params"]
    cfg = get(arch)
    one = make_mesh((1, 1), devices="meta")
    rng = np.random.default_rng(0)
    for kind in ("prefill", "train"):
        B, S = lm[kind]
        measured_s = lm[f"{kind}_ms"] / 1e3
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        rec = run_cell(arch, None, False, verbose=False, shape=ShapeSpec(kind, S, B, kind),
                       mesh=one, mesh_name="1x1", out_dir=None)
        dry_s = time.perf_counter() - t0
        if torch.cuda.memory_allocated() != before:
            fail(f"3j: the dry run of {arch} {kind} allocated on the card")
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if kind == "prefill":
            state = None
            with FlopCounterMode(display=False) as fc:
                out = make_prefill_step(cfg)(params, {"tokens": tokens})
            on_card = nbytes(params.parameters())
        else:
            opt = opt_config_for(cfg)
            state = adamw.init(opt, params)
            on_card = nbytes(params.parameters()) + nbytes(
                [state.step, *leaves(state.m), *leaves(state.v)])
            step = make_train_step(cfg, opt, microbatches=cfg.train_microbatches, device=dev)
            with FlopCounterMode(display=False) as fc:
                out = step(params, state, {"tokens": tokens})
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del out, state
        card_flops = fc.get_total_flops()
        ma = rec["memory_analysis"]
        args_less_inputs = ma["argument_size_in_bytes"] - tokens.numel() * tokens.element_size()
        enrich(rec)
        bound_s = max(rec["t_compute"], rec["t_memory_lower"])
        unfused_s = max(rec["t_compute"], rec["t_memory"])
        share = rec["model_flops_global"] / (PEAK_FLOPS * measured_s)
        print(f"dryrun 3j {arch} {kind} B={B} S={S} mesh 1x1: traced in {dry_s:.2f} s "
              f"(u=1, u=2: {rec['lower_s'] + rec['compile_s']:.2f} s); flops "
              f"{rec['flops_per_device']:.0f}, card's FlopCounterMode {card_flops}; "
              f"bytes accessed {rec['hbm_bytes_per_device']:.0f}; params + state on "
              f"the card {on_card} B, record's arguments less the inputs "
              f"{args_less_inputs:.0f} B [{card}]")
        print(f"dryrun 3j {arch} {kind}: lower bound max(t_compute "
              f"{rec['t_compute'] * 1e3:.3f}, t_memory_lower {rec['t_memory_lower'] * 1e3:.3f})"
              f" = {bound_s * 1e3:.3f} ms; unfused max(t_compute, t_memory "
              f"{rec['t_memory'] * 1e3:.3f}) = {unfused_s * 1e3:.3f} ms; 3g measured "
              f"{measured_s * 1e3:.3f} ms = {measured_s / bound_s:.3f} x the lower bound, "
              f"{measured_s / unfused_s:.3f} x the unfused; model-FLOPs share {rec['model_flops_global']:.6e} / ({PEAK_FLOPS / 1e12:.1f}e12 "
              f"x {measured_s:.4f} s) = {share:.4f}; peak memory "
              f"{peak / 2**30:.3f} GiB, record's argument + temp "
              f"{(ma['argument_size_in_bytes'] + ma['temp_size_in_bytes']) / 2**30:.3f} GiB "
              f"[{card}]")
        if float(card_flops) != rec["flops_per_device"]:
            fail(f"3j: {arch} {kind}: the card counts {card_flops} flops, the dry run "
                 f"{rec['flops_per_device']}")
        if on_card != args_less_inputs:
            fail(f"3j: {arch} {kind}: {on_card} B of params and state on the card, "
                 f"the record's arguments less the inputs {args_less_inputs}")
        if measured_s < bound_s:
            fail(f"3j: {arch} {kind}: 3g measured {measured_s} s, under the lower bound "
                 f"{bound_s} s")
    for name in ("tm-paper", "tm-xl"):
        rec = dryrun_tm(name, mesh=one, mesh_name="1x1")
        lower_us = rec["t_memory"] * 1e6
        capacity_us = max(rec["t_compute"], rec["t_memory"]) * 1e6
        us, source = table_us[name]
        print(f"dryrun 3j dryrun_tm {name} mesh 1x1: integer ops {rec['flops_per_device']:.0f}, "
              f"bytes {rec['hbm_bytes_per_device']:.0f}; lower bound t_memory {lower_us:.3f} us, "
              f"capacity bound {capacity_us:.3f} us ({rec['bottleneck']}); 3f's clause_table "
              f"{us:.3f} us {source} = {us / lower_us:.3f} x the lower bound, "
              f"{us / capacity_us:.3f} x the capacity bound [{card}]")
        if us < lower_us:
            fail(f"3j: clause_table {name} {us} us, under the dry run's lower bound "
                 f"{lower_us} us")
    arch_c, shape_c = cli_cell
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch_c,
         "--shape", shape_c],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""},
    )
    cli_s = time.perf_counter() - t0
    ok = [line for line in cli.stdout.splitlines() if line.startswith("[OK]")]
    print(f"dryrun 3j cli: {arch_c} {shape_c} pod16x16 on the host (no card visible): "
          f"rc {cli.returncode} in {cli_s:.2f} s: {ok[:1]}")
    if cli.returncode != 0 or not ok:
        fail(f"3j: the dry-run CLI failed: {cli.stdout[-2000:]} {cli.stderr[-2000:]}")
    torch.cuda.empty_cache()
    print(f"dryrun 3j: phase {time.perf_counter() - t_phase:.1f} s [{card}]")


# ---------------------------------------------------------------------------
# phase 3h: the recurrent and encoder-decoder families (no kernel of their
# own: the reference's scans as Python loops of plain PyTorch)
# ---------------------------------------------------------------------------

RECURRENT_SMOKE = ("xlstm-125m-smoke", "zamba2-2.7b-smoke", "whisper-medium-smoke")
BLOCKS = ("ssm_forward", "ssm_decode_step", "mlstm_forward", "mlstm_decode_step",
          "slstm_forward", "slstm_decode_step")  # as recurrent_lm names them


def bound_mixed(n_bytes: int, bf16_ops: int, fp32_ops: int):
    """(bound ms, what bounds it): bytes at 3.35 TB/s against the bf16
    products at 989.4 TFLOP/s plus the fp32 ones at 67 TFLOP/s."""
    t_bytes = n_bytes / HBM_BW
    t_ops = bf16_ops / PEAK_FLOPS + fp32_ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _device_events(prof):
    """{name: (device us, count)} of a CUDA-activity profile, summed from
    its raw events (see ``raw_profile``)."""
    import torch

    names = {}
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            us, n = names.get(ev.name(), (0.0, 0))
            names[ev.name()] = (us + ev.duration_ns() / 1e3, n + 1)
    return names


def raw_profile(tag, fn, card, top=5):
    """Run ``fn`` once under ``torch.profiler`` (device activity) and print
    its wall time, the device's busy time and idle share, its device
    operations (launches) and the ``top`` names by device time, summed
    straight from the profiler's events: ``key_averages()`` takes minutes
    over the million events of a recurrent prefill.  Returns (``fn``'s
    result, device operations)."""
    import torch

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    names = _device_events(prof)
    busy = sum(us for us, _ in names.values())
    n_ops = sum(n for _, n in names.values())
    print(f"profile {tag}: wall {wall_us:.1f} us, device busy {busy:.1f} us "
          f"(idle share {1 - busy / wall_us:.3f}), {n_ops} device operations "
          f"[{card}]")
    for name, (us, n) in sorted(names.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"profile {tag}: {us:.1f} us  x{n}  {name[:90]} [{card}]")
    return out, n_ops


def _leaves(cache):
    if isinstance(cache, dict):
        return [t for k in sorted(cache) for t in _leaves(cache[k])]
    if isinstance(cache, tuple):
        return [t for c in cache for t in _leaves(c)]
    return [cache]


def recurrence_work(kind, cfg, B, S):
    """(bytes, bf16 products' FLOPs, fp32 FLOPs) one call of a block needs
    on these shapes: the input read and the output written once (bf16),
    the block's parameters read once; each product's multiply-adds in
    the dtype the reference computes it in (elementwise work left out,
    so the bound stays a lower bound).  ``S`` = 1 for a decode step,
    whose state is read and written once more."""
    import math as _m

    from repro_torch.models import ssm, xlstm

    D = cfg.d_model
    act = 2 * B * S * D * 2  # input + output, bf16
    if kind == "ssm":
        d_inner, H, P, N = ssm.ssm_dims(cfg)
        specs = ssm.ssm_param_specs(cfg)
        E = 2 * d_inner + 2 * N + H
        bf16 = 2 * B * S * D * E + 2 * B * S * d_inner * D
        if S == 1:
            fp32 = 2 * B * H * N * P * 2
            state = B * (ssm.CONV_K - 1) * (d_inner + 2 * N) * 2 + B * H * N * P * 4
        else:
            Q = min(256, S)
            bf16 += 2 * B * S * Q * N
            fp32 = 2 * B * S * Q * H * P + 2 * (2 * B * S * H * N * P)
            state = 0
    else:
        _, H, hd = xlstm.xlstm_dims(cfg)
        if kind == "mlstm":
            specs = xlstm.mlstm_param_specs(cfg)
            bf16 = 5 * 2 * B * S * D * D
            fp32 = 2 * 2 * B * S * D * H
            if S == 1:
                fp32 += 2 * 2 * B * H * hd * hd
                state = B * H * (hd * hd + hd + 1) * 4
            else:
                Q = min(256, S)
                fp32 += 2 * (2 * B * S * Q * H * hd) + 2 * (2 * B * S * H * hd * hd)
                state = 0
        else:
            specs = xlstm.slstm_param_specs(cfg)
            bf16 = (2 * 2 * B * D * D + 2 * 2 * B * H * hd * hd) * S + 2 * B * S * D * D
            fp32 = (2 * 2 * B * D * D + 2 * 2 * B * H * hd * hd) * S
            state = B * D * (3 * 4 + 2) if S == 1 else 0
    params = sum(_m.prod(s.shape) * s.element_size() for s in specs.values())
    return act + params + 2 * state, bf16, fp32


def recurrent_phase(dev, card, serve=(4, 1000, 24),
                    whisper=("whisper-medium", 4, 448, 384), layer_seq=1024,
                    profile_seqs=(32, 64), archs=("zamba2-2.7b", "xlstm-125m")):
    """Phase 3h: the recurrent (XLSTM, Zamba2) and encoder-decoder
    (Whisper) families on ``dev``.  The three smoke archs against the CPU
    from the same fp32 parameters (loss, prefill logits and every cache
    leaf, three chained decode steps), one bf16 train step each; then at
    full width in bf16 from random weights (seed 0): zamba2-2.7b and
    xlstm-125m served by ``Server`` (batch, prompt_cap, gen_cap =
    ``serve``), whisper-medium by ``make_prefill_step`` on frames and
    (batch, decoder length, prompt) = ``whisper`` tokens then greedy
    ``make_decode_step`` steps, each with prefill and per-step decode ms,
    tokens/s, peak memory and profiles (the recurrent prefills profiled
    at ``profile_seqs`` positions: their launches grow by a decode step
    per position and layer); last one layer of each recurrence at the
    width of ``archs`` (Zamba2's SSD, xLSTM's mLSTM and sLSTM; B = 4,
    S = ``layer_seq``) and 30 chained decode steps, timed beside their
    bounds.  ``card`` goes on every line with a number."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.dist.steps import (
        make_decode_step,
        make_prefill_step,
        make_train_step,
        opt_config_for,
    )
    from repro_torch.launch.serve import Server
    from repro_torch.models import api, recurrent_lm, ssm, xlstm
    from repro_torch.models.common import init_from_specs
    from repro_torch.optim import adamw
    from repro_torch.tree import as_tree

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("3h: TF32 matmuls are on; the fp32 comparisons need them off")

    # -- smoke archs: the card against the CPU, then one bf16 train step --
    for name in RECURRENT_SMOKE:
        cfg = get(name)
        fam = api.family_for(cfg)
        tree = np_lm_params(cfg, 0)
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)}
        if cfg.family == "encdec":
            batch["frames"] = rng.normal(
                size=(2, cfg.encoder_len, cfg.d_model)).astype(np.float32)
        toks = rng.integers(0, cfg.vocab, (3, 2, 1)).astype(np.int32)
        # Whisper decodes into its cache's last slots, the recurrent
        # families past the prompt
        positions = [61, 62, 63] if cfg.family == "encdec" else [64, 65, 66]
        outs = {}
        for d in (cpu, dev):
            params = lm_params_from_numpy(cfg, tree, device=d)
            b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
            loss = fam.loss(cfg, params, b).detach()
            logits, cache = fam.prefill(cfg, params, b)
            res = [loss, logits, *_leaves(cache)]
            for tok, pos in zip(toks, positions):
                logits, cache = fam.decode(cfg, params, cache, {
                    "token": torch.from_numpy(tok).to(d), "pos": pos})
                res.append(logits)
            outs[d.type] = [t.float().cpu() for t in res]
        errs = [float((a - b).abs().max()) for a, b in zip(outs["cpu"], outs[dev.type])]
        print(f"lm 3h {name}: card vs cpu fp32 (TF32 off) max abs err loss {errs[0]:.3e}, "
              f"prefill logits {errs[1]:.3e}, {len(errs) - 5} cache leaves "
              f"{max(errs[2:-3]):.3e}, 3 chained decode logits {max(errs[-3:]):.3e} "
              f"(tolerance {LM_TOL}) [{card}]")
        if not all(np.isfinite(errs)) or max(errs) > LM_TOL:
            fail(f"3h: {name} on the card differs from the CPU: {errs}")
        params = fam.init_params(cfg, 0, device=dev)
        before = {p: t.clone() for p, t in params.state_dict().items()}
        opt = opt_config_for(cfg)
        step = make_train_step(cfg, opt, device=dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if "frames" in b:
            b["frames"] = b["frames"].to(torch.bfloat16)
        params, _, m = step(params, adamw.init(opt, params), b)
        changed = sum(not torch.equal(before[p], t) for p, t in params.state_dict().items())
        print(f"lm 3h {name}: bf16 train step loss {float(m['loss']):.6f}, grad_norm "
              f"{float(m['grad_norm']):.6f}, {changed}/{len(before)} leaves changed "
              f"[{card}]")
        if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])) or not changed:
            fail(f"3h: {name}'s bf16 train step: {m}, {changed} leaves changed")
    del params, step

    # -- zamba2-2.7b and xlstm-125m at full width: serve --------------------
    B, prompt_cap, gen_cap = serve
    for arch in archs:
        cfg = get(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = api.family_for(cfg).init_params(cfg, 0, device=dev)
        server = Server(cfg, batch=B, prompt_cap=prompt_cap, gen_cap=gen_cap, device=dev)
        server.load_weights(params)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, (B, prompt_cap)).astype(np.int32)
        times, last = {"prefill": [], "decode": []}, {}
        steps = {"prefill": server.prefill, "decode": server.decode}

        def timed(kind):
            def call(*args):
                out, ms = events_ms(lambda: steps[kind](*args))
                times[kind].append(ms)
                last["cache"] = out[1]
                return out
            return call

        server.prefill, server.decode = timed("prefill"), timed("decode")
        calls = {name: 0 for name in BLOCKS}
        plain = {name: getattr(recurrent_lm, name) for name in BLOCKS}

        def counted(name):
            def call(*args, **kwargs):
                calls[name] += 1
                return plain[name](*args, **kwargs)
            return call

        for name in BLOCKS:
            setattr(recurrent_lm, name, counted(name))
        try:
            tokens, gen_ms = events_ms(lambda: server.generate(prompts, gen_cap))
        finally:
            server.prefill, server.decode = steps["prefill"], steps["decode"]
            for name in BLOCKS:
                setattr(recurrent_lm, name, plain[name])
        # the reference's structure: a step scan over every position and
        # layer in prefill, one step per layer per decode
        per_layer = server.cache_cap + gen_cap - 1
        if cfg.family == "hybrid":
            n = cfg.n_layers
            want = {"ssm_forward": n, "ssm_decode_step": n * per_layer}
        else:
            n = cfg.n_layers // 2
            want = {"mlstm_decode_step": n * per_layer, "slstm_decode_step": n * per_layer}
        print(f"lm 3h serve {arch}: block calls in generate "
              f"{ {k: v for k, v in calls.items() if v} } [{card}]")
        if {k: v for k, v in calls.items() if v} != want:
            fail(f"3h: {arch}'s generate made block calls {calls}, not {want}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        if tokens.shape != (B, gen_cap) or tokens.min() < 0 or tokens.max() >= cfg.padded_vocab:
            fail(f"3h: {arch} generated tokens out of range: {tokens.shape}")
        p_ms, d_ms = times["prefill"][0], statistics.median(times["decode"])
        print(f"lm 3h serve {arch}: {api.count_params(cfg)} params, Server(batch={B}, "
              f"prompt_cap={prompt_cap}, gen_cap={gen_cap}), cache_cap {server.cache_cap}: "
              f"generate {tokens.shape} in {gen_ms:.3f} ms; prefill {p_ms:.3f} ms "
              f"({B * server.cache_cap / p_ms * 1e3:.1f} positions/s); decode "
              f"{d_ms:.3f} ms per step (median of {len(times['decode'])}), "
              f"{B / d_ms * 1e3:.1f} tok/s; peak memory {peak:.3f} GiB [{card}]")
        raw_profile(f"3h decode step {arch}", lambda: server.decode(
            params, last["cache"], {"token": torch.from_numpy(tokens[:, -1:]).to(dev),
                                    "pos": prompt_cap + gen_cap - 1}), card)
        launches = []
        for S in profile_seqs:
            batch = {"tokens": torch.from_numpy(prompts[:, :S].copy()).to(dev)}
            _, n = raw_profile(f"3h prefill {arch} B={B} S={S}",
                               lambda: server.prefill(params, batch), card)
            launches.append(n)
        (s0, s1), (n0, n1) = profile_seqs, launches
        per_pos = (n1 - n0) / (s1 - s0)
        print(f"lm 3h launches {arch}: prefill {n0} at S={s0}, {n1} at S={s1}: "
              f"{per_pos:.1f} per position, so ~{n1 + per_pos * (server.cache_cap - s1):.0f} "
              f"at S={server.cache_cap} [{card}]")
        del server, params, last, times
    # -- whisper-medium at full width: the step builders ------------------
    w_arch, Bw, Sd, plen = whisper
    cfg = get(w_arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = api.family_for(cfg).init_params(cfg, 0, device=dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.normal(size=(Bw, cfg.encoder_len, cfg.d_model)).astype(
        np.float32)).to(dev, torch.bfloat16)
    tokens = np.zeros((Bw, Sd), np.int32)
    tokens[:, :plen] = rng.integers(0, cfg.vocab, (Bw, plen))
    batch = {"frames": frames, "tokens": torch.from_numpy(tokens).to(dev)}
    (logits, cache), p_ms = events_ms(lambda: prefill(params, batch))
    if not torch.isfinite(logits).all():
        fail(f"3h: {w_arch} prefill logits are not finite")
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    d_times, out = [], []
    for pos in range(plen, Sd - 1):
        (tok, cache), ms = events_ms(lambda: decode(params, cache, {"token": tok, "pos": pos}))
        d_times.append(ms)
        tok = tok[:, None]
        out.append(tok)
    gen = torch.cat(out, 1).cpu()
    if gen.min() < 0 or gen.max() >= cfg.padded_vocab:
        fail(f"3h: {w_arch} generated tokens out of range")
    peak = torch.cuda.max_memory_allocated() / 2**30
    d_ms = statistics.median(d_times)
    print(f"lm 3h serve {w_arch}: {api.count_params(cfg)} params, frames "
          f"{tuple(frames.shape)}, prefill of {Bw} x {Sd} tokens ({plen} prompt, right-"
          f"padded) {p_ms:.3f} ms ({Bw * Sd / p_ms * 1e3:.1f} positions/s); {len(d_times)} "
          f"decode steps from pos {plen}: {d_ms:.3f} ms per step (median), "
          f"{Bw / d_ms * 1e3:.1f} tok/s; peak memory {peak:.3f} GiB [{card}]")
    raw_profile(f"3h decode step {w_arch}", lambda: decode(
        params, cache, {"token": tok, "pos": Sd - 1}), card)
    cache = None
    raw_profile(f"3h prefill {w_arch}", lambda: prefill(params, batch), card)
    del params, cache, batch, frames

    # -- one layer of each recurrence at its full width --------------------
    torch.cuda.empty_cache()
    Bl = 4
    zcfg, xcfg = (get(a) for a in archs)
    g = torch.Generator(device=dev).manual_seed(0)
    blocks = (
        ("ssm", zcfg, ssm.ssm_param_specs, ssm.ssm_forward, ssm.ssm_decode_step,
         "src/repro/models/ssm.py:67"),
        ("mlstm", xcfg, xlstm.mlstm_param_specs, xlstm.mlstm_forward,
         xlstm.mlstm_decode_step, "src/repro/models/xlstm.py:68"),
        ("slstm", xcfg, xlstm.slstm_param_specs, xlstm.slstm_forward,
         xlstm.slstm_decode_step, "src/repro/models/xlstm.py:204"),
    )
    for kind, cfg, specs, fwd, step, ref in blocks:
        p = as_tree(init_from_specs(cfg, specs(cfg), g, dev))
        x = torch.randn((Bl, layer_seq, cfg.d_model), generator=g, device=dev).to(
            torch.bfloat16)
        with torch.no_grad():
            y = fwd(p, x, cfg)
            if not torch.isfinite(y).all():
                fail(f"3h: {kind}_forward at full width is not finite")
            f_ms = median_ms(lambda: fwd(p, x, cfg), reps=10, warmup=1)
            if kind == "ssm":
                d_inner, H, P, N = ssm.ssm_dims(cfg)
                state0 = (torch.zeros((Bl, ssm.CONV_K - 1, d_inner + 2 * N),
                                      dtype=torch.bfloat16, device=dev),
                          torch.zeros((Bl, H, N, P), device=dev))
            elif kind == "mlstm":
                _, H, hd = xlstm.xlstm_dims(cfg)
                state0 = xlstm.mlstm_state0(Bl, H, hd, dev)
            else:
                state0 = xlstm.slstm_state0(Bl, cfg.d_model, torch.bfloat16, dev)
            xs = x[:, :30]

            def chain():
                st = state0
                for t in range(30):
                    _, st = step(p, xs[:, t:t + 1], st, cfg)
                return st

            c_ms = median_ms(chain, reps=10, warmup=1) / 30
        nb, bf, f32 = recurrence_work(kind, cfg, Bl, layer_seq)
        fb_ms, fb_by = bound_mixed(nb, bf, f32)
        nb, bf, f32 = recurrence_work(kind, cfg, Bl, 1)
        db_ms, db_by = bound_mixed(nb, bf, f32)
        print(f"time 3h {kind}_forward ({ref}) {cfg.name} width B={Bl} S={layer_seq} "
              f"bf16 (events, median of 10): {f_ms:.6f} ms; bound {fb_ms:.6f} ms "
              f"({fb_by}); plain PyTorch, no library call computes it [{card}]")
        print(f"time 3h {kind}_decode_step {cfg.name} width B={Bl} bf16, 30 chained "
              f"(events, median of 10): {c_ms:.6f} ms per step; bound {db_ms:.6f} ms "
              f"per step ({db_by}) [{card}]")
    torch.cuda.empty_cache()
    print(f"lm 3h: phase {time.perf_counter() - t_phase:.1f} s [{card}]")


# ---------------------------------------------------------------------------
# phase 3i: the LM on a mesh (no kernel of its own: the expert-parallel MoE,
# the sharding rules, launch.train with checkpoint resume and reshard)
# ---------------------------------------------------------------------------

MOE_TOL = 1e-5  # moe_ffn_ep vs moe_ffn, fp32, of the largest |y|


def moe_layer_work(cfg, logits_by_shard, C):
    """(bytes, kept picks, padded slots) one MoE layer needs on these
    inputs: the experts' weights (bf16) and the router (fp32) read once,
    the input read and the output written once (bf16); the picks that
    survive capacity (``_route``'s ``keep`` over every expert of each data
    shard, which is what this data needs) and the E x C slots the
    capacity pads to, each 3 products of 2 x D x F FLOPs."""
    from repro_torch.models import moe

    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    kept, T = 0, 0
    for logits in logits_by_shard:
        _, _, _, keep, _ = moe._route(logits, cfg.top_k, E, C, logits.dtype)
        kept += int(keep.sum())
        T += logits.shape[0]
    n_bytes = 3 * E * D * F_ * 2 + D * E * 4 + 2 * T * D * 2
    return n_bytes, kept, len(logits_by_shard) * E * C


def mesh_phase(dev, card, moe_arch="moonshot-v1-16b-a3b", moe_x=(4, 1024),
               layer_meshes=((1, 1), (1, 2), (1, 4), (2, 2)), serve=(4, 1000, 24),
               serve_meshes=(None, (1, 1), (1, 4)), train_arch="xlstm-125m",
               train=(4, 256, 4)):
    """Phase 3i: the LM on a mesh on ``dev``.  One MoE layer of
    ``moe_arch`` at full width: ``moe_ffn_ep`` on logical meshes of the
    card against ``moe_ffn`` (on each data shard's rows), fp32, within
    ``MOE_TOL`` of the largest |y|, then timed in bf16 beside ``moe_ffn``
    and the layer's bound; ``moe_arch`` served whole by ``Server`` with
    no mesh and on ``serve_meshes`` (finite logits, tokens in range, the
    prefill logits and tokens of each mesh against no mesh, prefill and
    decode times, peak memory, idle shares); ``train_arch`` trained by
    ``repro_torch.launch.train.main`` (batch, seq, steps = ``train``)
    with a checkpoint every 2 steps, resumed from step 2 after step 4 is
    deleted (the same losses and grad norms within 1e-5 relative), the
    step-4 state resharded onto a (2, 1) mesh (every leaf equal) and one
    more step on each mesh (the same loss within 1e-5 relative).
    ``card`` goes on every line with a number."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import TokenStream, TokenStreamConfig, shard_batch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.steps import opt_config_for
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.serve import Server
    from repro_torch.models import api, dense, moe
    from repro_torch.models.common import init_from_specs
    from repro_torch.optim import adamw
    from repro_torch.runtime_ft.elastic import reshard_state
    from repro_torch.tree import as_tree, flatten

    t_phase = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("3i: TF32 matmuls are on; the fp32 comparisons need them off")
    shd.set_activation_mesh(None)

    # -- (a) one MoE layer at full width ----------------------------------
    cfg = get(moe_arch)
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(0)
    p16 = init_from_specs(cfg, moe.moe_param_specs(cfg), g, dev)
    p16 = {k: v.detach() for k, v in as_tree(p16).items()}
    p32 = {k: v.float() for k, v in p16.items()}
    B, S = moe_x
    x32 = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
    x16 = x32.to(torch.bfloat16)

    def per_shard(p, x, n_data):
        rows = x.shape[0] // n_data
        return torch.cat([moe.moe_ffn(p, x[i * rows:(i + 1) * rows], cfg)
                          for i in range(n_data)])

    with torch.no_grad():
        plain16_ms = median_ms(lambda: moe.moe_ffn(p16, x16, cfg), reps=10, warmup=2)
        for shape in layer_meshes:
            mesh = shd.make_mesh(shape, devices=dev)
            n_data = len(shd.batch_shards(mesh, B))
            want = per_shard(p32, x32, n_data)
            got = moe.moe_ffn_ep(p32, x32, cfg, mesh)
            ymax = float(want.abs().max())
            err = float((got - want).abs().max())
            err16 = float((moe.moe_ffn_ep(p16, x16, cfg, mesh).float()
                           - per_shard(p16, x16, n_data).float()).abs().max())
            ep_ms = median_ms(lambda: moe.moe_ffn_ep(p16, x16, cfg, mesh), reps=10,
                              warmup=2)
            ref_ms = (plain16_ms if n_data == 1 else median_ms(
                lambda: per_shard(p16, x16, n_data), reps=10, warmup=2))
            C = moe.moe_capacity(cfg, B * S // n_data)
            rows = B // n_data
            logits = [torch.einsum("td,de->te", x16[i * rows:(i + 1) * rows].reshape(
                -1, cfg.d_model).float(), p16["router"]) for i in range(n_data)]
            n_bytes, kept, slots = moe_layer_work(cfg, logits, C)
            flops = 6 * cfg.d_model * cfg.d_ff
            bound_ms, bound_by = bound(n_bytes, kept * flops, PEAK_FLOPS)
            pad_ms, _ = bound(n_bytes, slots * flops, PEAK_FLOPS)
            print(f"lm 3i moe_ffn_ep {moe_arch} layer x[{B}, {S}, {cfg.d_model}] "
                  f"E={cfg.n_experts} k={cfg.top_k} F={cfg.d_ff} on mesh {shape} "
                  f"(capacity {C} per expert and shard): fp32 max abs err {err:.3e} "
                  f"of max |y| {ymax:.3e} (tolerance {MOE_TOL} x max |y|); bf16 "
                  f"{err16:.3e}; time bf16 (events, median of 10) {ep_ms:.6f} ms, "
                  f"moe_ffn{' per data shard' if n_data > 1 else ''} {ref_ms:.6f} ms; "
                  f"bound {bound_ms:.6f} ms ({bound_by}: {n_bytes} B, {kept} kept picks "
                  f"x {flops} FLOP), {pad_ms:.6f} ms over the {slots} padded slots "
                  f"[{card}]")
            if not np.isfinite(err) or err > MOE_TOL * ymax:
                fail(f"3i: moe_ffn_ep on {shape} differs from moe_ffn: {err} of {ymax}")
    del p16, p32, x16, x32, want, got, logits

    # -- (b) the MoE arch served whole at full width ----------------------
    Bs, prompt_cap, gen_cap = serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = dense.init_params(cfg, 0, device=dev)
    weights_gib = torch.cuda.memory_allocated() / 2**30
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (Bs, prompt_cap)).astype(
        np.int32)
    runs = {}
    for shape in serve_meshes:
        shd.set_activation_mesh(None)
        mesh = None if shape is None else shd.make_mesh(shape, devices=dev)
        torch.cuda.reset_peak_memory_stats()
        server = Server(cfg, mesh, batch=Bs, prompt_cap=prompt_cap, gen_cap=gen_cap,
                        device=dev)
        server.load_weights(params)
        calls = [0]
        real_ep = moe.moe_ffn_ep

        def counted(*a):
            calls[0] += 1
            return real_ep(*a)

        times = {"prefill": [], "decode": []}
        steps = {"prefill": server.prefill, "decode": server.decode}

        def timed(kind):
            def call(*args):
                out, ms = events_ms(lambda: steps[kind](*args))
                times[kind].append(ms)
                return out
            return call

        server.prefill, server.decode = timed("prefill"), timed("decode")
        moe.moe_ffn_ep = counted
        try:
            tokens, gen_ms = events_ms(lambda: server.generate(prompts, gen_cap))
        finally:
            moe.moe_ffn_ep = real_ep
            server.prefill, server.decode = steps["prefill"], steps["decode"]
        want_calls = 0 if mesh is None else cfg.n_layers * gen_cap
        if calls[0] != want_calls:
            fail(f"3i: the {shape} server took moe_ffn_ep {calls[0]} times, not "
                 f"{want_calls}")
        if (tokens.shape != (Bs, gen_cap) or tokens.min() < 0
                or tokens.max() >= cfg.vocab):
            fail(f"3i: {shape} generated tokens out of range: {tokens.shape}, "
                 f"{tokens.min()}..{tokens.max()}")
        padded = np.zeros((Bs, server.cache_cap), np.int32)
        padded[:, :prompt_cap] = prompts
        batch = {"tokens": torch.from_numpy(padded).to(dev)}
        logits, cache = server.prefill(params, batch)
        if not torch.isfinite(logits).all():
            fail(f"3i: the {shape} prefill logits are not finite")
        peak = torch.cuda.max_memory_allocated() / 2**30
        p_ms, d_ms = times["prefill"][0], statistics.median(times["decode"])
        print(f"lm 3i serve {moe_arch} mesh {shape}: {api.count_params(cfg)} params "
              f"({weights_gib:.3f} GiB of bf16 weights), Server(batch={Bs}, "
              f"prompt_cap={prompt_cap}, gen_cap={gen_cap}), cache_cap "
              f"{server.cache_cap}: generate {tokens.shape} in {gen_ms:.3f} ms; "
              f"moe_ffn_ep calls {calls[0]}; prefill {p_ms:.3f} ms "
              f"({Bs * server.cache_cap / p_ms * 1e3:.1f} positions/s); decode "
              f"{d_ms:.3f} ms per step (median of {len(times['decode'])}), "
              f"{Bs / d_ms * 1e3:.1f} tok/s; peak memory {peak:.3f} GiB [{card}]")
        tok = torch.from_numpy(tokens[:, -1:]).to(dev)
        raw_profile(f"3i decode step {shape}", lambda: server.decode(
            params, cache, {"token": tok, "pos": prompt_cap + gen_cap - 1}), card)
        del cache
        raw_profile(f"3i prefill {shape}", lambda: server.prefill(params, batch), card)
        runs[shape] = (logits.float(), tokens)
        del server, batch
    base_logits, base_tokens = runs[None]
    for shape in serve_meshes[1:]:
        lg, tk = runs[shape]
        print(f"lm 3i serve {moe_arch} mesh {shape} vs no mesh (bf16, depth "
              f"{cfg.n_layers}, not gated): prefill logits max abs err "
              f"{float((lg - base_logits).abs().max()):.4e} of max |logits| "
              f"{float(base_logits.abs().max()):.4e}; generated tokens agree "
              f"{float(np.mean(tk == base_tokens)):.4f} [{card}]")
    shd.set_activation_mesh(None)
    del params, runs, base_logits
    torch.cuda.empty_cache()

    # -- (c) train_arch through launch.train.main, resume, reshard ---------
    cfg = get(train_arch)
    Bt, St, n_steps = train
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_3i_"))
    args = ["--arch", train_arch, "--mesh", "1x1", "--batch", str(Bt), "--seq", str(St),
            "--steps", str(n_steps), "--ckpt", str(tmp), "--save-every", "2",
            "--log-every", "1", *(["--device", "cpu"] if dev.type == "cpu" else [])]

    def run_main():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rec = launch_train.main(args)
        lines = out.getvalue().strip().splitlines()
        for line in lines:
            print(f"lm 3i train cli: {line} [{card}]")
        return rec, lines

    try:
        torch.cuda.reset_peak_memory_stats()
        first, lines = run_main()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if lines[-1] != "done" or sorted(first["metrics"]) != list(range(1, n_steps + 1)):
            fail(f"3i: launch.train.main did not run {n_steps} steps: {lines}")
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / f"step_{n_steps}").iterdir())
        shutil.rmtree(tmp / f"step_{n_steps}")
        second, lines = run_main()
        if lines[0] != "[restore] step 2" or lines[-1] != "done":
            fail(f"3i: the rerun did not resume from step 2: {lines}")
        worst = 0.0
        for s_ in range(3, n_steps + 1):
            for a, b in zip(second["metrics"][s_], first["metrics"][s_]):
                worst = max(worst, abs(a - b) / abs(b))
        if not worst <= 1e-5:
            fail(f"3i: the resumed steps differ: {second['metrics']} vs {first['metrics']}")
        step_s = statistics.median(first["step_s"][s_] for s_ in range(2, n_steps + 1))
        tok_s = Bt * St / step_s
        n_params = api.count_params(cfg)
        share = model_flops(cfg, ShapeSpec("train", St, Bt, "train"), n_params) / (
            PEAK_FLOPS * step_s)
        print(f"lm 3i train {train_arch}: B={Bt} S={St} mesh 1x1, {n_params} params: "
              f"{step_s:.4f} s per step (host clock to the loss read, median of steps "
              f"2..{n_steps}), {tok_s:.1f} tok/s, model-FLOPs share 6 x {n_params} x "
              f"{tok_s:.1f} / {PEAK_FLOPS / 1e12:.1f}e12 = {share:.6f}; "
              f"peak memory {peak:.3f} GiB; checkpoint step_{n_steps} {ckpt_bytes} B, "
              f"save {first['save_s']} s, restore {second['restore_s']:.4f} s; resumed "
              f"steps 3..{n_steps} max rel diff of loss and grad norm {worst:.3e} "
              f"(tolerance 1e-5) [{card}]")

        like = {"params": api.family_for(cfg).init_params(cfg, 1, device=dev),
                "opt": adamw.init(opt_config_for(cfg), second["params"]), "data": 0}
        mesh21 = shd.make_mesh((2, 1), devices=dev)
        state, rs_ms = events_ms(lambda: reshard_state(
            cfg, CheckpointManager(tmp), n_steps, like, mesh21))
        saved = {"params": as_tree(second["params"]), "m": second["opt"].m,
                 "v": second["opt"].v}
        got = {"params": as_tree(state["params"]), "m": state["opt"].m,
               "v": state["opt"].v}
        diff = [f"{k}/{p}" for k in saved
                for (p, a), (_, b) in zip(flatten(saved[k]), flatten(got[k]))
                if not torch.equal(a, b)]
        if diff or int(state["data"]) != n_steps or int(state["opt"].step) != n_steps:
            fail(f"3i: the resharded state differs from the saved one: {diff[:4]}")
        stream = TokenStream(TokenStreamConfig(cfg.vocab, St, Bt))
        stream.restore(n_steps)
        batch = stream.next_batch()
        cont = {}
        for name, m_, st in (("1x1", shd.make_mesh((1, 1), devices=dev), second),
                             ("2x1", mesh21, {"params": state["params"],
                                              "opt": state["opt"]})):
            step, _, _, in_sh, _, _ = launch_train.build(cfg, m_, seq=St, batch=Bt)
            b = shard_batch(batch, m_, in_sh)
            if name == "1x1":
                _, _, met = step(st["params"], st["opt"], b)
            else:  # the resharded step, profiled
                (_, _, met), _ = raw_profile(f"3i train step {train_arch} B={Bt} S={St}",
                                             lambda: step(st["params"], st["opt"], b),
                                             card)
            cont[name] = (float(met["loss"]), float(met["grad_norm"]))
        rel = abs(cont["2x1"][0] - cont["1x1"][0]) / abs(cont["1x1"][0])
        print(f"lm 3i reshard {train_arch}: step_{n_steps} onto mesh (2, 1) in "
              f"{rs_ms:.3f} ms, {len(flatten(saved['params'])) * 3} leaves equal; one "
              f"more step: loss/grad_norm (1, 1) {cont['1x1']}, (2, 1) {cont['2x1']}, "
              f"rel diff {rel:.3e} (tolerance 1e-5) [{card}]")
        if not rel <= 1e-5:
            fail(f"3i: the resharded step differs: {cont}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shd.set_activation_mesh(None)
    torch.cuda.empty_cache()
    print(f"lm 3i: phase {time.perf_counter() - t_phase:.1f} s [{card}]")


# ---------------------------------------------------------------------------
# phase 3k: the LM train path on a rank mesh (no kernel of its own: NCCL's
# collectives in the role of the reference's GSPMD collectives)
# ---------------------------------------------------------------------------

def _rank_worker(rank, world, store, argv, out_dir, device=None, serve=None):
    """One rank of phase 3k: ``launch.train.main(argv)`` on this rank's
    card under NCCL (``device=None``; ``"cpu"`` rehearses it under gloo),
    its last step profiled; then, given ``serve`` (``_rank_serve``'s
    arguments), phase 3l in the same process group.  Rank 0 writes the
    record."""
    import torch
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import init_distributed

    t0 = time.perf_counter()
    info = init_distributed(device, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout_s=600)
    t_init = time.perf_counter() - t0
    card = device is None
    fresh_launch_us = launch_us(info["device"])
    sync = torch.cuda.synchronize if card else (lambda: None)
    if card:
        torch.cuda.reset_peak_memory_stats()
    last = int(argv[argv.index("--steps") + 1])
    # device activity only, summed from the raw events (see raw_profile)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) \
        if card else None
    span = {"wall_us": 0.0}

    def on_step(step, record):  # profile the last step: from the one before
        if prof is None:
            return
        if step == last - 1:
            sync()
            prof.__enter__()
            span["t0"] = time.perf_counter()
        elif step == last:
            sync()
            span["wall_us"] = (time.perf_counter() - span["t0"]) * 1e6
            prof.__exit__(None, None, None)

    t0 = time.perf_counter()
    rec = launch_train.main(argv + (["--device", device] if device else []),
                            on_step=on_step)
    t_main = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 if card else 0.0
    names = _device_events(prof) if prof is not None else {}
    top = sorted(((us, key[:80], n) for key, (us, n) in names.items()), reverse=True)
    out = {"metrics": rec["metrics"], "step_s": rec["step_s"],
           "collectives": rec["collectives"], "peak_gib": peak,
           "busy_us": sum(us for us, _ in names.values()),
           "launches": sum(n for _, n in names.values()),
           "wall_us": span["wall_us"], "top": top[:5],
           "device": str(info["device"]), "backend": info["backend"],
           "init_s": t_init, "main_s": t_main}
    del rec, prof  # the trained state: 3l starts from its own weights
    if serve is not None:
        if card:
            torch.cuda.empty_cache()
        out["serve"] = _rank_serve(*serve, device=device)
        out["serve"]["fresh_launch_us"] = fresh_launch_us
    if rank == 0:
        Path(out_dir, "rank0.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()


def _rank_serve(arch, serve, n_tokens, device=None):
    """Phase 3l on this rank: ``arch`` at full width from
    ``init_params(cfg, 0)``, placed by ``param_shardings`` on a (1, world)
    rank mesh and served by ``Server(batch, prompt_cap, gen_cap = serve)``:
    one ``generate`` of ``n_tokens`` from 3g's prompts, the server's own
    prefill and decode steps each timed (host clock to a synchronise) and
    its last decode step profiled with its collectives logged.  On a
    (1, 1) mesh the rank decode step is then timed in four rounds of
    one-device / rank / rank / one-device steps (``make_decode_step(cfg)``
    on the same blocks), so this process's cost of each shows apart from
    the rank path's.  -> the rank's record."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.registry import get
    from repro_torch.dist import collectives
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.steps import make_decode_step
    from repro_torch.launch.dryrun import _memory_of
    from repro_torch.launch.serve import Server
    from repro_torch.models import api
    from repro_torch.tree import as_tree

    t_phase = time.perf_counter()
    card = device is None
    sync = torch.cuda.synchronize if card else (lambda: None)
    if card:
        torch.cuda.reset_peak_memory_stats()
    cfg = get(arch)
    fam = api.family_for(cfg)
    B, prompt_cap, gen_cap = serve
    mesh = shd.make_mesh((1, torch.distributed.get_world_size()), devices=device,
                         distributed=True)
    params = shd.place_tree(fam.init_params(cfg, 0, device=mesh.device),
                            shd.param_shardings(cfg, mesh, fam.param_specs(cfg)))
    server = Server(cfg, mesh, batch=B, prompt_cap=prompt_cap, gen_cap=gen_cap)
    server.load_weights(params)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, prompt_cap)).astype(
        np.int32)
    ms, rec = {"prefill": [], "decode": []}, {}

    def timed(name, step):
        def run(*args):
            last = name == "decode" and len(ms["decode"]) == n_tokens - 2
            prof = None
            if last:  # generate's last decode step: profiled, its collectives logged
                collectives.reset_counts()
                if card:
                    prof = torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA])
                    prof.__enter__()
            sync()
            t0 = time.perf_counter()
            out = step(*args)
            sync()
            t = (time.perf_counter() - t0) * 1e3
            if prof is not None:
                prof.__exit__(None, None, None)
            if not last:
                ms[name].append(t)
            elif name == "decode":
                rec.update(step_wall_us=t * 1e3, step_collectives=collectives.counts(),
                           names=_device_events(prof) if prof is not None else {},
                           tok=out[0], cache=out[1])
            if name == "prefill":
                blocks = []
                shd.map_leaves(lambda t: blocks.append(shd.local(t)), out[1])
                rec["cache_bytes"] = sum(t.numel() * t.element_size() for t in blocks)
            return out
        return run

    rank_decode = server.decode
    server.prefill = timed("prefill", server.prefill)
    server.decode = timed("decode", rank_decode)
    tokens = server.generate(prompts, n_tokens)
    names = rec.pop("names")
    top = sorted(((us, key[:80], n) for key, (us, n) in names.items()), reverse=True)
    out = {"mesh": (1, mesh.shape["model"]), "tokens": tokens.tolist(),
           "prefill_ms": ms["prefill"][0], "decode_ms": ms["decode"],
           "step_collectives": rec["step_collectives"],
           "step_wall_us": rec["step_wall_us"],
           "step_busy_us": sum(us for us, _ in names.values()),
           "step_launches": sum(n for _, n in names.values()), "step_top": top[:5],
           "cache_bytes": rec["cache_bytes"],
           "memory_of_bytes": _memory_of(cfg, ShapeSpec("decode", server.cache_cap, B,
                                                        "decode"), mesh)[
               "alias_size_in_bytes"]}
    out["launch_us"] = launch_us(mesh.device)
    if torch.distributed.get_world_size() == 1:
        one = make_decode_step(cfg)
        one_params = shd.map_leaves(shd.local, as_tree(params))
        one_cache = shd.map_leaves(shd.local, rec["cache"])
        tok = shd.local(rec["tok"])[:, None]
        rows = shd.NamedSharding(mesh, shd.P(shd.batch_axes(mesh, B), None))
        rank_tok = shd.from_block(tok, rows, (B, 1))
        sides = {"one-device": lambda pos: one(one_params, one_cache,
                                                {"token": tok, "pos": pos}),
                 "rank": lambda pos: rank_decode(params, rec["cache"],
                                                 {"token": rank_tok, "pos": pos})}
        out["turns"] = {k: [] for k in sides}
        for r in range(4):
            for side in ("one-device", "rank", "rank", "one-device"):
                sync()
                t0 = time.perf_counter()
                sides[side](prompt_cap + n_tokens - 1 + r)
                sync()
                out["turns"][side].append((time.perf_counter() - t0) * 1e3)
        del one_params, one_cache
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if card else 0.0
    del server, params, rec
    shd.set_activation_mesh(None)
    if card:
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def rank_phase(dev, card, one_device, steps=3, timeout_s=600, serve_tokens=16):
    """Phase 3k: ``launch.train.main`` on a rank mesh of one process per
    card under NCCL (``torch.cuda.device_count()`` ranks, a (N, 1) mesh;
    also (2, 2) where there are four cards) at ``one_device``'s arch and
    (batch, seq) from random weights (seed 0): the same params and
    batches as phase 3g's one-device steps, so its losses and gradient
    norms must equal 3g's within ``LM_TOL``.  Prints step ms, peak GiB and
    the idle share of the last (profiled) step beside 3g's.

    Phase 3l runs in the first mesh's ranks once ``launch.train.main``
    returns (one process group): ``one_device``'s arch served on a (1, N)
    rank mesh (``_rank_serve``) from 3g's weights (seed 0) and prompts;
    its ``serve_tokens`` tokens must equal the first of 3g's ``generate``
    exactly, and each rank's cache bytes ``_memory_of``'s decode alias
    bytes.  Prints prefill ms, decode ms per step, peak memory, the idle
    share of one decode step, its collective bytes and the cache bytes
    beside 3g's."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    arch, (B, S) = one_device["arch"], one_device["train"]
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    meshes = [(n, 1)] + ([(2, 2)] if n >= 4 else [])
    if n < 4:
        print(f"lm 3k: no multi-card mesh was available ({n} card(s) here): the rank "
              f"mesh is (1, 1), one NCCL rank; no multi-card time is measured [{card}]")
    torch.cuda.empty_cache()
    want = one_device["train_metrics"][:steps]
    serve = (arch, one_device["serve"], serve_tokens)
    for shape in meshes:
        world = shape[0] * shape[1]
        argv = ["--arch", arch, "--mesh", f"{shape[0]}x{shape[1]}", "--batch", str(B),
                "--seq", str(S), "--steps", str(steps), "--log-every", "1"]
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_3k_"))
        try:
            ctx = mp.spawn(_rank_worker, nprocs=world, join=False, args=(
                world, str(tmp / "store"), argv, str(tmp),
                "cpu" if dev.type == "cpu" else None, serve if shape == meshes[0] else None))
            deadline = time.perf_counter() + timeout_s
            while not ctx.join(timeout=5):
                if time.perf_counter() > deadline:
                    for p in ctx.processes:
                        p.kill()
                    fail(f"3k: the ranks of mesh {shape} did not finish in {timeout_s} s")
            rec = json.loads((tmp / "rank0.json").read_text())
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        got = [tuple(rec["metrics"][str(s_)]) for s_ in range(1, steps + 1)]
        errs = [max(abs(a - b) for a, b in zip(g, w)) for g, w in zip(got, want)]
        step_ms = {int(k): v * 1e3 for k, v in rec["step_s"].items()}
        idle = 1 - rec["busy_us"] / rec["wall_us"] if rec["wall_us"] else float("nan")
        moved = rec["collectives"][str(steps)]
        print(f"lm 3k train {arch} mesh {shape} ({world} {rec['backend']} rank(s), one per "
              f"device; rank 0 on {rec['device']}): "
              f"B={B} S={S}, (loss, grad_norm) per step {got} against 3g's one-device "
              f"{want}: max abs err {max(errs):.3e} (tolerance {LM_TOL}) [{card}]")
        print(f"lm 3k train {arch} mesh {shape}: step ms (host clock to the loss read, "
              f"slowest rank) {[round(step_ms[s_], 3) for s_ in sorted(step_ms)]} against "
              f"3g's one-device {one_device['train_ms']:.3f} ms (median, CUDA events); "
              f"peak memory {rec['peak_gib']:.3f} GiB (3g: "
              f"{one_device['train_peak_gib']:.3f}); last step profiled: wall "
              f"{rec['wall_us']:.1f} us, device busy {rec['busy_us']:.1f} us in "
              f"{rec['launches']} device operations (idle share {idle:.3f}); collectives "
              f"of the last step on rank 0 (bytes) {moved}; process group up in "
              f"{rec['init_s']:.1f} s, main {rec['main_s']:.1f} s [{card}]")
        for us, key, count in rec["top"]:
            print(f"profile 3k train step {shape}: {us:.1f} us  x{count}  {key} [{card}]")
        if not all(np.isfinite(v) for m in got for v in m) or not max(errs) <= LM_TOL:
            fail(f"3k: the rank mesh {shape} differs from 3g's one-device steps: "
                 f"{got} vs {want}")
        if "serve" in rec:
            serve_report(rec["serve"], one_device, rec["backend"], card)
    print(f"lm 3k: phase {time.perf_counter() - t_phase:.1f} s [{card}]")


def serve_report(rec, one_device, backend, card):
    """Phase 3l's lines and checks from rank 0's ``_rank_serve`` record."""
    import numpy as np

    arch, (B, prompt_cap, gen_cap) = one_device["arch"], one_device["serve"]
    shape = tuple(rec["mesh"])
    if shape[1] < 2:
        print(f"lm 3l: no multi-card mesh was available ({shape[1]} card(s) here): the "
              f"rank mesh is {shape}, one {backend} rank; its heads are not split and "
              f"no multi-card time is measured [{card}]")
    got = np.asarray(rec["tokens"], np.int32)
    want = np.asarray(one_device["tokens"])[:, :got.shape[1]]
    same = got.shape == want.shape and np.array_equal(got, want)
    print(f"lm 3l serve {arch} mesh {shape} ({backend}): Server(batch={B}, prompt_cap="
          f"{prompt_cap}, gen_cap={gen_cap}) on the rank mesh, {got.shape[1]} tokens "
          f"{'equal' if same else 'DIFFER from'} 3g's first {got.shape[1]} (exact) [{card}]")
    if not same:
        fail(f"3l: the rank-mesh tokens differ from 3g's: {got.tolist()} vs "
             f"{want.tolist()}")
    d_ms = statistics.median(rec["decode_ms"])
    idle = 1 - rec["step_busy_us"] / rec["step_wall_us"] if rec["step_busy_us"] else \
        float("nan")
    print(f"lm 3l serve {arch} mesh {shape}: generate's own steps, host clock to a "
          f"synchronise: prefill {rec['prefill_ms']:.3f} ms (3g's "
          f"{one_device['prefill_ms']:.3f}, median of 3, events); decode {d_ms:.3f} ms "
          f"per step (median of {len(rec['decode_ms'])} unprofiled: {rec['decode_ms']}; "
          f"3g's {one_device['serve_decode_ms']:.3f}); peak memory {rec['peak_gib']:.3f} "
          f"GiB (3g's serve {one_device['serve_peak_gib']:.3f}) [{card}]")
    print(f"lm 3l decode step {arch} mesh {shape} profiled: wall {rec['step_wall_us']:.1f} "
          f"us, device busy {rec['step_busy_us']:.1f} us in {rec['step_launches']} device "
          f"operations (idle share {idle:.3f}); collective bytes per kind "
          f"{rec['step_collectives']} [{card}]")
    for us, key, count in rec["step_top"]:
        print(f"profile 3l decode step: {us:.1f} us  x{count}  {key} [{card}]")
    if "turns" in rec:
        med = {k: statistics.median(v) for k, v in rec["turns"].items()}
        print(f"lm 3l decode step in turns in this rank's process (one-device / rank / "
              f"rank / one-device, host clock to a synchronise): one-device "
              f"{med['one-device']:.3f} ms, rank {med['rank']:.3f} ms (medians of "
              f"{len(rec['turns']['rank'])}; 3g's one-device step in the main process "
              f"{one_device['serve_decode_ms']:.3f}); {rec['turns']} [{card}]")
    print(f"lm 3l a launch costs the host {rec['launch_us']:.2f} us in this rank's "
          f"process after 3k's training, {rec['fresh_launch_us']:.2f} us in it before, "
          f"{one_device['serve_launch_us']:.2f} us in the main process at 3g's decode "
          f"[{card}]")
    agree = rec["cache_bytes"] == rec["memory_of_bytes"]
    print(f"lm 3l cache {arch} mesh {shape}: the rank's cache blocks hold "
          f"{rec['cache_bytes']:,} B; _memory_of(decode, B={B}, cache {prompt_cap + gen_cap}"
          f") alias bytes per device {rec['memory_of_bytes']:,.0f} B: "
          f"{'agree' if agree else 'DISAGREE'} [{card}]")
    if not agree:
        fail(f"3l: cache bytes {rec['cache_bytes']} against _memory_of's "
             f"{rec['memory_of_bytes']}")
    print(f"lm 3l: phase {rec['phase_s']:.1f} s (in 3k's ranks) [{card}]")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this run needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")

    from repro_torch.accel import Accelerator, CapacityPlan
    from repro_torch.core import (
        TMConfig,
        batch_class_sums_weighted,
        decode_to_plan,
        encode,
        from_u32,
        pack_literals,
        popcount,
        state_from_actions,
    )
    from repro_torch.core import include_actions, literals
    from repro_torch.kernels import _build
    from repro_torch.kernels.clause_eval import kernel as cek
    from repro_torch.kernels.clause_eval.ops import tm_dense_class_sums
    from repro_torch.kernels.clause_matmul import kernel as cmk
    from repro_torch.kernels.clause_matmul.ops import tm_matmul_class_sums
    from repro_torch.kernels.tm_interp import kernel as tik
    from repro_torch.kernels.tm_interp.ops import (
        clause_ends,
        compressed_operands,
        plan_to_operands,
        tm_compressed_class_sums,
    )
    from repro_torch.kernels.pack_literals import kernel as plk
    from repro_torch.kernels.tm_popcount import kernel as tmk
    from repro_torch.kernels.tm_popcount.ops import (
        build_program,
        plan_to_popcount_operands,
    )

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
    for name, kernels in (("clause_eval", ("clause_eval",)),
                          ("clause_matmul", ("narrow", "product")),
                          ("tm_interp", ("tm_interp",)),
                          ("tm_popcount", ("clause_words", "reduce")),
                          ("tm_train", ("prologue", "update")),
                          ("interp_stream", ("decode", "evaluate")),
                          ("clause_table", ("vec1", "vec4")),
                          ("pack_literals", ("vec16", "bytes"))):
        for which, kname in enumerate(kernels):
            attr = _build.attributes(name, which)
            print(f"attributes {name} {kname}: numRegs {attr['regs']}, "
                  f"localSizeBytes {attr['local_bytes']}, "
                  f"sharedSizeBytes {attr['shared_bytes']}")
    for kname in ("prologue_kernel", "update_kernel"):
        print_sass("tm_train", str(_build.library_path("tm_train")), kname)

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

    # each case's program built on the card from its operands, and two as
    # PopcountEngine builds them: on the host, then moved
    programs = {
        name: (tmk.popcount_program(*ops), packed)
        for name, (ops, packed) in cases.items()
    }
    programs["engine build a@P=3"] = (build_program(
        plan_a, I_SERVED, M_CAP, l2_cap=1568, weight_planes=3, device=dev
    ), lits)
    programs["engine build zero-include class"] = (build_program(
        plan_z, I_CAP, M_CAP, l2_cap=1568, weight_planes=None, device=dev
    ), lits)

    # the shapes that break the clause-chunk walk: n_clauses off a multiple
    # of 32 and chunks that straddle two classes (model a), a class with no
    # clauses (plan_z), one plane and three, W = 37
    ends_a_np = clause_ends(cases["P=1 W=256"][0][1].cpu().numpy())
    cls_a = plan_a.clause_class  # one per clause, in stream order
    n_chunks_a = -(-ends_a_np.size // 32)
    straddle = sum(
        len(set(cls_a[32 * c:32 * c + 32].tolist())) > 1
        for c in range(n_chunks_a)
    )
    print(f"tm_popcount cases: model a {ends_a_np.size} clauses "
          f"({ends_a_np.size % 32} in its last chunk), {n_chunks_a} chunks, "
          f"{straddle} straddling two classes")
    if ends_a_np.size % 32 == 0 or straddle == 0:
        fail("model a no longer has a ragged clause count and straddling chunks")
    max_err = 0
    for name, (program, packed) in programs.items():
        got = tmk.tm_popcount(program, packed)
        want = tmk.tm_popcount_plain(*program[:4], packed)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            fail(f"kernel != plain twin on {name}: max abs err {err}")
        if name.endswith("zero-include class") and bool(got[3].any()):
            fail("the zero-include class has nonzero sums")
        print(f"parity {name}: equal, sums shape {tuple(got.shape)}")

    # -- 2b. the served packing kernel at the served shapes ---------------
    pack_row = pack_phase(dev)

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
    tmk.launches = plk.launches = 0
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
    main_launches, pack_launches = tmk.launches, plk.launches
    if acc.compile_cache_size() != 1:
        fail(f"compile_cache_size() == {acc.compile_cache_size()}, not 1")
    if main_launches == 0 or pack_launches == 0:
        fail("the main path never launched the tm_popcount or pack_literals kernel")
    print(
        f"serve: {acc.metrics_snapshot()['requests_completed']} requests, "
        f"hot-swap + rollback exact, compile_cache_size 1, tm_popcount "
        f"launches {main_launches}, pack_literals launches {pack_launches}"
    )

    # -- 3b. dense vs compressed: one model, four evaluations -------------
    # the matmul twin's float32 products are exact only without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32 = False")

    def dense_actions(acts):  # TA state -> include actions, int32 on the card
        state = state_from_actions(cfg, torch.from_numpy(acts).to(dev))
        return include_actions(cfg, state).to(torch.int32)

    actions_a, actions_z = dense_actions(acts_a), dense_actions(acts_z)
    lits_01 = literals(torch.from_numpy(X).to(dev)).T.to(torch.int32).contiguous()
    new_kernels = {"clause_eval": cek, "clause_matmul": cmk, "tm_interp": tik}
    torch.cuda.synchronize()
    for mod in new_kernels.values():
        mod.launches = 0
    form_fns = {  # each entry point as a user calls it -> int32[10, 8192]
        "tm_dense_class_sums": lambda: tm_dense_class_sums(
            actions_a, lits, n_classes=10
        ),
        "tm_matmul_class_sums": lambda: tm_matmul_class_sums(
            actions_a, lits_01, n_classes=10
        ),
        "tm_compressed_class_sums": lambda: tm_compressed_class_sums(
            plan_a, lits, m_cap=M_CAP, i_cap=I_CAP
        ),
        "served tm_popcount": lambda: torch.from_numpy(
            np.ascontiguousarray(acc.class_sums("mnist", X).T)
        ).to(dev),
    }
    forms = {name: fn() for name, fn in form_fns.items()}
    torch.cuda.synchronize()
    path_launches = {name: mod.launches for name, mod in new_kernels.items()}
    for name, n in path_launches.items():
        if n == 0:
            fail(f"the dense-vs-compressed phase never launched {name}")
    served_sums = forms["served tm_popcount"]
    for name, got in forms.items():
        if got.dtype != torch.int32 or got.shape != (10, 8192):
            fail(f"{name} gave {got.dtype} {tuple(got.shape)}")
        if not torch.equal(got, served_sums):
            err = int((got - served_sums).abs().max())
            fail(f"{name} != served tm_popcount sums (max abs err {err})")
        if not np.array_equal(got[:, :512].T.cpu().numpy(), sums_a):
            fail(f"{name} differs from the dense oracle on the first 512 rows")
    print(f"dense vs compressed: {sorted(forms)} equal on 8192 rows and to "
          f"the oracle on 512; launches {path_launches}")

    A2, Az = actions_a.reshape(2000, 1568), actions_z.reshape(2000, 1568)

    def interp_ops(plan, i_cap):
        return [
            torch.from_numpy(a).to(dev)
            for a in plan_to_operands(plan, i_cap, m_cap=M_CAP)
        ]

    # the operands and clause table as tm_compressed_class_sums builds them
    *ops_a, ends_a = compressed_operands(plan_a, I_CAP, M_CAP, dev)
    lits37 = lits[:, :37].contiguous()
    lits1 = lits[:, :1].contiguous()
    # one clause of 71 includes (features 0..69 and one negated literal),
    # its 70 positive literals all ones so that it fires
    acts_long = acts_a.copy()
    acts_long[4, 7] = False
    acts_long[4, 7, 0:140:2] = True
    acts_long[4, 7, 1001] = True
    plan_long = decode_to_plan(encode(cfg, acts_long))
    ops_long = interp_ops(plan_long, -(-plan_long.n_includes // 32) * 32)
    longest = int(np.diff(clause_ends(ops_long[1].cpu().numpy()), prepend=-1).max())
    if longest <= 64:
        fail(f"the long-clause case has no clause over 64 includes ({longest})")
    lits_long = lits.clone()
    lits_long[0:140:2] = -1
    # model a's clauses given random classes, some outside [0, M_CAP):
    # the clause table is not in class order and ids are clamped
    last_a = ops_a[1].cpu().numpy()
    clause_of = np.cumsum(last_a) - last_a  # clause index per instruction
    shuffled_cls = np.random.default_rng(3).integers(
        -2, M_CAP + 2, int(last_a.sum()) + 1
    ).astype(np.int32)[clause_of]
    ops_shuffled = [*ops_a[:3], torch.from_numpy(shuffled_cls).to(dev)]
    host_table = {"clause_end": ends_a}
    twin_cases = {
        "clause_eval": (cek.clause_eval, cek.clause_eval_plain, {
            "W=256": (A2, lits),
            "ragged W=37": (A2, lits37),
            "zero-include class": (Az, lits),
            # rows off the 16-byte grain: 4-byte copies
            "L2=1567": (A2[:, :1567].contiguous(), lits[:1567].contiguous()),
            "NC=1": (A2[:1].contiguous(), lits),
            "W=1": (A2, lits1),
        }),
        # NC off the 128-clause tile (2000, 37), B off and below the
        # 256-datapoint tile (8191, 100), L2 off the 64-byte scratch grain
        # and the 128-byte K step (1568, 100) and L2 = 1; all-zero rows
        "clause_matmul": (cmk.clause_matmul, cmk.clause_matmul_plain, {
            "B=8192": (A2, lits_01),
            "ragged B=8191": (A2, lits_01[:, :8191].contiguous()),
            "NC=37 B=100": (A2[:37].contiguous(), lits_01[:, :100].contiguous()),
            "L2=100": (A2[:, :100].contiguous(), lits_01[:100].contiguous()),
            "L2=1": (A2[:, :1].contiguous(), lits_01[:1].contiguous()),
            "zero-include class": (Az, lits_01),
        }),
        # (operands, literals, m_cap, clause table or none: derived on
        # the device)
        "tm_interp": (
            lambda *a: tik.tm_interp(*a[:5], m_cap=a[5], **a[6]),
            lambda *a: tik.tm_interp_plain(*a[:6]), {
                "I_cap=16928 W=256": (*ops_a, lits, M_CAP, {}),
                "host clause table": (*ops_a, lits, M_CAP, host_table),
                "ragged I_cap=16921 W=37": (
                    *interp_ops(plan_a, 16921), lits37, M_CAP, {}),
                "zero-include class": (
                    *interp_ops(plan_z, I_CAP), lits, M_CAP, {}),
                "clause of 71 includes": (*ops_long, lits_long, M_CAP, {}),
                "clauses out of class order": (
                    *ops_shuffled, lits, M_CAP, {}),
                "W=1": (*ops_a, lits1, M_CAP, {}),
                "m_cap=13 above 10 classes": (*ops_a, lits, 13, {}),
            }),
    }
    new_err = {}
    for kname, (kernel_fn, plain_fn, cases_k) in twin_cases.items():
        new_err[kname] = 0
        for cname, args in cases_k.items():
            got, want = kernel_fn(*args), plain_fn(*args)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            new_err[kname] = max(new_err[kname], err)
            if not torch.equal(got, want):
                fail(f"{kname} kernel != plain twin on {cname}: max abs err {err}")
            if cname == "zero-include class":
                # class 3 of acts_z: its sum row, or its 200 clause rows
                zero = got[3] if kname == "tm_interp" else got[600:800]
                if bool(zero.any()):
                    fail(f"{kname}: the zero-include class is not all zeros")
            if cname.startswith("m_cap=13") and bool(got[10:].any()):
                fail("tm_interp: the rows above the model's classes are not zero")
            print(f"parity {kname} {cname}: equal, shape {tuple(got.shape)}")

    # timings at full width, with each kernel's bound from these inputs;
    # the clause table as tm_compressed_class_sums builds it, on the host
    n_inc_a = int(ends_a[-1]) + 1
    a_i8 = A2.to(torch.int8)
    # the second operand of the product in both layouts: [L2][B] rows as
    # the plain twin reads it, and [B][L2] rows (column-major [L2, B]) as
    # the kernel's own int8 scratch holds it
    nl_i8 = {"row-major": (1 - lits_01).to(torch.int8)}
    nl_i8["column-major"] = nl_i8["row-major"].T.contiguous().T
    timed = {
        "clause_eval": (
            lambda: cek.clause_eval(A2, lits),
            lambda: cek.clause_eval_plain(A2, lits),
            # each input read once, the words written once; one AND per
            # include and batch word
            bound(4 * (A2.numel() + lits.numel() + A2.shape[0] * lits.shape[1]),
                  int(A2.sum()) * lits.shape[1]),
        ),
        "clause_matmul": (
            lambda: cmk.clause_matmul(A2, lits_01),
            lambda: cmk.clause_matmul_plain(A2, lits_01),
            # the dense product: 2 operations per multiply-add
            bound(4 * (A2.numel() + lits_01.numel()
                       + A2.shape[0] * lits_01.shape[1]),
                  2 * A2.numel() * lits_01.shape[1], PEAK_INT8_OPS),
        ),
        "tm_interp": (
            lambda: tik.tm_interp(*ops_a, lits, m_cap=M_CAP, **host_table),
            lambda: tik.tm_interp_plain(*ops_a, lits, M_CAP),
            # the function's four operand vectors, literals and sums (not
            # the clause table, which only this kernel reads); one AND per
            # include and word, one add per clause bit
            bound(4 * (sum(t.numel() for t in ops_a) + lits.numel()
                       + M_CAP * 32 * lits.shape[1]),
                  (n_inc_a + 32 * ends_a.numel()) * lits.shape[1]),
        ),
    }
    new_timings = {}
    for kname, (kfn, pfn, (bound_ms, bound_by)) in timed.items():
        k_ms = median_ms(kfn)
        p_ms = median_ms(pfn, reps=PLAIN_REPS, warmup=1)
        lib_ms = None
        if kname == "clause_matmul":
            # the product alone, as PyTorch's int8 GEMM computes it, in
            # both layouts of its second operand; the faster is library_ms.
            # The port never calls it.
            fired = cmk.clause_matmul(A2, lits_01)
            by_layout = {}
            for layout, b_i8 in nl_i8.items():
                try:
                    viol = torch._int_mm(a_i8, b_i8)
                except RuntimeError as e:  # a layout the library refuses
                    print(f"torch._int_mm refuses second operand {layout}: {e}")
                    continue
                want = ((viol == 0) & (A2.sum(1) > 0)[:, None]).to(torch.int32)
                if not torch.equal(want, fired):
                    fail(f"clause_matmul disagrees with torch._int_mm ({layout})")
                by_layout[layout] = median_ms(lambda: torch._int_mm(a_i8, b_i8))
                print(f"time torch._int_mm, second operand {layout}: "
                      f"{by_layout[layout]:.6f} ms")
            if not by_layout:
                fail("torch._int_mm took neither layout")
            lib_ms = min(by_layout.values())
            lib_b = nl_i8[min(by_layout, key=by_layout.get)]
        new_timings[kname] = (k_ms, p_ms, bound_ms, bound_by, lib_ms)
        lib = "none" if lib_ms is None else f"{lib_ms:.6f} ms"
        print(f"time {kname}: kernel {k_ms:.6f} ms, plain {p_ms:.6f} ms "
              f"(median of {PLAIN_REPS}), bound {bound_ms:.6f} ms ({bound_by}), "
              f"library {lib}")
    for name, fn in form_fns.items():
        # the whole entry point: host operand build, kernel, polarity sums
        print(f"time form {name}: {median_ms(fn, reps=PLAIN_REPS, warmup=1):.6f} "
              f"ms (median of {PLAIN_REPS})")
    # the compressed form's host work: its operand build and one copy, then
    # the kernel's wrapper up to the launch (host clock)
    host_ms = {
        "compressed_operands": lambda: compressed_operands(
            plan_a, I_CAP, M_CAP, dev),
        "tm_interp wrapper": lambda: tik.tm_interp(
            *ops_a, lits, m_cap=M_CAP, clause_end=ends_a),
    }
    for name, fn in host_ms.items():
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"time host {name}: {statistics.median(times):.6f} ms "
              f"(median of {REPS})")
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        for kfn, _, _ in timed.values():
            for _ in range(10):
                kfn()
        for _ in range(10):  # the library's product beside clause_matmul's
            torch._int_mm(a_i8, lib_b)
        torch.cuda.synchronize()
    for ev in prof.key_averages():  # every device kernel of the three
        us = getattr(ev, "device_time_total", 0) / max(ev.count, 1)
        if us > 0:
            print(f"profile 3b: {ev.key} {us:.3f} us/launch x{ev.count}")
    us, n = span_us(prof, "namespace)::narrow", "namespace)::product")
    print(f"profile 3b: clause_matmul device span narrow..product {us:.3f} "
          f"us/call (median of {n})")
    for kname in ("clause_eval", "tm_interp"):  # every device operation
        with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]
        ) as prof:
            for _ in range(10):
                timed[kname][0]()
            torch.cuda.synchronize()
        us, n_ops, ops = device_per_call(prof, 10)
        print(f"profile 3b: {kname} alone {us:.3f} us on the device per call, "
              f"{n_ops} device operations per call: "
              f"{[op[0][:60] for op in ops]}")

    # -- 3c. Fig-8 recalibration -----------------------------------------
    train_row = fig8_phase(dev, acts_a, X, pred_b.astype(np.int32))

    # -- 3d. the paper's stream interpreter and pruning -------------------
    models = {"a": (acts_a, None, model_a), "b": (acts_b, w_b, model_b)}
    oracles = {k: dense_sums(cfg, acts, w, X, dev) for k, (acts, w, _) in models.items()}
    stream_row = stream_phase(dev, cfg, served, models, X, pred_b.astype(np.int32),
                              oracles)

    # -- 3e. the fleet: pool sweep, rollout under traffic, canary, chaos ---
    fleet_phase(dev, cfg, served, models, X, oracles)

    # -- 3f. multi-device: clause_table, build_tm_sharded, the engines ---
    sharded_row, table_us = sharded_phase(dev, cfg, served, models, X, oracles)

    # -- 3g. the LM trunk: smoke archs, stablelm-3b at full width ----------
    lm = lm_phase(dev, card_identity())

    # -- 3j. the dry run held against 3g's steps and 3f's clause_table ----
    dryrun_phase(dev, card_identity(), lm, table_us)
    one_device = {k: lm[k] for k in ("arch", "train", "train_ms", "train_metrics",
                                     "train_peak_gib", "serve", "tokens", "prefill_ms",
                                     "serve_decode_ms", "serve_peak_gib",
                                     "serve_launch_us")}
    del lm

    # -- 3h. the recurrent and encoder-decoder families -------------------
    recurrent_phase(dev, card_identity())

    # -- 3i. the LM on a mesh: EP MoE, moonshot served, launch.train -------
    mesh_phase(dev, card_identity())

    # -- 3k, 3l. the LM train path and serving on a rank mesh -------------
    rank_phase(dev, card_identity(), one_device)

    # -- 4. timings --------------------------------------------------------
    def kernel_bound(ops, packed):
        """(bound ms, what bounds it, bytes, operations) on these inputs,
        the least the function needs whatever implements it: each input
        read once and the sums written once; one AND per include and
        batch word, and per (plane, class) ceil(its clauses / 32) chunks
        of two ANDs and two popcounts per datapoint."""
        li, last, mp, mn = ops
        planes = 1 if mp.dim() == 2 else mp.shape[0]
        l2, w = packed.shape
        ends = torch.nonzero(last == 1)
        n_inc = int(ends[-1]) + 1 if ends.numel() else 0
        # clauses each (plane, class) selects: set bits of its masks
        selected = popcount(mp | mn).sum(dim=-1, dtype=torch.int64)
        chunks = int(((selected + 31) // 32).sum())
        m_cap, i_chunks = mp.shape[-2], mp.shape[-1]
        n_bytes = 4 * (
            l2 * w + 2 * li.numel() + int((last == 1).sum())
            + 2 * planes * m_cap * i_chunks + m_cap * 32 * w
        )
        n_ops = n_inc * w + 4 * chunks * 32 * w
        return (*bound(n_bytes, n_ops), n_bytes, n_ops)

    timings = {}
    for name in ("P=1 W=256", "P=3 W=256", "main path a@P=3"):
        ops, packed = cases[name]
        program = programs[name][0]  # built once, as the engine builds it
        k_ms = median_ms(lambda: tmk.tm_popcount(program, packed))
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
                tmk.tm_popcount(program, packed)
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if "kernel" in ev.key and ev.count:
                us = getattr(ev, "device_time_total", 0) / ev.count
                print(f"profile {name}: {ev.key} {us:.3f} us/launch x{ev.count}")
        us, n = span_us(prof, "namespace)::clause_words_kernel",
                        "namespace)::reduce_kernel")
        print(f"profile {name}: device span clause_words..reduce {us:.3f} "
              f"us/call (median of {n})")
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
    dev = device_ops(prof)
    busy_us = sum(d[0] for d in dev)
    print(
        f"profile flush: wall {wall_us:.1f} us, device busy {busy_us:.1f} us "
        f"(idle share {1 - busy_us / wall_us:.3f})"
    )
    for us, key, count in dev[:8]:
        print(f"profile flush: {us:.1f} us  x{count}  {key[:90]}")

    # -- 5. result lines ---------------------------------------------------
    k_ms, p_ms, bound_ms, bound_by = timings["main path a@P=3"]
    rows = [("tm_popcount", "src/repro/kernels/tm_popcount/kernel.py:128",
             main_launches, max_err, (k_ms, p_ms, bound_ms, bound_by, None))]
    for kname, body in (("clause_eval", "clause_eval/kernel.py:28"),
                        ("clause_matmul", "clause_matmul/kernel.py:28"),
                        ("tm_interp", "tm_interp/kernel.py:37")):
        rows.append((kname, f"src/repro/kernels/{body}", path_launches[kname],
                     new_err[kname], new_timings[kname]))
    rows += [train_row, stream_row, sharded_row,
             ("pack_literals", "none: src/repro/core/tm.py:159 is jnp code that XLA "
              "fuses", pack_launches, 0, pack_row)]
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/csrc/{name}.cu",
        "replaces": body,
        "launches": n,
        "max_abs_err": err,
        "ms": t[0],
        "plain_ms": t[1],
        "bound_ms": t[2],
        "bound_by": t[3],
        "library_ms": t[4],
    } for name, body, n, err, t in rows]}))
    print(card_identity())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
