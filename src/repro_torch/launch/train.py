"""Training loop with fault tolerance, the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b-smoke \
        --steps 50 --batch 8 --seq 128 --mesh 1x1 --ckpt /tmp/run1 [--device cpu]

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch stablelm-3b-smoke --mesh 2x2 \
        --steps 4 --batch 4 --seq 32 [--device cpu]

Integrates: config registry, the batch placed by its shardings, AdamW,
checkpoint/restart (atomic; exact-resume data state), straggler monitor.

Without a launcher the mesh is ``--mesh DATAxMODEL`` tiles of the CUDA
cards (tile ``i`` on card ``i % device_count()``; raises without one)
or, with ``--device``, of that one device; the train state lives whole
on the mesh's device (``dist.sharding.place``), so such a mesh whose
tiles span several cards raises ``NotImplementedError``.

Under ``torch.distributed.run`` (or any started process group) the mesh
is a rank mesh: one process per device, ``DATA x MODEL`` equal to the
world size, NCCL on the cards (each rank its ``LOCAL_RANK`` card) or
gloo with ``--device cpu``.  Params and moments are stored as each
rank's blocks of the reference's specs, each rank trains on its rows of
the batch (``dist.steps.make_train_step``), checkpoints are written
whole by rank 0 (``CheckpointManager.save``) and restored block by
block.  Only rank 0 prints.

MoE layers take the expert-parallel path over the mesh's ``model``
axis.  A step's time runs until its loss and gradient norm are read, so
it includes the device's work; on a rank mesh it is the slowest rank's.

``main(argv)`` returns what it ran, the same on every rank: per step
``(loss, grad_norm)`` and seconds, the seconds of each save and of the
restore, and the final ``params`` and ``opt`` state (this rank's blocks
on a rank mesh).  ``on_step(step, record)``, if given, is called after
each step's record is written (a profiler's hook).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ShapeSpec
from ..configs.registry import get
from ..data.pipeline import TokenStream, TokenStreamConfig, shard_batch
from ..dist import collectives
from ..dist import sharding as shd
from ..dist.steps import make_train_step, opt_config_for
from ..launch.mesh import init_distributed
from ..models.api import family_for
from ..optim import adamw
from ..runtime_ft.supervisor import StragglerMonitor


def build(cfg, mesh, *, seq: int, batch: int):
    """-> (step, param shardings, optimizer shardings, input shardings,
    optimizer config, shape) for ``cfg`` on ``mesh``, the activation
    mesh installed.  ``step(params, opt_state, batch)`` runs on the
    mesh's device (this rank's, on a rank mesh) and updates params and
    moments in place."""
    shd.set_activation_mesh(mesh)
    fam = family_for(cfg)
    shape = ShapeSpec("train_cli", seq, batch, "train")
    p_specs = fam.param_specs(cfg)
    p_sh = shd.param_shardings(cfg, mesh, p_specs)
    opt_cfg = opt_config_for(cfg)
    o_specs = adamw.init_specs(opt_cfg, p_specs)
    o_sh = shd.opt_shardings(cfg, mesh, o_specs, p_sh)
    in_specs = fam.input_specs(cfg, shape)
    in_sh = shd.input_shardings(cfg, mesh, shape, in_specs)
    step = make_train_step(cfg, opt_cfg, microbatches=cfg.train_microbatches,
                           device=shd.mesh_device(mesh, "the train state"), mesh=mesh)
    return step, p_sh, o_sh, in_sh, opt_cfg, shape


def _launched() -> bool:
    import os

    dist = torch.distributed
    return (dist.is_available() and dist.is_initialized()) or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ)


def _slowest(seconds: float, mesh) -> float:
    """The largest of the ranks' ``seconds`` (itself on a logical mesh)."""
    if not mesh.distributed:
        return seconds
    t = torch.tensor(seconds, dtype=torch.float64, device=mesh.device)
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return float(t)


def main(argv=None, on_step=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", type=str, default="1x1", help="DATAxMODEL")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--log-collectives", action="store_true",
                    help="print each step's collective bytes per kind (a rank mesh) "
                         "beside dist.sharding.spec_collective_bytes")
    ap.add_argument("--device", default=None,
                    help="'cpu', 'cuda' or 'cuda:N' (default: the CUDA cards)")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    d, m = (int(x) for x in args.mesh.split("x"))
    ranked = _launched()
    if ranked:
        init_distributed(args.device)
    mesh = shd.make_mesh((d, m), ("data", "model"), devices=args.device,
                         distributed=ranked)
    rank0 = not ranked or torch.distributed.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    step, p_sh, o_sh, in_sh, opt_cfg, shape = build(
        cfg, mesh, seq=args.seq, batch=args.batch
    )
    fam = family_for(cfg)

    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    stream = TokenStream(TokenStreamConfig(cfg.vocab, args.seq, args.batch))
    monitor = StragglerMonitor()

    record = {"metrics": {}, "step_s": {}, "save_s": {}, "restore_s": None,
              "collectives": {}}
    start = 0
    # every rank draws the whole init on its device and keeps its blocks
    params = fam.init_params(cfg, 0, device=shd.mesh_device(mesh, "the params"))
    if mesh.distributed:
        params = shd.place_tree(params, p_sh)
    opt_state = adamw.init(opt_cfg, params)
    if ckpt and ckpt.latest_step() is not None:
        s = ckpt.latest_step()
        t0 = time.time()
        state = ckpt.restore(
            s, like={"params": params, "opt": opt_state, "data": 0},
            shardings={"params": p_sh, "opt": o_sh, "data": shd.replicated(mesh)},
        )
        params, opt_state = state["params"], state["opt"]
        stream.restore(int(shd.local(state["data"])))
        start = s
        record["restore_s"] = _slowest(time.time() - t0, mesh)
        say(f"[restore] step {s}")

    for step_i in range(start, args.steps):
        t0 = time.time()
        batch = stream.next_batch()
        if "tokens" in batch and cfg.family == "vlm":
            # vlm training consumes patches + shortened token seq (the
            # reference's zeros are float32: numpy has no bfloat16)
            B = batch["tokens"].shape[0]
            batch = {
                "patches": np.zeros((B, cfg.n_patches, cfg.d_model), np.float32),
                "tokens": batch["tokens"][:, : args.seq - cfg.n_patches],
            }
        batch = shard_batch(batch, mesh, in_sh, microbatches=cfg.train_microbatches)
        collectives.reset_counts()
        params, opt_state, metrics = step(params, opt_state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        counted = collectives.counts()
        moved = {k: v["bytes"] for k, v in counted.items()}
        dt = _slowest(time.time() - t0, mesh)
        record["metrics"][step_i + 1] = (loss, gnorm)
        record["step_s"][step_i + 1] = dt
        record["collectives"][step_i + 1] = moved
        if args.log_collectives:
            est = shd.spec_collective_bytes(cfg, shape, mesh, {
                "params": fam.param_specs(cfg), "inputs": fam.input_specs(cfg, shape)})
            def by_axis(k):
                return ", ".join(f"{a} {b}" for a, (_, b) in
                                 counted.get(k, {"by_axis": {}})["by_axis"].items())

            say(f"collectives step {step_i + 1} (bytes per rank, rank 0): "
                + "; ".join(f"{k} {moved.get(k, 0)} [{by_axis(k)}] (spec estimate "
                            f"{est[k]:.0f})"
                            for k in ("all-gather", "reduce-scatter", "all-reduce")))
        verdict = monitor.observe("host0", dt)
        if verdict != "ok":
            say(f"[straggler] host0 {verdict} ({dt:.2f}s)")
        if (step_i + 1) % args.log_every == 0:
            say(
                f"step {step_i+1}: loss {loss:.4f} gnorm {gnorm:.3f} ({dt:.2f}s)",
                flush=True,
            )
        if on_step is not None:
            on_step(step_i + 1, record)
        if ckpt and (step_i + 1) % args.save_every == 0:
            t0 = time.time()
            ckpt.save(
                step_i + 1,
                {"params": params, "opt": opt_state, "data": stream.state()},
            )
            record["save_s"][step_i + 1] = _slowest(time.time() - t0, mesh)
    say("done")
    return {**record, "params": params, "opt": opt_state}


if __name__ == "__main__":
    main()
