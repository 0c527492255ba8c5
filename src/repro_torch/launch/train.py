"""Training loop with fault tolerance, the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b-smoke \
        --steps 50 --batch 8 --seq 128 --mesh 1x1 --ckpt /tmp/run1 [--device cpu]

Integrates: config registry, the batch placed by its shardings, AdamW,
checkpoint/restart (atomic; exact-resume data state), straggler monitor.
The mesh is ``--mesh DATAxMODEL`` tiles of the CUDA cards (tile ``i`` on
card ``i % device_count()``; raises without one) or, with ``--device``,
of that one device; the train state lives whole on the mesh's device
(``dist.sharding.place``), so a mesh whose tiles span several cards
raises ``NotImplementedError``.  MoE layers take the expert-parallel
path over the mesh's ``model`` axis.  A step's printed time runs until
its loss and gradient norm are read, so it includes the device's work.

``main(argv)`` returns what it ran: per step ``(loss, grad_norm)`` and
seconds, the seconds of each save and of the restore, and the final
``params`` and ``opt`` state.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ShapeSpec
from ..configs.registry import get
from ..data.pipeline import TokenStream, TokenStreamConfig, shard_batch
from ..dist import sharding as shd
from ..dist.steps import make_train_step, opt_config_for
from ..models.api import family_for
from ..optim import adamw
from ..runtime_ft.supervisor import StragglerMonitor


def build(cfg, mesh, *, seq: int, batch: int):
    """-> (step, param shardings, optimizer shardings, input shardings,
    optimizer config, shape) for ``cfg`` on ``mesh``, the activation
    mesh installed.  ``step(params, opt_state, batch)`` runs on the
    mesh's device and updates params and moments in place."""
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
                           device=shd.mesh_device(mesh, "the train state"))
    return step, p_sh, o_sh, in_sh, opt_cfg, shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", type=str, default="1x1", help="DATAxMODEL")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cpu', 'cuda' or 'cuda:N' (default: the CUDA cards)")
    args = ap.parse_args(argv)

    cfg = get(args.arch)
    d, m = (int(x) for x in args.mesh.split("x"))
    mesh = shd.make_mesh((d, m), ("data", "model"), devices=args.device)
    step, p_sh, o_sh, in_sh, opt_cfg, shape = build(
        cfg, mesh, seq=args.seq, batch=args.batch
    )
    fam = family_for(cfg)

    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    stream = TokenStream(TokenStreamConfig(cfg.vocab, args.seq, args.batch))
    monitor = StragglerMonitor()

    record = {"metrics": {}, "step_s": {}, "save_s": {}, "restore_s": None}
    start = 0
    params = fam.init_params(cfg, 0, device=shd.mesh_device(mesh, "the params"))
    opt_state = adamw.init(opt_cfg, params)
    if ckpt and ckpt.latest_step() is not None:
        s = ckpt.latest_step()
        t0 = time.time()
        state = ckpt.restore(
            s, like={"params": params, "opt": opt_state, "data": 0},
            shardings={"params": p_sh, "opt": o_sh, "data": shd.replicated(mesh)},
        )
        params, opt_state = state["params"], state["opt"]
        stream.restore(int(state["data"]))
        start = s
        record["restore_s"] = time.time() - t0
        print(f"[restore] step {s}")

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
        batch = shard_batch(batch, mesh, in_sh)
        params, opt_state, metrics = step(params, opt_state, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        dt = time.time() - t0
        record["metrics"][step_i + 1] = (loss, gnorm)
        record["step_s"][step_i + 1] = dt
        verdict = monitor.observe("host0", dt)
        if verdict != "ok":
            print(f"[straggler] host0 {verdict} ({dt:.2f}s)")
        if (step_i + 1) % args.log_every == 0:
            print(
                f"step {step_i+1}: loss {loss:.4f} gnorm {gnorm:.3f} ({dt:.2f}s)",
                flush=True,
            )
        if ckpt and (step_i + 1) % args.save_every == 0:
            t0 = time.time()
            ckpt.save(
                step_i + 1,
                {"params": params, "opt": opt_state, "data": stream.state()},
            )
            record["save_s"][step_i + 1] = time.time() - t0
    print("done")
    return {**record, "params": params, "opt": opt_state}


if __name__ == "__main__":
    main()
