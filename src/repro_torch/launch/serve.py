"""Batched serving driver (LM prefill + greedy decode), the port of
``repro.launch.serve``, with the reference's fixed-capacity discipline:
the decode cache's capacity is fixed at construction and a model swap is
a weight rewrite.  A mesh installs the activation mesh, as the
reference's does (MoE layers then take the expert-parallel path); the
CLI serves on a (1, 1) mesh of its device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b-smoke \\
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]

On a rank mesh (one process per device, ``make_mesh(...,
distributed=True)`` after ``launch.mesh.init_distributed``) each rank
builds the same ``Server``, loads its blocks of the weights
(``sharding.place_tree`` by ``param_shardings``) and calls ``generate``
with the same prompts: it prefills and decodes its rows of the batch
with its heads of the caches (``dist.steps._RankServeStep``) and
returns the whole batch's tokens.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.base import ShapeSpec
from ..configs.registry import get
from ..data.pipeline import shard_batch
from ..device import resolve_device
from ..dist import sharding as shd
from ..dist.collectives import gather_full
from ..dist.steps import make_decode_step, make_prefill_step
from ..models.api import family_for
from ..tree import as_tree, flatten


class Server:
    """Fixed-shape serving engine for one (batch, prompt_cap, gen_cap) on
    ``device`` (the CUDA card unless ``device="cpu"``).  The decode-cache
    capacity is ``prompt_cap + gen_cap``, fixed at construction, so every
    ``generate`` call runs the same shapes whatever the requested token
    count.  ``mesh`` (every tile on ``device``) is installed as the
    activation mesh, which stays installed after the server is gone.  On
    a rank mesh ``device`` defaults to the rank's (see the module
    docstring)."""

    def __init__(self, cfg, mesh=None, *, batch: int, prompt_cap: int,
                 gen_cap: int = 16, device=None):
        self.cfg = cfg
        self.ranks = getattr(mesh, "distributed", False)
        self.device = mesh.device if self.ranks and device is None else resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            on = resolve_device(shd.mesh_device(mesh, "Server"))
            if on != self.device:
                raise ValueError(f"the mesh's tiles are on {on}, the server on "
                                 f"{self.device}")
            shd.set_activation_mesh(mesh)
        self.fam = family_for(cfg)
        self.batch = batch
        self.prompt_cap = prompt_cap
        self.gen_cap = gen_cap
        self.cache_cap = prompt_cap + gen_cap
        self.prefill = make_prefill_step(cfg, mesh)
        self.decode = make_decode_step(cfg, mesh)
        self.params = None

    def load_weights(self, params):
        """Model swap: pure data movement (the Fig-8 reprogram step).  On a
        rank mesh ``params`` are this rank's blocks: every leaf a
        ``DTensor`` of the mesh laid out by ``param_shardings``."""
        if self.ranks:
            want = dict(flatten(shd.param_shardings(
                self.cfg, self.mesh, self.fam.param_specs(self.cfg))))
            for path, t in flatten(as_tree(params)):
                if not shd.is_block_of(t, self.mesh):
                    raise ValueError(f"param {path!r} is not a block of the server's rank "
                                     "mesh: place it with sharding.place_tree")
                if path not in want or list(t.placements) != shd.spec_to_placements(
                        want[path].spec, self.mesh):
                    raise ValueError(f"param {path!r} is laid out {t.placements}, not "
                                     "by param_shardings")
        self.params = params

    def generate(self, prompts: np.ndarray, n_tokens: int) -> np.ndarray:
        """prompts: int32[B, prompt_len] -> int32[B, n_tokens].

        The prompt is right-padded to ``cache_cap = prompt_cap + gen_cap``
        so the prefill allocates decode-capacity KV buffers (fixed-shape
        discipline); decode steps then fill slots sequentially, and the
        per-step kv_len mask hides not-yet-written slots.  As in the
        reference, the first token follows the last padded position
        (``cache_cap - 1``), not the prompt's last token."""
        B, plen = prompts.shape
        if plen > self.prompt_cap:
            raise ValueError(
                f"prompt length {plen} exceeds prompt_cap {self.prompt_cap}"
            )
        if n_tokens > self.gen_cap:
            raise ValueError(
                f"n_tokens {n_tokens} exceeds gen_cap {self.gen_cap}"
            )
        padded = np.zeros((B, self.cache_cap), np.int32)
        padded[:, :plen] = prompts
        rows = self._rows(B)
        logits, cache = self.prefill(self.params, self._inputs(padded))
        tok = torch.argmax(shd.local(logits), dim=-1).to(torch.int32)[:, None]
        out = [tok]
        for i in range(n_tokens - 1):
            tok, cache = self.decode(
                self.params, cache, {"token": rows(tok), "pos": plen + i}
            )
            tok = shd.local(tok)[:, None]
            out.append(tok)
        out = torch.cat(out, dim=1)
        return (gather_full(rows(out)) if self.ranks else out).cpu().numpy()

    def _inputs(self, padded: np.ndarray) -> dict:
        """The prefill's batch: the padded prompts on the device, or on a
        rank mesh this rank's rows of them (``shard_batch``)."""
        if not self.ranks:
            return {"tokens": torch.from_numpy(padded).to(self.device)}
        shape = ShapeSpec("prefill", padded.shape[1], padded.shape[0], "prefill")
        return shard_batch({"tokens": padded}, self.mesh, shd.input_shardings(
            self.cfg, self.mesh, shape, self.fam.input_specs(self.cfg, shape)))

    def _rows(self, B: int):
        """-> a function from this rank's rows ``t`` [B_l, n] of a [B, n]
        tensor to a ``DTensor`` split over the batch axes (a rank mesh);
        off a rank mesh, the identity."""
        if not self.ranks:
            return lambda t: t
        rows = shd.NamedSharding(self.mesh, shd.P(shd.batch_axes(self.mesh, B), None))
        return lambda t: shd.from_block(t, rows, (B, t.shape[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cpu', 'cuda' or 'cuda:N' (default: the CUDA card)")
    args = ap.parse_args()

    cfg = get(args.arch)
    device = resolve_device(args.device)
    mesh = shd.make_mesh((1, 1), ("data", "model"), devices=device)
    # decode cache capacity (prompt + generation) is fixed at construction
    server = Server(cfg, mesh, batch=args.batch, prompt_cap=args.prompt_len,
                    gen_cap=args.gen, device=device)
    server.load_weights(family_for(cfg).init_params(cfg, 0, device=server.device))

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(
        np.int32
    )
    t0 = time.time()
    tokens = server.generate(prompts, args.gen)
    dt = time.time() - t0
    print(f"generated {tokens.shape} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {server.device}")
    print(tokens[:, :8])


if __name__ == "__main__":
    main()
