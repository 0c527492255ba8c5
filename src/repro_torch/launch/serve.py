"""Batched serving driver (LM prefill + greedy decode), the port of
``repro.launch.serve``, with the reference's fixed-capacity discipline:
the decode cache's capacity is fixed at construction and a model swap is
a weight rewrite.  A mesh installs the activation mesh, as the
reference's does (MoE layers then take the expert-parallel path); the
CLI serves on a (1, 1) mesh of its device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b-smoke \\
        --batch 4 --prompt-len 32 --gen 16 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.registry import get
from ..device import resolve_device
from ..dist import sharding as shd
from ..dist.steps import make_decode_step, make_prefill_step
from ..models.api import family_for


class Server:
    """Fixed-shape serving engine for one (batch, prompt_cap, gen_cap) on
    ``device`` (the CUDA card unless ``device="cpu"``).  The decode-cache
    capacity is ``prompt_cap + gen_cap``, fixed at construction, so every
    ``generate`` call runs the same shapes whatever the requested token
    count.  ``mesh`` (every tile on ``device``) is installed as the
    activation mesh, which stays installed after the server is gone."""

    def __init__(self, cfg, mesh=None, *, batch: int, prompt_cap: int,
                 gen_cap: int = 16, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        if getattr(mesh, "distributed", False):
            raise NotImplementedError(
                "Server on a rank mesh (one process per card): the caches' "
                "cache_shardings over ranks are not ported; serve on a logical mesh")
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
        self.prefill = make_prefill_step(cfg)
        self.decode = make_decode_step(cfg)
        self.params = None

    def load_weights(self, params):
        """Model swap: pure data movement (the Fig-8 reprogram step)."""
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
        tokens = torch.from_numpy(padded).to(self.device)
        logits, cache = self.prefill(self.params, {"tokens": tokens})
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out = [tok]
        for i in range(n_tokens - 1):
            tok, cache = self.decode(
                self.params, cache, {"token": tok, "pos": plen + i}
            )
            tok = tok[:, None]
            out.append(tok)
        return torch.cat(out, dim=1).cpu().numpy()


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
