"""Atomic checkpoints of trees of tensors, the port of
``repro.checkpoint.manager``.

Layout (the reference's, so either package restores what the other saved):
          <dir>/step_<N>.tmp/ -> (atomic rename) -> <dir>/step_<N>/
            manifest.json     leaf names in flatten order + shapes/dtypes
            leaf_<i>.npy      one file per leaf

Fault-tolerance properties:
  * atomic publish (tmp dir + rename) — a crash mid-save never corrupts the
    latest checkpoint;
  * ``restore`` takes a target sharding tree, so the same checkpoint restores
    onto a different mesh (elastic scaling: see runtime_ft/elastic.py);
  * ``keep_last`` garbage collection.

A tree is flattened by JAX's rules, not ``torch.utils._pytree``'s, because
``restore`` holds the manifest's leaf names in order: dict keys sorted (an
``OrderedDict`` keeps its own order), lists and tuples by index,
namedtuple fields as ``.<field>``, and ``None`` an empty subtree; an
``nn.Module`` (the LM's ``LMParams``) is walked as its parameter dict
(``tree.as_tree``), so its names are the reference's param-tree paths,
and comes back as the same class built on the restored dict
(``type(m)(m.cfg, tree)``); every other object is a leaf.

A bf16 leaf is written as the reference writes one: its 2-byte words as
a ``V2`` array, ``"bfloat16"`` in the manifest.  The port reads such a
leaf back as bf16 (the reference's ``restore`` cannot: ``jnp.asarray``
refuses the ``V2`` array).

Under a ``torch.distributed`` process group of more than one rank,
``save`` is collective: every rank calls it with its own tree, each
``DTensor`` leaf (a block of a rank mesh) is all-gathered into its whole
logical array, rank 0 writes the reference's layout (whole leaves, the
same manifest and names) and publishes it by the atomic rename, and
every rank waits on a barrier before returning, so ``latest_step`` on
any rank sees the step once ``save`` returns.  ``save_async`` is then
the same collective save, finished before it returns.

``restore(step, like)`` places each leaf on the device of ``like``'s
matching leaf, or, given ``shardings``, where its ``NamedSharding``
places it (``dist.sharding.place``), in ``like``'s leaf dtype.  On a
rank mesh each rank reads only its block of each file (a memory map)
and gets it as a ``DTensor``.  The
reference keeps the saved dtype; the port casts, so that a reference PRNG
key saved as uint32 words restores as the port's int64 key words
(``convert.key_from_numpy``).  A value that does not survive the cast
raises ``ValueError``.
"""

from __future__ import annotations

import copy
import json
import shutil
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..tree import as_tree


def _entries(node) -> Optional[List[Tuple[Any, str]]]:
    """[(key, name)] of a container node in JAX's flatten order, or
    None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        keys = list(node) if isinstance(node, OrderedDict) else sorted(node)
        return [(k, str(k)) for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(i, f".{f}") for i, f in enumerate(node._fields)]
    if isinstance(node, (list, tuple)):
        return [(i, str(i)) for i in range(len(node))]
    return None


def _flatten_with_names(tree: Any, path: Tuple[str, ...] = ()):
    if isinstance(tree, nn.Module):
        tree = as_tree(tree)
    entries = _entries(tree)
    if entries is None:
        return ["/".join(path)], [tree]
    names, leaves = [], []
    for key, name in entries:
        n, l = _flatten_with_names(tree[key], path + (name,))
        names += n
        leaves += l
    return names, leaves


def _map(fn, tree: Any) -> Any:
    """``tree`` with each leaf replaced by ``fn(leaf)``, called in
    flatten order; a dict comes back in its flatten order, as JAX
    rebuilds it, and a module as its class over the mapped dict."""
    if isinstance(tree, nn.Module):
        return type(tree)(tree.cfg, _map(fn, as_tree(tree)))
    entries = _entries(tree)
    if entries is None:
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = copy.copy(tree)  # keeps the type (and a default_factory)
        out.clear()
        for key, _ in entries:
            out[key] = _map(fn, tree[key])
        return out
    values = [_map(fn, tree[key]) for key, _ in entries]
    return type(tree)(*values) if hasattr(tree, "_fields") else type(tree)(values)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """-> (the array to save, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _saved_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def _restore_leaf(arr: np.ndarray, dtype: str, like, name: str) -> torch.Tensor:
    """The saved leaf as a host tensor in ``like``'s dtype (the saved
    dtype when ``like`` is no tensor)."""
    if not isinstance(like, torch.Tensor):
        return _saved_tensor(arr, dtype)
    if dtype == "bfloat16" or like.dtype == torch.bfloat16:
        t = _saved_tensor(arr, dtype)
        cast = t.to(like.dtype)
        back = cast.to(t.dtype)
        same = torch.equal(back, t)
        if not same and t.is_floating_point() and cast.is_floating_point():
            nan = torch.isnan(t)
            same = torch.equal(nan, torch.isnan(back)) and torch.equal(back[~nan], t[~nan])
        if not same:
            raise ValueError(
                f"leaf {name!r}: the saved {dtype} values do not survive "
                f"the cast to {like.dtype}"
            )
        return cast
    want = torch.empty(0, dtype=like.dtype).numpy().dtype
    if arr.dtype != want:
        cast = arr.astype(want)
        floats = arr.dtype.kind in "fc" and want.kind in "fc"
        if not np.array_equal(cast, arr, equal_nan=floats):
            raise ValueError(
                f"leaf {name!r}: the saved {arr.dtype} values do not survive "
                f"the cast to {like.dtype}"
            )
        arr = cast
    return torch.from_numpy(arr)


def _world() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any) -> Path:
        from ..dist.collectives import gather_full
        from ..dist.sharding import _is_dtensor

        names, leaves = _flatten_with_names(tree)
        ranked = _world() > 1
        writer = not ranked or torch.distributed.get_rank() == 0
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if writer:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (name, leaf) in enumerate(zip(names, leaves)):
            if _is_dtensor(leaf):
                leaf = gather_full(leaf)  # collective: every rank takes part
            if writer:
                arr, dtype = _to_numpy(leaf)
                np.save(tmp / f"leaf_{i}.npy", arr)
                manifest["leaves"].append(
                    {"name": name, "shape": list(arr.shape), "dtype": dtype}
                )
        if writer:
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic publish
            self._gc()
        if ranked:
            torch.distributed.barrier()
        return final

    def save_async(self, step: int, tree: Any):
        """Non-blocking save: copies every tensor to the host first (a
        copy even of a host tensor, so an in-place update after this call
        does not reach the checkpoint), then writes in a background
        thread (the atomic rename publishes only when complete).  Returns
        the Thread (join() to flush).  Under a process group of more
        than one rank it is the collective ``save``, done before it
        returns (the Thread has nothing left to do)."""
        if _world() > 1:
            self.save(step, tree)
            t = threading.Thread(target=lambda: None, daemon=True)
            t.start()
            return t
        host_tree = _map(
            lambda x: x.detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.asarray(x),
            tree,
        )
        t = threading.Thread(target=self.save, args=(step, host_tree), daemon=True)
        t.start()
        return t

    # -- restore ---------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.name.endswith(".tmp"):
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Restore into the structure of ``like``: each leaf a tensor in
        the dtype of ``like``'s matching leaf (a leaf of ``like`` that is
        no tensor gets the saved dtype), on that leaf's device (a host
        tensor for a leaf that is no tensor) or, if ``shardings`` is given
        (a tree whose ``NamedSharding`` leaves match ``like``'s leaves in
        flatten order), placed by its sharding -- possibly on a different
        mesh than the one that saved (elastic restore)."""
        src = self.dir / f"step_{step}"
        manifest = json.loads((src / "manifest.json").read_text())
        names, likes = _flatten_with_names(like)
        if len(names) != len(manifest["leaves"]):
            raise AssertionError("tree structure mismatch")
        sh_leaves = [None] * len(names)
        if shardings is not None:
            _, sh_leaves = _flatten_with_names(shardings)
            if len(sh_leaves) != len(names):
                raise ValueError(
                    f"shardings has {len(sh_leaves)} leaves for {len(names)} "
                    "leaves of like"
                )
        from ..dist.sharding import _check_spec, from_block, local_slices, place

        out = []
        for i, (name, rec) in enumerate(zip(names, manifest["leaves"])):
            if name != rec["name"]:
                raise AssertionError(
                    f"leaf order mismatch: {name} != {rec['name']}"
                )
            sh = sh_leaves[i]
            if sh is not None and getattr(sh.mesh, "distributed", False):
                # this rank's block only, read through a memory map
                arr = np.load(src / f"leaf_{i}.npy", mmap_mode="r")
                _check_spec(arr.shape, sh.spec, sh.mesh, name)
                # a copy: a tensor over the read-only map would fault on write
                block = np.array(arr[local_slices(arr.shape, sh.spec, sh.mesh)], copy=True)
                t = _restore_leaf(block, rec["dtype"], likes[i], name)
                out.append(from_block(t.to(sh.mesh.device), sh, arr.shape))
                continue
            arr = np.load(src / f"leaf_{i}.npy")
            t = _restore_leaf(arr, rec["dtype"], likes[i], name)
            if sh is not None:
                t = place(t, sh, name)
            elif isinstance(likes[i], torch.Tensor):
                t = t.to(likes[i].device)
            out.append(t)
        leaves = iter(out)
        return _map(lambda _: next(leaves), like)

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
