"""Step builders, the port of ``repro.dist.steps``: the LM train,
prefill and decode steps on one device, and the class-sharded Tsetlin
Machine train step (the Fig-8 training node scaled out over a mesh of the
port).

``make_train_step`` supports gradient-accumulation microbatching (the
activation-memory knob recorded per arch as ``train_microbatches``): the
global batch is split on its leading dim, grads are accumulated in fp32,
then one AdamW update is applied.  Given a rank mesh it builds the step
of one rank (``_RankTrainStep``: the reference's GSPMD step, params and
moments as ``DTensor`` blocks, see its docstring).

TA state shards its class dim over ``model``; the batch shards over the
non-``model`` axes (``sharding.batch_axes``).  Tile (batch shard ``b``,
class slice ``m``) computes the summed-delta feedback of its batch rows
restricted to its class rows (``core.train.class_slice_delta``, the sum
of the reference's per-sample ``sample_class_delta``) on its device; the
deltas of one class slice are summed across its batch tiles on the
slice's home device (the reference's ``psum``) and one clipped update is
applied.  Integer deltas commute, so the result equals
``core.train.train_batch_parallel`` bit for bit on any mesh.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..core.tm import TMConfig
from ..core.train import class_slice_delta, sample_keys
from ..device import resolve_device
from ..models.api import family_for
from ..optim import adamw
from ..tree import as_tree, flatten, unflatten
from .sharding import _axis_sizes, batch_shards
from .tm_sharded import _on


def opt_config_for(cfg) -> adamw.AdamWConfig:
    """Per-arch optimizer config (moment dtype follows the memory budget)."""
    moment_dtype = (
        torch.bfloat16 if getattr(cfg, "moment_dtype", "float32") == "bfloat16"
        else torch.float32
    )
    return adamw.AdamWConfig(moment_dtype=moment_dtype)


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, *, microbatches: int = 1,
                    device=None, mesh=None) -> Callable:
    """-> step(params, opt_state, batch) -> (params, opt_state, metrics)
    with metrics = {"loss", "grad_norm"} (fp32 scalars on the device).

    The step runs on ``device`` (the CUDA card unless ``device="cpu"``):
    numpy batches are moved there; ``params`` (a ``LMParams`` or its tree)
    and ``opt_state`` must live there.  Params and moments are updated in
    place and returned (``adamw.apply``).  With a rank mesh (``mesh``
    made with ``distributed=True``) it is this rank's step of the mesh
    (``_RankTrainStep``); a logical mesh changes nothing here."""
    if mesh is not None and getattr(mesh, "distributed", False):
        return _RankTrainStep(cfg, opt_cfg, microbatches, mesh)
    fam = family_for(cfg)
    dev = resolve_device(device)

    def value_and_grad(tree, batch):
        pairs = flatten(tree)
        xs = [p.detach().requires_grad_() for _, p in pairs]
        loss = fam.loss(cfg, unflatten(zip((k for k, _ in pairs), xs)), batch)
        grads = torch.autograd.grad(loss, xs)
        return loss.detach(), unflatten(zip((k for k, _ in pairs), grads))

    def step(params, opt_state, batch):
        batch = {k: _as_tensor(v, None).to(dev) for k, v in batch.items()}
        tree = as_tree(params)
        if microbatches > 1:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(
                    f"global batch {B} not divisible by "
                    f"train_microbatches={microbatches}"
                )
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            g_sum = None
            for i in range(microbatches):
                b = {k: v.reshape(microbatches, B // microbatches, *v.shape[1:])[i]
                     for k, v in batch.items()}
                loss, g = value_and_grad(tree, b)
                if g_sum is None:
                    g_sum = [gg.to(torch.float32) for _, gg in flatten(g)]
                else:
                    for acc, (_, gg) in zip(g_sum, flatten(g)):
                        acc.add_(gg)
                del g
                loss_sum = loss_sum + loss.to(torch.float32)
            loss = loss_sum / microbatches
            grads = unflatten(
                (path, acc.div_(microbatches))
                for (path, _), acc in zip(flatten(tree), g_sum)
            )
        else:
            loss, grads = value_and_grad(tree, batch)
        params, new_state, gnorm = adamw.apply(opt_cfg, params, grads, opt_state)
        return params, new_state, {"loss": loss, "grad_norm": gnorm}

    return step


class _RankTrainStep:
    """One rank's train step on a rank mesh: the reference's GSPMD step
    (``jit`` with ``in_shardings``/``out_shardings``) written out.

    ``params`` and the moments are ``DTensor`` blocks laid out by the
    reference's specs (``sharding.place_tree``, ``adamw.init``); ``batch``
    is ``shard_batch(..., microbatches=)``'s: this rank's rows of each
    microbatch.  For each microbatch the rank runs the family's loss on
    its rows with every parameter as a ``collectives.ShardedLeaf`` (a
    weight is all-gathered where it is used, one layer at a time, and
    the MoE keeps its own experts), so ranks of one ``model`` group
    compute the same thing.  Gradients come back as blocks: summed over
    the batch axes by a reduce-scatter where the spec splits the leaf
    over them, by one all-reduce per step where it does not, never over
    an axis whose ranks computed the same rows.  Loss and gradients are
    the mean over the global batch, the gradient norm counts every
    logical element once (``adamw.apply``), and the update runs in place
    on the blocks."""

    def __init__(self, cfg, opt_cfg, microbatches: int, mesh):
        self.cfg, self.opt_cfg, self.mesh = cfg, opt_cfg, mesh
        self.microbatches = int(microbatches)
        self.fam = family_for(cfg)

    def __call__(self, params, opt_state, batch):
        from .collectives import ShardedLeaf, all_reduce
        from .sharding import (_axes, _is_dtensor, batch_axes, local,
                               placements_to_spec)

        mesh, mb = self.mesh, self.microbatches
        pairs = flatten(as_tree(params))
        for path, p in pairs:
            if not _is_dtensor(p):
                raise ValueError(f"param {path!r} is not a block of the rank mesh "
                                 "(sharding.place_tree)")
        specs = [placements_to_spec(p.placements, mesh, p.dim()) for _, p in pairs]
        B = next(iter(batch.values())).shape[0]
        if B % mb:
            raise ValueError(f"global batch {B} not divisible by "
                             f"train_microbatches={mb}")
        axes = batch_axes(mesh, B // mb) or ()
        rows = {}
        for k, v in batch.items():
            if not _is_dtensor(v):
                raise ValueError(f"input {k!r} is not this rank's rows "
                                 "(data.pipeline.shard_batch on the rank mesh)")
            if v.dim() and v.shape[0] == B:
                spec = placements_to_spec(v.placements, mesh, v.dim())
                split = _axes(spec[0]) if len(spec) else ()
                if split != tuple(axes):
                    raise ValueError(
                        f"input {k!r} is split over {split}, the step's {mb} "
                        f"microbatches over {axes}: shard_batch(..., microbatches={mb})")
            rows[k] = local(v).to(mesh.device)
        partial = tuple(a for a in axes if mesh.shape[a] > 1)
        n_shards = math.prod(mesh.shape[a] for a in axes)

        xs = [local(p).detach().requires_grad_() for _, p in pairs]
        leaves = [(path, x, spec) for (path, _), x, spec in zip(pairs, xs, specs)]
        loss_sum = torch.zeros((), dtype=torch.float32, device=mesh.device)
        g_sum = None
        for i in range(mb):
            b = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                 if v.dim() and v.shape[0] * n_shards == B else v
                 for k, v in rows.items()}
            tree = unflatten((path, ShardedLeaf(x, spec, mesh, partial))
                             for path, x, spec in leaves)
            loss = self.fam.loss(self.cfg, tree, b)
            grads = torch.autograd.grad(loss, xs)
            if g_sum is None:
                g_sum = [g.to(torch.float32) for g in grads]
            else:
                for acc, g in zip(g_sum, grads):
                    acc.add_(g)
            del grads, tree
            loss_sum = loss_sum + loss.detach().to(torch.float32)
        for acc, spec in zip(g_sum, specs):
            named = {a for e in spec for a in _axes(e)}
            all_reduce(acc, mesh, [a for a in partial if a not in named])
            acc.div_(mb * n_shards)
        loss = all_reduce(loss_sum, mesh, partial) / (mb * n_shards)
        grads = unflatten((path, acc) for (path, _), acc in zip(pairs, g_sum))
        params, new_state, gnorm = adamw.apply(self.opt_cfg, params, grads, opt_state)
        return params, new_state, {"loss": loss, "grad_norm": gnorm}


def make_prefill_step(cfg, mesh=None) -> Callable:
    """-> step(params, batch) -> (last-position logits, kv cache).  With a
    rank mesh it is this rank's step (``_RankPrefillStep``)."""
    if mesh is not None and getattr(mesh, "distributed", False):
        return _RankPrefillStep(cfg, mesh)
    fam = family_for(cfg)

    def step(params, batch):
        return fam.prefill(cfg, params, batch)

    return step


def make_decode_step(cfg, mesh=None) -> Callable:
    """-> step(params, cache, batch) -> (greedy token int32[B], cache).

    Greedy sampling stays on the device, so the serving loop moves one
    int per sequence per step off the device, not the logits.  With a
    rank mesh it is this rank's step (``_RankDecodeStep``)."""
    if mesh is not None and getattr(mesh, "distributed", False):
        return _RankDecodeStep(cfg, mesh)
    fam = family_for(cfg)

    def step(params, cache, batch):
        logits, cache = fam.decode(cfg, params, cache, batch)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return step


class _RankServeStep:
    """One rank's prefill or decode step on a rank mesh: the reference's
    compiled serving cells (prefill ``in_shardings=(param_shardings,
    input_shardings)``; decode ``(param_shardings, cache_shardings,
    input_shardings)`` -> ``(tokens over the batch axes,
    cache_shardings)``) written out.

    ``params`` are ``DTensor`` blocks (``sharding.place_tree`` by
    ``param_shardings``) and every tensor input this rank's rows
    (``data.pipeline.shard_batch``).  The family's step runs on the rows
    with every parameter split over a mesh axis of more than one rank a
    ``collectives.ShardedLeaf`` (gathered where it is used, one layer at
    a time) and every other its block, which is the whole leaf.  The
    tree is built, and the params checked, once per params object.  The
    cache is kept as its blocks, the
    rank's rows and, where ``cache_shardings`` splits a head dim over
    ``model``, its heads (``sharding.head_ranges``): attention then runs
    head-parallel (its ``wo`` products summed over ``model``), and a
    recurrent state is all-gathered over ``model`` where it is used and
    its heads kept.  Outputs are ``DTensor`` blocks: the logits and
    tokens split over the batch axes, the cache by ``cache_shardings``."""

    def __init__(self, cfg, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.fam = family_for(cfg)
        self._params, self._leaves = None, None

    def _tree(self, params):
        """-> the family's params tree of this rank's blocks (see the
        class), built when ``params`` is not the last call's."""
        if params is self._params:
            return self._leaves
        from .collectives import ShardedLeaf, _axes
        from .sharding import is_block_of, local, placements_to_spec

        def leaf(path, p):
            if not is_block_of(p, self.mesh):
                raise ValueError(f"param {path!r} is not a block of this rank mesh "
                                 "(sharding.place_tree)")
            spec = placements_to_spec(p.placements, self.mesh, p.dim())
            if all(self.mesh.shape[a] == 1 for e in spec for a in _axes(e)):
                return local(p)
            return ShardedLeaf(local(p), spec, self.mesh)

        self._leaves = unflatten((path, leaf(path, p)) for path, p in flatten(as_tree(params)))
        self._params = params
        return self._leaves

    def _rows(self, batch) -> Tuple[dict, int]:
        """-> (this rank's rows of each input, the global batch)."""
        from .sharding import _is_dtensor, local

        rows, B = {}, None
        for k, v in batch.items():
            if isinstance(v, (int, np.integer)):  # a replicated scalar (pos)
                rows[k] = v
                continue
            if not _is_dtensor(v):
                raise ValueError(f"input {k!r} is not this rank's rows "
                                 "(data.pipeline.shard_batch on the rank mesh)")
            if v.dim():
                B = v.shape[0] if B is None else B
            rows[k] = local(v).to(self.mesh.device)
        return rows, B

    def _split_rows(self, t: torch.Tensor, B: int):
        """This rank's rows ``t`` of a ``[B, ...]`` output -> a ``DTensor``
        split over the batch axes."""
        from .sharding import NamedSharding, P, batch_axes, from_block

        spec = P(batch_axes(self.mesh, B), *([None] * (t.dim() - 1)))
        return from_block(t, NamedSharding(self.mesh, spec), (B, *t.shape[1:]))

    def _blocks(self, cache, shardings, logical):
        """The family's cache (this rank's blocks as plain tensors) ->
        ``DTensor`` blocks laid out by ``shardings`` (trees of the cache's
        structure; ``logical``: tensors of the logical shapes)."""
        from .sharding import _map_with_path, from_block, local_slices

        sh = _by_path(shardings)
        full = {path: t.shape for path, t in _by_path(logical).items()}

        def block(path, t):
            want = torch.empty(full[path], device="meta")[
                local_slices(full[path], sh[path].spec, self.mesh)].shape
            if t.shape != want:
                raise ValueError(f"cache leaf {path}: block {tuple(t.shape)}, but "
                                 f"{sh[path].spec} gives {tuple(want)} of "
                                 f"{tuple(full[path])}")
            return from_block(t, sh[path], full[path])

        return _map_with_path(block, cache)


def _by_path(tree) -> dict:
    """{path: leaf} of a tree (``sharding._map_with_path``'s paths)."""
    from .sharding import _map_with_path

    out = {}
    _map_with_path(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


class _RankPrefillStep(_RankServeStep):
    """``make_prefill_step`` on a rank mesh (see ``_RankServeStep``):
    ``step(params, batch) -> (logits [B, V] split over the batch axes,
    the cache as blocks of cache_shardings(cfg, mesh, ShapeSpec(decode, B,
    cache length), cache_specs))``; the cache length is the prompt's
    (plus the VLM's patches)."""

    def __call__(self, params, batch):
        from ..configs.base import ShapeSpec
        from .sharding import cache_shardings, head_ranges

        tree = self._tree(params)
        rows, B = self._rows(batch)
        S = rows["tokens"].shape[1] + (self.cfg.n_patches
                                        if self.cfg.family == "vlm" else 0)
        shape = ShapeSpec("decode", S, B, "decode")
        c_specs = self.fam.cache_specs(self.cfg, shape)
        c_sh = cache_shardings(self.cfg, self.mesh, shape, c_specs)
        logits, cache = self.fam.prefill(self.cfg, tree, rows,
                                         heads=head_ranges(self.cfg, self.mesh, c_sh))
        return (self._split_rows(logits, B),
                self._blocks(cache, c_sh, c_specs))


class _RankDecodeStep(_RankServeStep):
    """``make_decode_step`` on a rank mesh (see ``_RankServeStep``):
    ``step(params, cache, batch) -> (greedy tokens int32[B] split over the
    batch axes, the cache)``.  The cache is the prefill's blocks, written
    in place and returned as the same layout; ``logits`` is the same step
    returning the logits [B, V] in place of the tokens."""

    def __call__(self, params, cache, batch):
        logits, cache, B = self._step(params, cache, batch)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return self._split_rows(tok, B), cache

    def logits(self, params, cache, batch):
        logits, cache, B = self._step(params, cache, batch)
        return self._split_rows(logits, B), cache

    def _step(self, params, cache, batch):
        """-> (this rank's rows of the logits, the cache as blocks, the
        global batch)."""
        from .sharding import (NamedSharding, _map_with_path, head_ranges, is_block_of,
                               local, placements_to_spec)

        tree = self._tree(params)
        rows, B = self._rows(batch)

        def sharding(path, t):
            if not is_block_of(t, self.mesh):
                raise ValueError(f"cache leaf {path} is not a block of this rank mesh "
                                 "(the rank prefill's cache)")
            return NamedSharding(self.mesh, placements_to_spec(t.placements, self.mesh,
                                                               t.dim()))

        c_sh = _map_with_path(sharding, cache)
        logits, new = self.fam.decode(
            self.cfg, tree, _map_with_path(lambda _, t: local(t), cache), rows,
            heads=head_ranges(self.cfg, self.mesh, c_sh))
        return logits, self._blocks(new, c_sh, cache), B


def _as_tensor(x, dtype) -> torch.Tensor:
    """A tensor, or an array-like -> a tensor (of ``dtype``, if given)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, dtype))


class TMTrainStep:
    """``make_tm_train_step``'s step.  ``step(state, key, xb, yb)`` takes
    and returns the canonical ``int32[M, C, 2F]`` state (on the state's
    device); ``split``/``step_slices``/``join`` keep each class slice on
    its home device between steps (the train engine's representation)."""

    def __init__(self, tm_cfg: TMConfig, mesh, batch: int):
        sizes = _axis_sizes(mesh)
        n_model = sizes.get("model", 1)
        M = tm_cfg.n_classes
        if M % n_model:
            raise ValueError(
                f"the model axis size ({n_model}) must divide n_classes={M} "
                f"for the class-sharded TM train step; pad the config or "
                f"shrink the mesh"
            )
        self.cfg, self.mesh, self.batch = tm_cfg, mesh, int(batch)
        self.n_model = n_model
        self.m_local = M // n_model
        self.shards = batch_shards(mesh, self.batch)

    def tile_device(self, coords: dict, m: int) -> torch.device:
        return self.mesh.device_at({**coords, "model": m})

    def home(self, m: int) -> torch.device:
        """The device class slice ``m`` lives on between steps (its tile
        at batch shard 0, whatever the batch)."""
        return self.mesh.device_at({"model": m})

    def split(self, state) -> Tuple[torch.Tensor, ...]:
        """Canonical state -> fresh int32 class slices on their homes."""
        state = _as_tensor(state, np.int32)
        ml = self.m_local
        return tuple(
            state[m * ml:(m + 1) * ml].to(self.home(m), torch.int32, copy=True)
            for m in range(self.n_model)
        )

    @staticmethod
    def join(slices: Sequence[torch.Tensor], device) -> torch.Tensor:
        """Class slices -> the canonical state on ``device``."""
        return torch.cat([s.to(device) for s in slices])

    def step_slices(self, slices, key, xb, yb) -> Tuple[torch.Tensor, ...]:
        """One summed-delta update of the class slices under call key
        ``key``: global sample ``i`` trains under ``fold_in(key, i)``."""
        xb, yb = _as_tensor(xb, np.uint8), _as_tensor(yb, np.int32)
        if xb.shape[0] != self.batch:
            raise ValueError(
                f"the step was built for batch {self.batch}, got {xb.shape[0]}"
            )
        B_l = self.batch // len(self.shards)
        N = self.cfg.n_states
        new = []
        for m, state_m in enumerate(slices):
            total = None
            for coords, shard in self.shards:
                d = self.tile_device(coords, m)
                rows = slice(shard * B_l, (shard + 1) * B_l)
                with _on(d):
                    keys = sample_keys(key.to(d), B_l, offset=shard * B_l)
                    delta = class_slice_delta(
                        self.cfg, state_m.to(d), m * self.m_local, keys,
                        xb[rows].to(d), yb[rows].to(d),
                    ).to(state_m.device)
                total = delta if total is None else total + delta
            new.append((state_m + total).clamp(1, 2 * N))
        return tuple(new)

    def __call__(self, state, key, xb, yb) -> torch.Tensor:
        state = _as_tensor(state, np.int32)
        return self.join(self.step_slices(self.split(state), key, xb, yb),
                         state.device)


def make_tm_train_step(tm_cfg: TMConfig, mesh, *, batch: int) -> TMTrainStep:
    """-> step(state, key, xb, yb) -> state, sharded over ``mesh``.

    ``state`` int32[M, C, 2F] shards classes over ``model``; ``xb``/``yb``
    shard their leading dim over the non-``model`` axes.  Each tile
    computes the summed-delta feedback of its batch shard restricted to
    its class rows, the deltas are summed over the batch shards, and one
    clipped update is applied.  Global sample ``i`` (its position in the
    unsharded batch) trains under ``fold_in(key, i)``, so the result
    equals ``train_batch_parallel(cfg, state, key, xb, yb)`` bit for bit
    whatever the mesh.  Raises ``ValueError`` when the ``model`` axis
    does not divide ``n_classes``."""
    return TMTrainStep(tm_cfg, mesh, batch)
