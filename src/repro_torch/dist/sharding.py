"""Device meshes of the port and its sharding rules, the port of
``repro.dist.sharding``: the single source of truth for how params,
optimizer state, activations, inputs and KV caches are laid out on a
mesh.

A ``Mesh`` is a grid of ``torch.device``s with named axes (``data``,
``model``, optionally ``pod``).  It comes in two kinds, chosen
explicitly when it is made:

* a **logical mesh** (``make_mesh(shape)``): one process drives every
  tile.  A device may appear more than once in the grid: torch has one
  CPU device, so a (2, 2) mesh on the CPU is four tiles of that one
  device (the counterpart of the reference tests' forced host devices),
  and on a single card the same mesh runs the TM's class and batch split
  on that card.  The TM executor and train step and the one-process
  expert-parallel MoE run their tiles one after another here.
* a **rank mesh** (``make_mesh(shape, distributed=True)``): one process
  per tile under ``torch.distributed`` (``launch.mesh.init_distributed``:
  NCCL on the cards, gloo when the CPU is asked for), backed by a
  ``DeviceMesh`` whose dim names are the axis names, ranks in row-major
  order.  The world size must equal the mesh's size.

    mesh = make_mesh((2, 2))                          # the card(s); raises without one
    mesh = make_mesh((2, 2), devices="cpu")           # four tiles of the CPU
    mesh = make_mesh((2, 2), distributed=True)        # four ranks, one card each

The rules keep the reference's semantics entry for entry.  The batch dim
shards over every non-``model`` axis that divides it (``batch_axes``);
weight matrices shard their largest contraction-free dim over ``model``
and (under FSDP) a second dim over ``data``; anything that does not
divide evenly stays replicated, so the rules never raise on a degenerate
mesh.  A ``PartitionSpec`` is a tuple with one entry per leading dim:
``None``, an axis name, or a tuple of names (a one-name tuple is stored
as the name, as ``jax.sharding.PartitionSpec`` stores it), and a
``NamedSharding`` pairs it with its mesh.

What a sharding places where (``place``, used by
``data.pipeline.shard_batch``, ``CheckpointManager.restore(shardings=)``,
``runtime_ft.elastic.reshard_state`` and ``launch.train``):

* on a logical mesh whose tiles are all one device, the whole logical
  tensor on that device (GSPMD's logical array, so no value changes).
  A logical mesh whose tiles lie on different cards raises
  ``NotImplementedError`` naming the leaf and its spec: one process
  does not split an LM tensor over cards; launch one process per card
  and use a rank mesh.
* on a rank mesh, this rank's block as a ``DTensor``
  (``spec_to_placements``: ``Shard(d)`` for each axis that names dim
  ``d``, ``Replicate()`` otherwise; a dim split over a tuple of axes is
  split data-major, as JAX lays it out).  The block is the one the
  reference's ``NamedSharding`` gives this mesh position.

The LM's compute on a rank mesh (``dist.steps.make_train_step``) runs
on plain local tensors, not ``DTensor`` propagation: each rank gathers a
parameter from its block where it is used (``dist.collectives``, one
layer at a time), computes on its own batch rows, and reduces the
gradients back to its blocks.  The ``model`` axis therefore shards the
state (and the MoE's experts) but not the dense products of a train
step.  The serving steps (``make_prefill_step``/``make_decode_step``
with a rank mesh) keep each decode cache as its ``cache_shardings``
blocks: attention runs head-parallel over ``model`` on the rank's heads
(``head_ranges``), a recurrent state is gathered where it is used.

``hint(x, *axes)`` computes the reference's activation spec against the
installed mesh (``hint_spec``): a ``DTensor`` activation is
redistributed to it (``with_sharding_constraint``); a plain tensor,
which every activation of the LM trunk is, comes back itself.  The
activation mesh is process-global, as in the reference:
``set_activation_mesh`` installs it, ``launch.serve.Server`` and
``launch.train.build`` install it, and the MoE FFN takes its
expert-parallel path (``models.moe.moe_ffn_ep``) while one is installed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device


def _pad_to(x: int, mult: int) -> int:
    """``x`` rounded up to a multiple of ``mult`` (``configs.base._pad_to``)."""
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array of
    ``torch.device`` whose shape is the mesh's, one name per axis.  A
    rank mesh also holds its ``DeviceMesh`` (``device_mesh``; None for a
    logical mesh)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    device_mesh: Any = None

    @property
    def distributed(self) -> bool:
        """True for a rank mesh (one process per tile)."""
        return self.device_mesh is not None

    @property
    def coords(self) -> dict:
        """This rank's coordinates, axis name -> index (a rank mesh)."""
        self._need_ranks("coords")
        return dict(zip(self.axis_names, self.device_mesh.get_coordinate()))

    @property
    def device(self) -> torch.device:
        """This rank's device (a rank mesh)."""
        self._need_ranks("device")
        return self.devices[tuple(self.device_mesh.get_coordinate())]

    def group(self, axis: str):
        """The process group of ``axis`` through this rank (a rank mesh)."""
        self._need_ranks("group")
        return self.device_mesh.get_group(axis)

    def _need_ranks(self, what: str) -> None:
        if self.device_mesh is None:
            raise ValueError(f"{what} is defined on a rank mesh only "
                             "(make_mesh(..., distributed=True))")

    @property
    def shape(self) -> dict:
        """axis name -> size (as the reference mesh's ``shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        """Where results of a sharded call are assembled (this rank's
        device on a rank mesh)."""
        return self.device if self.distributed else self.devices.flat[0]

    def device_at(self, coords: dict) -> torch.device:
        """The device at the named coordinates; unnamed axes take 0."""
        return self.devices[tuple(coords.get(a, 0) for a in self.axis_names)]

    def __repr__(self) -> str:
        kind = ", ranks" if self.distributed else ""
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})}{kind})"


def make_mesh(
    shape: Sequence[int],
    axis_names: Sequence[str] = ("data", "model"),
    devices=None,
    *,
    distributed: bool = False,
) -> Mesh:
    """A mesh of ``shape`` with ``axis_names``.

    Logical (``distributed=False``): ``devices`` is ``None`` (the CUDA
    cards, tile ``i`` on card ``i % device_count()``; raises without a
    card), one device for every tile (``"cpu"``, ``"cuda:0"``, a
    ``torch.device``), or one device per tile in row-major order.

    Rank mesh (``distributed=True``): one process per tile, rank ``r``
    at row-major position ``r``, under the process group that
    ``launch.mesh.init_distributed`` started (raises without one, or when
    its world size is not the mesh's size).  ``devices`` is ``None``
    (this rank's card, under NCCL) or ``"cpu"`` (under gloo); a backend
    that does not match the device raises."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axis names repeat: {axis_names}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    n = int(np.prod(shape))
    if distributed:
        return _rank_mesh(shape, axis_names, devices)
    if devices is None:
        first = resolve_device(None)  # raises without a card
        count = torch.cuda.device_count()
        flat = [torch.device("cuda", (first.index + i) % count) for i in range(n)]
    elif isinstance(devices, (str, torch.device)):
        flat = [resolve_device(devices)] * n
    else:
        flat = [resolve_device(d) for d in np.asarray(devices, dtype=object).flat]
        if len(flat) != n:
            raise ValueError(f"{len(flat)} devices for a mesh of {n} tiles")
    grid = np.empty(n, dtype=object)
    grid[:] = flat
    return Mesh(grid.reshape(shape), axis_names)


def _rank_mesh(shape, axis_names, devices) -> Mesh:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = int(np.prod(shape))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a rank mesh {shape} needs a torch.distributed process group: launch "
            f"one process per device (python -m torch.distributed.run "
            f"--nproc-per-node {n} ...) and call launch.mesh.init_distributed()"
        )
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"the mesh {dict(zip(axis_names, shape))} has {n} tiles but "
                         f"the process group's world size is {world}")
    if devices is not None and not isinstance(devices, (str, torch.device)):
        raise ValueError("a rank mesh takes one device kind ('cpu' or the cards), "
                         f"not a list of devices: {devices!r}")
    dev = resolve_device(devices)  # None: this rank's card; raises without one
    backend = dist.get_backend()
    want = "gloo" if dev.type == "cpu" else "nccl"
    if backend != want:
        raise ValueError(f"a rank mesh on {dev.type} runs under {want}, but the "
                         f"process group's backend is {backend}")
    dm = init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axis_names))
    grid = np.empty(n, dtype=object)
    if dev.type == "cpu":
        grid[:] = [dev] * n
    else:
        per_host = torch.cuda.device_count()
        grid[:] = [torch.device("cuda", r % per_host) for r in range(n)]
        grid[dist.get_rank()] = dev
    mesh = Mesh(grid.reshape(shape), tuple(axis_names), dm)
    _MESH_OF[id(dm)] = (dm, mesh)
    return mesh


# DeviceMesh -> the rank Mesh made on it (``mesh_of``)
_MESH_OF: Dict[int, Tuple[Any, Mesh]] = {}


def mesh_of(dt) -> Mesh:
    """The rank ``Mesh`` a ``DTensor`` (from ``place``) lives on."""
    entry = _MESH_OF.get(id(dt.device_mesh))
    if entry is None or entry[0] is not dt.device_mesh:
        raise ValueError("this DTensor's DeviceMesh was not made by make_mesh")
    return entry[1]


def _axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def batch_axes(mesh, B: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes the batch dim shards over, major-to-minor.

    Every non-``model`` axis is taken in mesh order while the running
    product still divides ``B`` — so a (pod, data, model) mesh yields
    ("pod", "data"), a (data, model) mesh yields ("data",), and a batch
    too small for the leading axis stays replicated (None)."""
    sizes = _axis_sizes(mesh)
    chosen = []
    prod = 1
    for name in mesh.axis_names:
        if name == "model":
            continue
        if B % (prod * sizes[name]) == 0:
            chosen.append(name)
            prod *= sizes[name]
        else:
            break
    return tuple(chosen) if chosen else None


def batch_shards(mesh, B: int) -> Tuple[Tuple[dict, int], ...]:
    """((coords of the batch axes, linear shard index), ...) for every
    batch shard of a ``B``-row batch, the index major-to-minor over
    ``batch_axes`` in mesh order (one shard at index 0 when the batch is
    replicated)."""
    bx = batch_axes(mesh, B) or ()
    sizes = _axis_sizes(mesh)
    shards = []
    for i, flat in enumerate(np.ndindex(*(sizes[a] for a in bx))):
        shards.append((dict(zip(bx, flat)), i))
    return tuple(shards)


# ---------------------------------------------------------------------------
# specs, the activation mesh and hints
# ---------------------------------------------------------------------------

def _canon(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if len(entry) == 0:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """One entry per leading dim: ``None`` (replicated), a mesh axis
    name, or a tuple of names (the dim split over their product).  A
    one-name tuple is stored as the name and an empty one as ``None``,
    as ``jax.sharding.PartitionSpec`` stores them."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec


# Installed by set_activation_mesh; read by hint() and the MoE EP gate.
_ACTIVATION_MESH = None


def set_activation_mesh(mesh) -> None:
    """Install (or clear, with None) the mesh used by activation hints."""
    global _ACTIVATION_MESH
    _ACTIVATION_MESH = mesh


def activation_mesh():
    """The installed activation mesh, or None."""
    return _ACTIVATION_MESH


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def hint_spec(x, *axes) -> Optional[PartitionSpec]:
    """The reference's ``hint`` spec for ``x`` on the installed mesh: one
    entry per leading dim, "batch" (shard over batch_axes), a mesh axis
    name, or None; a dim the axis does not divide stays None.  None when
    no activation mesh is installed."""
    mesh = _ACTIVATION_MESH
    if mesh is None:
        return None
    sizes = _axis_sizes(mesh)
    spec = []
    for d, a in enumerate(axes):
        if a is None:
            spec.append(None)
        elif a == "batch":
            spec.append(batch_axes(mesh, x.shape[d]))
        elif a in sizes and x.shape[d] % sizes[a] == 0:
            spec.append(a)
        else:
            spec.append(None)
    return P(*spec)


def hint(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's activation layout (``hint_spec``): a ``DTensor``
    is redistributed to it (``with_sharding_constraint``); a plain
    tensor (every activation of the LM trunk, which computes on local
    tensors) comes back itself."""
    spec = hint_spec(x, *axes)
    if spec is not None and _is_dtensor(x):
        return x.redistribute(x.device_mesh, spec_to_placements(spec, mesh_of(x)))
    return x


# ---------------------------------------------------------------------------
# parameter, optimizer, input and cache shardings
# ---------------------------------------------------------------------------

def _map_with_path(fn: Callable, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, namedtuples, lists and
    tuples (an ``nn.Module`` as its parameter dict; ``None`` stays
    None); ``path`` holds dict keys, field names and indices."""
    from ..tree import as_tree

    if isinstance(tree, nn.Module):
        tree = as_tree(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def map_leaves(fn: Callable, tree):
    """``fn`` over every leaf of a tree (the kinds ``_map_with_path``
    walks), the structure kept."""
    return _map_with_path(lambda _, leaf: fn(leaf), tree)


def _param_rule(cfg, mesh, path, leaf) -> Tuple[PartitionSpec, str]:
    """(PartitionSpec, pattern) of one param leaf; the pattern names the
    rule that gave the spec ("vector", "embed", "router", "attn_dp",
    "expert", "matrix") and decides its collectives
    (``spec_collective_bytes``).

    Rules (checked in this order):
      * scalars / vectors (norm scales)            -> replicated
      * embedding [V, D]                           -> vocab over model
                                                      (+ D over data if fsdp)
      * router [D, E]                              -> replicated (fp32, tiny)
      * MoE expert stacks [L, E, D, F]             -> experts over model (EP)
      * attention weights with cfg.attn_tp=False   -> replicated (pure DP)
      * other matrices: largest non-stack dim over model; under FSDP the
        largest remaining dim over data.  A dim is only assigned an axis
        it divides evenly; otherwise it stays replicated.
    """
    sizes = _axis_sizes(mesh)
    n_model = sizes.get("model", 1)
    n_data = sizes.get("data", 1)
    names = [str(p) for p in path]
    shape = leaf.shape
    spec = [None] * len(shape)

    if len(shape) <= 1:
        return P(), "vector"

    if "embed" in names:
        if "model" in sizes and shape[0] % n_model == 0:
            spec[0] = "model"
        if cfg.fsdp and "data" in sizes and shape[1] % n_data == 0:
            spec[1] = "data"
        return P(*spec), "embed"

    if "router" in names:
        return P(*spec), "router"

    is_attn = any(n in ("attn", "wq", "wk", "wv", "wo", "self_attn",
                        "cross_attn") for n in names)
    if is_attn and not cfg.attn_tp:
        return P(*spec), "attn_dp"

    is_expert = cfg.is_moe and any(
        n in ("w_gate", "w_up", "w_down") for n in names
    ) and "moe" in names
    if is_expert:
        # [L, E, D, F] (stacked) or [E, D, F]: shard the expert dim
        e_dim = 1 if len(shape) == 4 else 0
        if "model" in sizes and shape[e_dim] % n_model == 0:
            spec[e_dim] = "model"
        return P(*spec), "expert"

    # generic matrix: dims after the leading stack dim are candidates;
    # for unstacked 2-D weights all dims are candidates.
    cand = list(range(1, len(shape))) if len(shape) >= 3 else list(range(len(shape)))
    by_size = sorted(cand, key=lambda d: shape[d], reverse=True)
    for d in by_size:
        if "model" in sizes and shape[d] % n_model == 0:
            spec[d] = "model"
            break
    if cfg.fsdp and "data" in sizes:
        for d in by_size:
            if spec[d] is None and shape[d] % n_data == 0:
                spec[d] = "data"
                break
    return P(*spec), "matrix"


def param_shardings(cfg, mesh, specs) -> Any:
    """Param-spec tree (or an ``LMParams``) -> a tree of ``NamedSharding``
    of the same structure (an ``LMParams`` as its dict)."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, _param_rule(cfg, mesh, path, leaf)[0]),
        specs,
    )


def opt_shardings(cfg, mesh, o_specs, p_sh) -> Any:
    """AdamW state shards exactly like the params; step is replicated."""
    from ..optim.adamw import AdamWState

    return AdamWState(step=replicated(mesh), m=p_sh, v=p_sh)


def input_shardings(cfg, mesh, shape, in_specs) -> Any:
    """Batch-leading inputs shard over the batch axes; scalars replicate."""
    bx = batch_axes(mesh, shape.global_batch)

    def rule(leaf):
        if leaf.dim() >= 1 and leaf.shape[0] == shape.global_batch:
            return NamedSharding(mesh, P(bx, *([None] * (leaf.dim() - 1))))
        return replicated(mesh)

    return map_leaves(rule, in_specs)


def _cache_head_sizes(cfg) -> set:
    """Every head count a decode-cache dim of this config might carry:
    attention heads (q and kv) plus, for the SSM/recurrent families, the
    SSM head count (xLSTM's mLSTM head count IS ``n_heads``)."""
    heads = set()
    for attr in ("n_heads", "n_kv_heads"):
        v = getattr(cfg, attr, None)
        if v:
            heads.add(int(v))
    if getattr(cfg, "family", "") in ("ssm_xlstm", "hybrid"):
        from ..models.ssm import ssm_dims  # deferred: models import dist

        heads.add(ssm_dims(cfg)[1])
    return heads


def cache_shardings(cfg, mesh, shape, c_specs) -> Any:
    """Decode caches shard their batch dim over the batch axes and their
    HEAD dim over model -- for every cache family, not just attention KV:

      KV          [L, B, S, H, hd]       head at dim 3
      SSM conv    [L, B, K-1, d_conv]    batch only (channel mix, no heads)
      SSM state   [L, B, H, N, P]        head at dim 2
      hybrid SSM  [G, E, B, H, N, P]     batch at dim 2, head at dim 3
      mLSTM C/n/m [P, B, H, hd, hd] / [P, B, H, hd] / [P, B, H]
                                         head at dim 2
      sLSTM       [P, B, D]              batch only (fused per-channel)

    The head dim is recognized by its SIZE (one of the config's head
    counts, see ``_cache_head_sizes``): the first such dim after the
    batch dim takes "model", except the KV convention [stack, B, S, H,
    hd] which pins dim 3 so a window length colliding with a head count
    cannot steal the assignment.  The pin checks the shape signature,
    not just rank: the mLSTM C cache [P, B, H, hd, hd] is also 5-D and
    its per-head feature dim 3 coincides with a head count whenever
    hd == H -- a square trailing [hd, hd] with a head count at dim 2 is
    recognized as that matrix-memory signature and falls through to the
    generic first-head-after-batch rule (dim 2).  Dims that don't divide
    the axis stay replicated, as everywhere in this module."""
    sizes = _axis_sizes(mesh)
    n_model = sizes.get("model", 1)
    bx = batch_axes(mesh, shape.global_batch)
    heads = _cache_head_sizes(cfg)

    def rule(leaf):
        ndim = leaf.dim()
        spec = [None] * ndim
        # caches are [stack, B, ...] (dim 1), prefill-less [B, ...], or
        # double-stacked hybrid groups [G, E, B, ...] (dim 2)
        b_dim = next(
            (d for d in (1, 0, 2) if d < ndim and leaf.shape[d] == shape.global_batch),
            None,
        )
        if b_dim is not None:
            spec[b_dim] = bx
        if "model" in sizes:
            def head_at(d):
                return leaf.shape[d] in heads and leaf.shape[d] % n_model == 0

            is_mlstm_c = (
                ndim == 5
                and leaf.shape[3] == leaf.shape[4]
                and leaf.shape[2] in heads
            )
            if ndim == 5 and b_dim == 1 and head_at(3) and not is_mlstm_c:
                spec[3] = "model"  # the KV [L, B, S, H, hd] convention
            else:
                for d in range((b_dim if b_dim is not None else -1) + 1, ndim):
                    if spec[d] is None and head_at(d):
                        spec[d] = "model"
                        break
        return NamedSharding(mesh, P(*spec))

    return map_leaves(rule, c_specs)


@dataclasses.dataclass(frozen=True)
class HeadRanges:
    """This rank's heads of a decode cache that ``cache_shardings`` splits
    over ``model`` on a rank mesh (``head_ranges``).  ``q`` and ``kv`` are
    its query and KV heads (its KV-cache block's heads, and the query
    heads of their GQA groups), ``state`` its heads of a recurrent state
    (the SSM's or the mLSTM's); each is None where that head dim is
    replicated."""

    mesh: Any
    q: Optional[slice] = None
    kv: Optional[slice] = None
    state: Optional[slice] = None


def head_ranges(cfg, mesh, c_sh) -> Optional[HeadRanges]:
    """The rank's head ranges from ``c_sh``, the cache's shardings
    (``cache_shardings``' tree, or the same specs read off its blocks):
    a range for each head dim a spec splits over ``model``, None for one
    it leaves replicated.  The KV head dim is dim 3 of the KV leaves
    ([stack, B, S, H, hd]: ``k`` of the dict families, Zamba2's ring
    buffer); the state's is the mLSTM ``C``'s dim 2 ([P, B, H, hd, hd])
    and the SSM state's dim 3 ([G, E, B, H, N, P]).  None off a rank
    mesh, with one ``model`` rank, or when nothing is split."""
    if not getattr(mesh, "distributed", False) or mesh.shape.get("model", 1) == 1:
        return None
    n, m = mesh.shape["model"], mesh.coords["model"]
    if cfg.family == "ssm_xlstm":
        kv, state = None, (c_sh[0][0], 2, cfg.n_heads)
    elif cfg.family == "hybrid":
        from ..models.ssm import ssm_dims  # deferred: models import dist

        kv, state = c_sh[1][0], (c_sh[0][1], 3, ssm_dims(cfg)[1])
    else:
        kv, state = c_sh["k"], None

    def split(sh, dim):
        return dim < len(sh.spec) and "model" in _axes(sh.spec[dim])

    def own(count):
        return slice(m * count // n, (m + 1) * count // n)

    out = HeadRanges(mesh)
    if kv is not None and split(kv, 3):
        out = dataclasses.replace(out, q=own(cfg.n_heads), kv=own(cfg.n_kv_heads))
    if state is not None and split(state[0], state[1]):
        out = dataclasses.replace(out, state=own(state[2]))
    return out if (out.kv or out.state) is not None else None


# ---------------------------------------------------------------------------
# the collectives a step's shardings imply
# ---------------------------------------------------------------------------

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                    "collective-permute")
# leading layer-stack dims of a parameter leaf, by its top-level key
_STACK_DIMS = {"layers": 1, "pairs": 1, "encoder": 1, "decoder": 1, "mamba": 2}
_TRAIN_PASSES = 3  # forward, the checkpointed layer's recompute, backward


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def spec_collective_bytes(cfg, shape, mesh, specs) -> Dict[str, float]:
    """Per-device collective operand bytes of one step, per kind of
    ``COLLECTIVE_KINDS``, from the spec and pattern ``_param_rule`` gives
    each parameter leaf (the port has no post-partitioning HLO).

    ``specs`` holds the step's spec trees: ``"params"`` (the family's
    ``param_specs``) and ``"inputs"`` (``input_specs``, sharded by
    ``input_shardings``).  Weights are ``[..., in, out]``; a leaf under
    ``layers``, ``pairs``, ``encoder`` or ``decoder`` has one leading
    stack dim, under ``mamba`` two; the ``shared`` block is applied once
    per group.  One rule per sharding pattern, per leaf:

    * a dim over ``data`` (FSDP, patterns "embed" and "matrix"): an
      all-gather of the leaf's shard before each use -- once per step,
      and in a train step once per microbatch in the forward and again in
      the checkpointed recompute -- and in a train step a reduce-scatter
      of its gradient (operand: the leaf sharded over its other axes)
      once per microbatch;
    * the contraction dim (``-2``) over ``model`` (a row-parallel
      product; the embedding's vocab, whose lookup sums partial rows):
      an all-reduce over ``model`` of the product's output, tokens of
      the device's batch shard x the output features, in the leaf's
      dtype; a train step pays it in the forward, the recompute and the
      backward (Megatron's pair of all-reduces per parallel block);
    * pattern "expert" with its expert dim over ``model`` (the EP MoE,
      ``models.moe.moe_ffn_ep``): the ``psum`` over ``model`` of each
      MoE layer's output ``[tokens, D]`` (counted on ``w_down``), as
      often as the previous rule;
    * in a train step, the gradient of every leaf all-reduced over the
      batch axes its spec does not shard (data parallelism), once per
      microbatch (after the reduce-scatter for an FSDP leaf).

    Tokens are ``global_batch x seq_len`` (``global_batch`` in decode),
    ``encoder_len`` per sequence for Whisper's encoder and cross-attention
    keys and values (not run in decode), ``n_patches`` for the VLM's
    patch projection, over the batch shards.  A replicated leaf
    ("vector", "router", "attn_dp"), a column-parallel product (output
    features over ``model``) and the optimizer update (sharded like the
    params) cost nothing here; so do the scalar reductions of the loss
    and the gradient norm, and any axis of size 1.  It is an estimate of
    what GSPMD emits, not a count of a compiled program: no all-to-all or
    collective-permute is modelled."""
    from ..tree import flatten

    sizes = _axis_sizes(mesh)
    train = shape.kind == "train"
    mb = max(int(getattr(cfg, "train_microbatches", 1)), 1) if train else 1
    passes = _TRAIN_PASSES if train else 1
    B = shape.global_batch
    in_sh = flatten(input_shardings(cfg, mesh, shape, specs["inputs"]))
    b_axes = next((_axes(s.spec[0]) for _, s in in_sh if len(s.spec) and s.spec[0]), ())
    n_batch = math.prod(sizes[a] for a in b_axes)
    b_axes = [a for a in b_axes if sizes[a] > 1]
    groups = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 1

    def tokens(path) -> float:
        top = path.split(".")[0]
        cross = top == "encoder" or "cross_attn.wk" in path or "cross_attn.wv" in path
        if shape.kind == "decode":
            return 0.0 if cross else B / n_batch
        if cross:
            return B * cfg.encoder_len / n_batch
        if top == "patch_proj":
            return B * cfg.n_patches / n_batch
        return B * shape.seq_len / n_batch

    out = {k: 0.0 for k in COLLECTIVE_KINDS}
    for path, leaf in flatten(specs["params"]):
        spec, pattern = _param_rule(cfg, mesh, tuple(path.split(".")), leaf)
        names = [a for e in spec for a in _axes(e)]
        itemsize = leaf.element_size()
        shard = leaf.numel() * itemsize / math.prod(sizes[a] for a in names)
        names = [a for a in names if sizes[a] > 1]  # an axis of one moves nothing
        top = path.split(".")[0]
        n_stack = _STACK_DIMS.get(top, 0)
        apps = math.prod(leaf.shape[:n_stack]) * (groups if top == "shared" else 1)
        body = leaf.shape[n_stack:]
        if "data" in names:
            out["all-gather"] += shard * (2 * mb if train else 1)
            if train:
                out["reduce-scatter"] += shard * sizes["data"] * mb
        if pattern == "expert":
            if path.endswith("w_down") and "model" in names:
                out["all-reduce"] += tokens(path) * body[-1] * itemsize * apps * passes
        elif len(body) >= 2 and "model" in names and "model" in _axes(spec[-2]):
            per_token = math.prod(body) // body[-2]
            out["all-reduce"] += tokens(path) * per_token * itemsize * apps * passes
        if train and [a for a in b_axes if a not in names]:
            out["all-reduce"] += shard * mb
    return out


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def mesh_device(mesh, what: str = "a tensor") -> torch.device:
    """This rank's device on a rank mesh; on a logical mesh, the one
    device every tile is on.  A logical mesh over several devices raises
    ``NotImplementedError``: one process keeps every LM tensor whole on
    one device."""
    if getattr(mesh, "distributed", False):
        return mesh.device
    devices = {str(d) for d in mesh.devices.flat}
    if len(devices) != 1:
        n = mesh.devices.size
        raise NotImplementedError(
            f"{what} on a mesh of {sorted(devices)}: one process keeps LM tensors "
            "whole on one device.  To split them over cards, launch one "
            f"process per card (python -m torch.distributed.run --nproc-per-node {n} "
            "...) and build a rank mesh with make_mesh(..., distributed=True)"
        )
    return mesh.devices.flat[0]


def _check_spec(shape, spec, mesh, name: str) -> None:
    sizes = _axis_sizes(mesh)
    if len(spec) > len(shape):
        raise ValueError(f"leaf {name!r}: spec {spec} has more entries than {tuple(shape)}")
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n = 1
        for a in axes:
            if a not in sizes:
                raise ValueError(f"leaf {name!r}: spec {spec} names no axis {a!r} "
                                 f"of the mesh {tuple(mesh.axis_names)}")
            n *= sizes[a]
        if shape[d] % n:
            raise ValueError(f"leaf {name!r}: spec {spec} splits dim {d} of "
                             f"{tuple(shape)} {n} ways")


def _dtensor_api():
    try:
        from torch.distributed.tensor import DTensor, Replicate, Shard
    except ImportError:  # torch < 2.4
        from torch.distributed._tensor import DTensor, Replicate, Shard
    return DTensor, Replicate, Shard


def _is_dtensor(x) -> bool:
    return isinstance(x, torch.Tensor) and isinstance(x, _dtensor_api()[0])


def is_block_of(x, mesh) -> bool:
    """Whether ``x`` is a ``DTensor`` block of the rank mesh ``mesh``.
    DTensor may hand a tensor an equal ``DeviceMesh`` made earlier in the
    process in place of ``mesh``'s own, so meshes compare equal, not
    identical."""
    return _is_dtensor(x) and x.device_mesh == mesh.device_mesh


def local(x):
    """A ``DTensor``'s block on this rank (a view of its storage); any
    other value itself."""
    return x.to_local() if _is_dtensor(x) else x


def spec_to_placements(spec, mesh) -> list:
    """One placement per mesh axis: ``Shard(d)`` where the axis names dim
    ``d`` of ``spec``, ``Replicate()`` otherwise.  A dim split over a
    tuple of axes must name them in mesh order, so that ``DTensor``'s
    left-to-right split is the data-major split JAX makes."""
    _, Replicate, Shard = _dtensor_api()
    where = {}
    for d, entry in enumerate(spec):
        names = _axes(entry)
        order = [mesh.axis_names.index(a) for a in names]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {d} names {names} out of the mesh's "
                             f"order {tuple(mesh.axis_names)}")
        for a in names:
            if a in where:
                raise ValueError(f"spec {spec} names axis {a!r} twice")
            where[a] = d
    return [Shard(where[a]) if a in where else Replicate() for a in mesh.axis_names]


def placements_to_spec(placements, mesh, ndim: int) -> PartitionSpec:
    """The ``PartitionSpec`` of ``placements`` on ``mesh`` (the inverse
    of ``spec_to_placements``)."""
    entries = [[] for _ in range(ndim)]
    for a, pl in zip(mesh.axis_names, placements):
        if pl.is_shard():
            entries[pl.dim].append(a)
        elif not pl.is_replicate():
            raise ValueError(f"placement {pl} on axis {a!r} is neither Shard nor Replicate")
    while entries and not entries[-1]:
        entries.pop()
    return P(*(tuple(e) if e else None for e in entries))


def local_slices(shape, spec, mesh) -> Tuple[slice, ...]:
    """The slices of a ``shape`` tensor that ``spec`` assigns this rank
    of the rank mesh ``mesh``: along a dim split over axes ``(a1, a2,
    ...)``, block ``((i1 * n2) + i2) ...`` of ``n1 * n2 * ...`` (row-major
    over the axes, as JAX numbers a tuple's blocks)."""
    coords, sizes = mesh.coords, _axis_sizes(mesh)
    out = []
    for d, size in enumerate(shape):
        names = _axes(spec[d]) if d < len(spec) else ()
        idx, n = 0, 1
        for a in names:
            idx = idx * sizes[a] + coords[a]
            n *= sizes[a]
        step = size // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def from_block(block: torch.Tensor, sharding: NamedSharding, shape) -> Any:
    """This rank's ``block`` of a ``shape`` tensor laid out by
    ``sharding`` (on a rank mesh) as a ``DTensor``."""
    DTensor, _, _ = _dtensor_api()
    mesh = sharding.mesh
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(block, mesh.device_mesh,
                              spec_to_placements(sharding.spec, mesh),
                              run_check=False, shape=shape, stride=stride)


def place(x, sharding: NamedSharding, name: str = ""):
    """``x`` (a tensor, numpy array or scalar) laid out by ``sharding``.
    On a rank mesh, this rank's block as a ``DTensor`` on its device; on
    a logical mesh, the whole logical tensor on the mesh's device, which
    must be the same for every tile (see the module docstring)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    _check_spec(t.shape, sharding.spec, sharding.mesh, name)
    mesh = sharding.mesh
    if getattr(mesh, "distributed", False):
        block = t[local_slices(t.shape, sharding.spec, mesh)]
        # a block of its own, not a view that keeps the whole alive
        block = block.to(mesh.device, copy=block.shape != t.shape)
        return from_block(block.contiguous(), sharding, t.shape)
    dev = resolve_device(mesh_device(mesh, f"leaf {name!r} with spec {sharding.spec}"))
    return t.to(dev)


def place_tree(tree, shardings):
    """Every leaf of ``tree`` placed by the matching ``NamedSharding`` of
    ``shardings`` (the same structure; an ``LMParams`` comes back as an
    ``LMParams`` over the placed tree)."""
    from ..models.common import LMParams
    from ..tree import as_tree, flatten, unflatten

    sh = dict(flatten(as_tree(shardings)))
    placed = unflatten((path, place(leaf, sh[path], path))
                       for path, leaf in flatten(as_tree(tree)))
    return LMParams(tree.cfg, placed) if isinstance(tree, LMParams) else placed
