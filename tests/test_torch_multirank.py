"""The LM train path on a rank mesh: four gloo ranks on the CPU, one
process per tile of a (2, 2) ``(data, model)`` mesh, against the
reference and against the port's one-process runs.

One 4-rank group (``torch.multiprocessing.spawn``, a ``file://`` store)
runs every scenario of this file in a module-scoped fixture and hands
each rank's results to the tests; the reference (JAX) and the port's
one-process runs are computed here, in the test process.  Parameters are
fp32 of std 0.3 from numpy unless a test says otherwise.

Tolerances: placement and bytes exact; train steps within 1e-4
relative of the reference's ``launch.train.build`` on a (1, 1)
``AxisType.Auto`` mesh (loss, grad norm) and final params within
1e-5 x max |p| of the port's own (1, 1) run; the MoE within 1e-6
relative of the port's one-process (2, 2) run (loss, grad norm, one
layer's output and gradients, the expert leaves; the other leaves as
the dense trunk, 1e-5 x max |p|: their Adam updates in the eps region
follow the data-parallel sum's rounding); ``compressed_psum``'s group
form bit-equal to its list form; the grad norm within 1e-6 relative.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.pipeline import (TokenStream, TokenStreamConfig, batch_rows,
                                       shard_batch)
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.launch import train
from repro_torch.launch.mesh import init_distributed
from repro_torch.models import api, moe
from repro_torch.optim import adamw
from repro_torch.optim.compress import GradCompressor, compressed_psum
from repro_torch.tree import as_tree, flatten, unflatten

WORLD, MESH = 4, (2, 2)
PLACE_ARCHS = ["stablelm-3b-smoke", "moonshot-v1-16b-a3b-smoke"]
BYTES_ARCHS = ["stablelm-3b-smoke", "moonshot-v1-16b-a3b-smoke", "internvl2-26b-smoke",
               "xlstm-125m-smoke", "zamba2-2.7b-smoke", "whisper-medium-smoke"]
# (arch, batch, seq, steps): stablelm at the CLI's batch 4 (each of its 4
# microbatches one row, so replicated over data) and at 8 (split over
# data); the other families at two rows per microbatch
TRAIN = [("stablelm-3b-smoke", 4, 32, 3), ("stablelm-3b-smoke", 8, 32, 3),
         ("xlstm-125m-smoke", 4, 16, 1), ("zamba2-2.7b-smoke", 8, 16, 1),
         ("internvl2-26b-smoke", 16, 16, 1), ("whisper-medium-smoke", 8, 16, 1)]
MOE = ("moonshot-v1-16b-a3b-smoke", 16, 16, 3)


def np_params(cfg, seed, std=0.3):
    rng = np.random.default_rng(seed)
    return unflatten((p, (rng.normal(size=s.shape) * std).astype(np.float32))
                     for p, s in flatten(api.abstract_params(cfg)))


def batches(cfg, B, seq, steps):
    """Each step's numpy batch with the inputs ``input_specs`` names."""
    stream = TokenStream(TokenStreamConfig(cfg.vocab, seq, B))
    rng = np.random.default_rng(5)
    out = []
    for _ in range(steps):
        b = stream.next_batch()
        if cfg.family == "vlm":
            b = {"patches": rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(
                np.float32), "tokens": b["tokens"][:, : seq - cfg.n_patches]}
        if cfg.family == "encdec":
            b["frames"] = rng.normal(size=(B, cfg.encoder_len, cfg.d_model)).astype(
                np.float32)
        out.append(b)
    return out


def moments(cfg, seed):
    rng = np.random.default_rng(seed)
    tree = api.abstract_params(cfg)
    return (unflatten((p, rng.normal(size=s.shape).astype(np.float32))
                      for p, s in flatten(tree)),
            unflatten((p, rng.random(size=s.shape).astype(np.float32))
                      for p, s in flatten(tree)))


def run_train(arch, B, seq, steps, mesh):
    """``steps`` of ``launch.train.build``'s step on ``mesh`` from
    ``np_params(cfg, 8)`` -> ([(loss, grad norm)], final params as numpy
    (gathered on a rank mesh; None on ranks other than 0))."""
    cfg = get(arch)
    step, p_sh, _, in_sh, opt_cfg, _ = train.build(cfg, mesh, seq=seq, batch=B)
    params = lm_params_from_numpy(cfg, np_params(cfg, 8), device="cpu")
    if mesh.distributed:
        params = shd.place_tree(params, p_sh)
    state = adamw.init(opt_cfg, params)
    metrics = []
    for b in batches(cfg, B, seq, steps):
        params, state, m = step(params, state, shard_batch(
            b, mesh, in_sh, microbatches=cfg.train_microbatches))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    shd.set_activation_mesh(None)
    full = {}
    for p, t in flatten(as_tree(params)):
        t = collectives.gather_full(t) if mesh.distributed else t
        full[p] = t.detach().numpy().copy()
    if mesh.distributed and torch.distributed.get_rank() != 0:
        full = None
    return metrics, full


def moe_layer(mesh):
    """One moonshot MoE layer (layer 0's weights) on x [4, 16, D]: its
    output and the gradients of x and of the MoE leaves (on a rank mesh:
    this rank's rows of x, the leaves' gradients summed and gathered)."""
    cfg = get(MOE[0])
    whole = {k: torch.from_numpy(v[0].copy())
             for k, v in np_params(cfg, 8)["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 16, cfg.d_model)).astype(np.float32))
    if mesh.distributed:  # this rank's rows and blocks
        x = x[batch_rows(mesh, 4)[1]]
        p_sh = shd.param_shardings(cfg, mesh, api.family_for(cfg).param_specs(cfg))
        specs = {k: p_sh["layers"]["moe"][k].spec[1:] for k in whole}
        axes = tuple(a for a in shd.batch_axes(mesh, 4) or () if mesh.shape[a] > 1)
        wrt = {k: w[shd.local_slices(w.shape, specs[k], mesh)].clone().requires_grad_()
               for k, w in whole.items()}
        params = {k: collectives.ShardedLeaf(w, specs[k], mesh, axes)
                  for k, w in wrt.items()}
    else:
        wrt = params = {k: w.requires_grad_() for k, w in whole.items()}
    x = x.requires_grad_()
    shd.set_activation_mesh(mesh)
    try:
        y = moe.moe_ffn(params, x, cfg)
        grads = torch.autograd.grad(torch.sum(torch.sin(y)), [x, *wrt.values()])
    finally:
        shd.set_activation_mesh(None)
    out = {"y": y.detach(), "dx": grads[0]}
    for k, g in zip(wrt, grads[1:]):
        if mesh.distributed:
            names = [a for e in specs[k] for a in collectives._axes(e)]
            g = collectives.all_reduce(g.clone(), mesh, [a for a in axes if a not in names])
            for d, entry in enumerate(specs[k]):
                for a in reversed(collectives._axes(entry)):
                    g = collectives.all_gather(g, mesh, a, d)
        out["d" + k] = g.detach()
    return out


# ---------------------------------------------------------------------------
# the scenarios, on every rank of one 4-rank group
# ---------------------------------------------------------------------------

def _placement(mesh):
    out = {}
    for arch in PLACE_ARCHS:
        cfg = get(arch)
        p_sh = shd.param_shardings(cfg, mesh, api.family_for(cfg).param_specs(cfg))
        params = shd.place_tree(api.family_for(cfg).init_params(cfg, 0, device="cpu"), p_sh)
        m, v = moments(cfg, 1)
        m, v = shd.place_tree(m, p_sh), shd.place_tree(v, p_sh)
        out[arch] = {"params": {p: t.to_local().clone() for p, t in flatten(as_tree(params))},
                     "m": {p: t.to_local().clone() for p, t in flatten(m)},
                     "v": {p: t.to_local().clone() for p, t in flatten(v)},
                     "is_dtensor": all(shd._is_dtensor(t) for _, t in flatten(as_tree(params)))}
    return out


def _state_bytes(mesh):
    out = {}
    for arch in BYTES_ARCHS:
        cfg = get(arch)
        _, p_sh, _, _, opt_cfg, _ = train.build(cfg, mesh, seq=32, batch=8)
        shd.set_activation_mesh(None)
        params = shd.place_tree(api.family_for(cfg).init_params(cfg, 0, device="cpu"), p_sh)
        state = adamw.init(opt_cfg, params)
        blocks = [shd.local(t) for _, t in flatten(as_tree(params))]
        blocks += [shd.local(t) for tree in (state.m, state.v) for _, t in flatten(tree)]
        blocks.append(shd.local(state.step))
        out[arch] = sum(t.numel() * t.element_size() for t in blocks)
    return out


def _moe(mesh):
    collectives.reset_counts()
    metrics, full = run_train(*MOE, mesh)
    counts = collectives.counts()
    return {"metrics": metrics, "params": full, "counts": counts,
            "layer": moe_layer(mesh)}


def _compressed(mesh):
    rank = torch.distributed.get_rank()
    rng = np.random.default_rng(100 + rank)
    grads = {"a": torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32)),
             "b": {"c": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32) * 1e-3)}}
    cg, _ = GradCompressor.init(grads).compress(grads)
    return {"sum": compressed_psum(cg, torch.distributed.group.WORLD), "grads": grads}


GNORM_SPECS = {"rep_model": shd.P("data", None), "split": shd.P("data", "model"),
               "rep_all": shd.P(), "vec": shd.P()}


def gnorm_grads():
    rng = np.random.default_rng(9)
    shapes = {"rep_model": (4, 6), "split": (4, 6), "rep_all": (3, 5), "vec": (7,)}
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def _gnorm(mesh):
    grads = gnorm_grads()
    params = {k: shd.place(np.zeros_like(g), shd.NamedSharding(mesh, GNORM_SPECS[k]), k)
              for k, g in grads.items()}
    blocks = {k: torch.from_numpy(np.ascontiguousarray(
        g[shd.local_slices(g.shape, GNORM_SPECS[k], mesh)])) for k, g in grads.items()}
    _, _, gnorm = adamw.apply(adamw.AdamWConfig(), params, blocks,
                              adamw.init(adamw.AdamWConfig(), params))
    return float(gnorm)


def _refusals(mesh):
    """Without ``--device`` and without a card, a launched rank raises."""
    out = {}
    for name, call in (("init_distributed", lambda: init_distributed()),
                       ("main", lambda: train.main(["--arch", "stablelm-3b-smoke",
                                                    "--steps", "1", "--mesh", "2x2"]))):
        try:
            call()
            out[name] = "returned"
        except RuntimeError as e:
            out[name] = str(e)
    return out


def _worker(rank, store, out_dir):
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"file://{store}", rank=rank, world_size=WORLD,
                     timeout_s=300)
    mesh = shd.make_mesh(MESH, devices="cpu", distributed=True)
    res = {"coords": mesh.coords, "refusals": _refusals(mesh),
           "placement": _placement(mesh), "bytes": _state_bytes(mesh),
           "train": {case: run_train(*case, mesh) for case in TRAIN},
           "moe": _moe(mesh), "compressed": _compressed(mesh), "gnorm": _gnorm(mesh)}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the references): the reference's and the
    one-process runs are made here while the ranks run."""
    d = tmp_path_factory.mktemp("multirank")
    ctx = mp.spawn(_worker, args=(str(d / "store"), str(d)), nprocs=WORLD, join=False)
    try:
        ref = {"train": {case: (_ref_train(*case),
                                run_train(*case, shd.make_mesh((1, 1), devices="cpu")))
                         for case in TRAIN}}
        mesh = shd.make_mesh(MESH, devices="cpu")
        ref["moe"] = (run_train(*MOE, mesh), moe_layer(mesh))
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return ranks, ref


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(autouse=True)
def no_activation_mesh():
    yield
    shd.set_activation_mesh(None)
    from repro.dist import sharding as rshd

    rshd.set_activation_mesh(None)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _ref_train(arch, B, seq, steps):
    """The reference's ``launch.train.build`` on a (1, 1) ``AxisType.Auto``
    mesh from the same params and batches: [(loss, grad norm)]."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs.registry import get as rget
    from repro.launch import train as rtrain
    from repro.optim import adamw as radamw

    cfg = get(arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jitted, r_psh, r_osh, r_insh, r_opt, _ = rtrain.build(rget(arch), mesh, seq=seq,
                                                          batch=B)
    rp = jax.device_put(jax.tree.map(jnp.asarray, np_params(cfg, 8)), r_psh)
    r_state = jax.device_put(radamw.init(r_opt, rp), r_osh)
    out = []
    for b in batches(cfg, B, seq, steps):
        rp, r_state, m = jitted(rp, r_state, jax.tree.map(
            lambda x, s: jax.device_put(x, s), b, r_insh))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_ranks_are_the_mesh_positions_in_row_major_order(ranks):
    assert [r["coords"] for r in ranks] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]


def test_a_launched_rank_without_a_device_refuses_the_cpu(ranks):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    for r in ranks:
        for name, msg in r["refusals"].items():
            assert "device='cpu'" in msg, (name, msg)


@pytest.mark.parametrize("arch", PLACE_ARCHS)
def test_every_block_is_the_reference_block_of_its_mesh_position(ranks, arch):
    """(a) params and moments: each rank's block equals, exactly, the block
    the reference's ``NamedSharding`` gives its mesh position."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding
    from jax.sharding import PartitionSpec as RP

    from repro.configs.registry import get as rget
    from repro.dist import sharding as rshd
    from repro.models.api import family_for as r_family_for

    class Duck:
        axis_names = ("data", "model")
        devices = np.empty(MESH, dtype=object)

    cfg = get(arch)
    real = rshd.NamedSharding
    rshd.NamedSharding = lambda mesh, spec: spec
    try:
        r_specs = rshd.param_shardings(rget(arch), Duck(), r_family_for(rget(arch))
                                       .param_specs(rget(arch)))
    finally:
        rshd.NamedSharding = real
    flat = jax.tree_util.tree_flatten_with_path(
        r_specs, is_leaf=lambda x: isinstance(x, RP))[0]
    specs = {".".join(rshd._path_names(path)): spec for path, spec in flat}
    amesh = AbstractMesh(MESH, ("data", "model"))
    m, v = moments(cfg, 1)
    whole = {"params": {p: t for p, t in flatten(as_tree(
                 api.family_for(cfg).init_params(cfg, 0, device="cpu")))},
             "m": {p: torch.from_numpy(a) for p, a in flatten(m)},
             "v": {p: torch.from_numpy(a) for p, a in flatten(v)}}
    assert set(specs) == set(whole["params"])
    for r in ranks:
        got = r["placement"][arch]
        assert got["is_dtensor"]
        coords = r["coords"]
        for kind in ("params", "m", "v"):
            for path, t in whole[kind].items():
                spec = specs[path]
                block = NamedSharding(amesh, spec).shard_shape(tuple(t.shape))
                index = []
                for d, entry in enumerate(tuple(spec) + (None,) * (t.dim() - len(spec))):
                    names = () if entry is None else (entry,) if isinstance(entry, str) \
                        else tuple(entry)
                    i = 0
                    for a in names:
                        i = i * dict(zip(("data", "model"), MESH))[a] + coords[a]
                    index.append(slice(i * block[d], (i + 1) * block[d]))
                want = t[tuple(index)]
                assert tuple(got[kind][path].shape) == block, (kind, path)
                assert torch.equal(got[kind][path], want), (kind, path, coords)


@pytest.mark.parametrize("arch", BYTES_ARCHS)
def test_each_rank_holds_the_dry_runs_state_bytes(ranks, arch):
    """(b) params + moments + step per rank == ``_memory_of``'s
    ``alias_size_in_bytes`` on the same (2, 2) mesh, exactly."""
    from repro_torch.launch.dryrun import _memory_of

    want = _memory_of(get(arch), ShapeSpec("t", 32, 8, "train"),
                      shd.make_mesh(MESH, devices="cpu"))["alias_size_in_bytes"]
    assert [r["bytes"][arch] for r in ranks] == [want] * WORLD


@pytest.mark.parametrize("case", TRAIN, ids=lambda c: f"{c[0]}-b{c[1]}")
def test_train_steps_match_the_reference_and_the_one_process_run(runs, case):
    """(c) stablelm-3b-smoke, three steps; (d) one step of each other
    family with the inputs its ``input_specs`` names."""
    ranks, ref = runs
    metrics, full = ranks[0]["train"][case]
    assert len(metrics) == case[3]
    assert all(r["train"][case][0] == metrics for r in ranks)
    r_metrics, (one, one_full) = ref["train"][case]
    for (loss, gnorm), (r_loss, r_gnorm) in zip(metrics, r_metrics):
        assert _rel(loss, r_loss) <= 1e-4 and _rel(gnorm, r_gnorm) <= 1e-4
    for (loss, gnorm), (o_loss, o_gnorm) in zip(metrics, one):
        assert _rel(loss, o_loss) <= 1e-4 and _rel(gnorm, o_gnorm) <= 1e-4
    for path, want in one_full.items():
        err = np.abs(full[path] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (path, err)


def test_moe_ranks_match_the_one_process_mesh(runs):
    """(e) moonshot through the rank ``moe_ffn_ep``: the ``model``
    all-reduce ran, and three steps and one layer equal the one-process
    (2, 2) path."""
    ranks, ref = runs
    got = ranks[0]["moe"]
    assert got["counts"]["all-reduce"]["by_axis"]["model"][0] > 0
    (one, one_full), layer = ref["moe"]
    assert len(got["metrics"]) == MOE[3]
    for (loss, gnorm), (o_loss, o_gnorm) in zip(got["metrics"], one):
        assert _rel(loss, o_loss) <= 1e-6 and _rel(gnorm, o_gnorm) <= 1e-6
    for path, want in one_full.items():
        tol = 1e-6 if ".moe." in path else 1e-5
        err = np.abs(got["params"][path] - want).max()
        assert err <= tol * np.abs(want).max(), (path, err)
    for r in ranks:
        rows = r["coords"]["data"] * 2 + np.arange(2)
        for k, want in layer.items():
            g = r["moe"]["layer"][k]
            want = want[rows] if k in ("y", "dx") else want
            assert g.shape == want.shape, k
            assert float((g - want).abs().max()) <= 1e-6 * float(want.abs().max()), k


def test_compressed_psum_group_form_is_bit_equal_to_the_list_form(ranks):
    """(f)"""
    members = [GradCompressor.init(r["compressed"]["grads"]).compress(
        r["compressed"]["grads"])[0] for r in ranks]
    want = compressed_psum(members)
    for r in ranks:
        for (p, a), (q, b) in zip(flatten(want), flatten(r["compressed"]["sum"])):
            assert p == q and torch.equal(a, b)


def test_grad_norm_counts_a_replicated_leaf_once(ranks):
    """(g) leaves replicated over ``model`` (and over both axes) count
    once in the rank step's global gradient norm."""
    grads = gnorm_grads()
    want = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                             for g in grads.values())))
    for r in ranks:
        assert _rel(r["gnorm"], want) <= 1e-6


def test_a_rank_mesh_needs_a_process_group_of_its_size():
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        shd.make_mesh(MESH, devices="cpu", distributed=True)


def test_placements_follow_the_spec_data_major():
    from torch.distributed.tensor import Replicate, Shard

    mesh = shd.make_mesh((2, 2), devices="cpu")
    assert shd.spec_to_placements(shd.P(("data", "model"), None), mesh) == [
        Shard(0), Shard(0)]
    assert shd.spec_to_placements(shd.P(None, "model"), mesh) == [Replicate(), Shard(1)]
    assert shd.spec_to_placements(shd.P(), mesh) == [Replicate(), Replicate()]
    with pytest.raises(ValueError, match="out of the mesh's order"):
        shd.spec_to_placements(shd.P(("model", "data")), mesh)
