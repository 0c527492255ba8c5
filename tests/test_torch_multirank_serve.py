"""LM serving on a rank mesh: four gloo ranks on the CPU, one process per
tile of the (2, 2) and the (1, 4) ``(data, model)`` meshes, against the
reference and against the port's one-process runs.

One 4-rank group (``torch.multiprocessing.spawn``, a ``file://`` store)
runs every scenario of this file on both meshes in a module-scoped
fixture and hands each rank's results to the tests; the reference (JAX)
and the port's one-process runs are computed here, in the test process,
while the ranks run (the ranks import the module without the
reference: JAX is imported where the reference runs).  ``Server`` and the logit comparisons use fp32
parameters of std 0.3 from numpy (seed 9); the cache-layout runs use
``init_params(cfg, 0)`` (bf16, so the caches have the dtypes the dry run
counts).  B = 4 rows and a cache of 12 positions: no head count of any
arch here, so ``cache_shardings`` never takes a sequence dim for a head
dim.

Tolerances: tokens, block shapes, bytes and collective bytes exact;
internvl2's and whisper's prefill and decode logits within 1e-5 x
max |logit| of the one-process step (measured: at most 5.5e-7 of it: the
head-parallel ``wo`` products are summed over ``model`` in another
order than one product over every head).  moonshot on (2, 2) splits its
4 rows over ``data``, so each rank routes 2 rows with the capacity of 2
rows (the expert-parallel semantics of both packages' ``moe_ffn_ep``):
its tokens equal the port's one-process ``Server`` on a logical (2, 2)
mesh, which routes the same way, not the (1, 1) servers, whose capacity
over all 4 rows drops other picks (2 and 6 of 96 in the prefill's two
layers, against 7 and 10 over the two halves).
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.pipeline import batch_rows
from repro_torch.dist import collectives
from repro_torch.dist import sharding as shd
from repro_torch.dist.steps import make_decode_step, make_prefill_step
from repro_torch.launch.dryrun import _memory_of
from repro_torch.launch.mesh import init_distributed
from repro_torch.launch.serve import Server
from repro_torch.models import api
from repro_torch.tree import flatten, unflatten

WORLD, MESHES = 4, [(2, 2), (1, 4)]
SERVE_ARCHS = ["stablelm-3b-smoke", "moonshot-v1-16b-a3b-smoke", "xlstm-125m-smoke",
               "zamba2-2.7b-smoke"]
STEP_ARCHS = ["internvl2-26b-smoke", "whisper-medium-smoke"]
B, PROMPT_CAP, GEN_CAP, PLEN, N_TOKENS = 4, 7, 5, 6, 4
CAP = PROMPT_CAP + GEN_CAP
TOL = 1e-5


def np_params(cfg, seed, std=0.3):
    rng = np.random.default_rng(seed)
    return unflatten((p, (rng.normal(size=s.shape) * std).astype(np.float32))
                     for p, s in flatten(api.abstract_params(cfg)))


def prompts(cfg):
    return np.random.default_rng(10).integers(0, cfg.vocab, (B, PLEN)).astype(np.int32)


def step_inputs(cfg, dtype):
    """A step-builder run's prefill inputs (float ones in ``dtype``; the
    cache length is CAP, the VLM's patches included) and its two decode
    tokens."""
    rng = np.random.default_rng(11)
    n_tok = CAP - (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, n_tok)).astype(np.int32))}
    extra = {"vlm": ("patches", cfg.n_patches), "encdec": ("frames", cfg.encoder_len)}
    if cfg.family in extra:
        name, n = extra[cfg.family]
        batch[name] = torch.from_numpy(rng.normal(size=(B, n, cfg.d_model))).to(dtype)
    return batch, torch.from_numpy(rng.integers(0, cfg.vocab, (2, B, 1)).astype(np.int32))


def serve(arch, mesh):
    """``Server.generate`` of ``PLEN``-token prompts for ``N_TOKENS``."""
    cfg = get(arch)
    server = Server(cfg, mesh, batch=B, prompt_cap=PROMPT_CAP, gen_cap=GEN_CAP,
                    device="cpu")
    params = lm_params_from_numpy(cfg, np_params(cfg, 9), device="cpu")
    if mesh is not None and mesh.distributed:
        params = shd.place_tree(params, shd.param_shardings(
            cfg, mesh, api.family_for(cfg).param_specs(cfg)))
    server.load_weights(params)
    try:
        return server.generate(prompts(cfg), N_TOKENS)
    finally:
        shd.set_activation_mesh(None)


def leaves(tree):
    out = []
    shd.map_leaves(out.append, tree)
    return out


def nbytes(tensors):
    return sum(shd.local(t).numel() * shd.local(t).element_size() for t in tensors)


def run_steps(arch, mesh, params, dtype):
    """A prefill and two decode steps (pos CAP - 2, CAP - 1) through the
    step builders -> {"logits": [prefill, decode, decode] as whole [B, V],
    "tokens": [B, 3]} and, on a rank mesh, the rank's head ranges, its
    cache block shapes after the prefill and after the decode steps, its
    cache bytes, and the second decode step's collectives: all of them,
    the all-gather bytes of weights (``ShardedLeaf.gather``) and the
    bytes of the recurrent state blocks whose heads are split."""
    cfg = get(arch)
    fam = api.family_for(cfg)
    batch, toks = step_inputs(cfg, dtype)
    ranks = mesh is not None and mesh.distributed
    out = {"logits": [], "tokens": []}
    if ranks:
        shd.set_activation_mesh(mesh)
        params = shd.place_tree(params, shd.param_shardings(cfg, mesh,
                                                            fam.param_specs(cfg)))
        axes, mine = batch_rows(mesh, B)

        def rows(t):
            sh = shd.NamedSharding(mesh, shd.P(axes or None, *([None] * (t.dim() - 1))))
            return shd.from_block(t[mine].contiguous(), sh, t.shape)

        batch = {k: rows(v) for k, v in batch.items()}
        decode_logits = make_decode_step(cfg, mesh).logits
    else:
        rows = shd.local

        def decode_logits(p, c, b):
            return fam.decode(cfg, p, c, b)

    whole = collectives.gather_full if ranks else (lambda t: t)
    logits, cache = make_prefill_step(cfg, mesh)(params, batch)
    out["logits"].append(whole(logits))
    if ranks:
        shape = ShapeSpec("decode", CAP, B, "decode")
        out["heads"] = shd.head_ranges(cfg, mesh, shd.cache_shardings(
            cfg, mesh, shape, fam.cache_specs(cfg, shape)))
        out["after_prefill"] = [tuple(shd.local(t).shape) for t in leaves(cache)]
    for i, tok in enumerate(toks):
        b = {"token": rows(tok), "pos": CAP - 2 + i}
        if ranks and i == 1:
            collectives.reset_counts()
            real = collectives.ShardedLeaf.gather
            weights = [0]

            def gather(self):
                before = collectives.counts().get("all-gather", {"bytes": 0})["bytes"]
                g = real(self)
                weights[0] += collectives.counts().get("all-gather",
                                                       {"bytes": 0})["bytes"] - before
                return g

            collectives.ShardedLeaf.gather = gather
            try:
                logits, cache = decode_logits(params, cache, b)
            finally:
                collectives.ShardedLeaf.gather = real
            out["counts"], out["weight_gather"] = collectives.counts(), weights[0]
        else:
            logits, cache = decode_logits(params, cache, b)
        out["logits"].append(whole(logits))
    out["tokens"] = torch.stack([torch.argmax(t, -1).to(torch.int32)
                                 for t in out["logits"]], 1)
    if ranks:
        out["after_decode"] = [tuple(shd.local(t).shape) for t in leaves(cache)]
        out["bytes"] = nbytes(leaves(cache))
        split = out["heads"] is not None and out["heads"].state is not None
        state = (list(cache[0]) if cfg.family == "ssm_xlstm" else [cache[0][1]]) \
            if split else []
        out["state_bytes"] = nbytes(state)
        shd.set_activation_mesh(None)
    return out


# ---------------------------------------------------------------------------
# the scenarios, on every rank of one 4-rank group
# ---------------------------------------------------------------------------

def _refusal(mesh):
    """``load_weights`` of weights that are not the mesh's blocks."""
    cfg = get("stablelm-3b-smoke")
    server = Server(cfg, mesh, batch=B, prompt_cap=PROMPT_CAP, device="cpu")
    shd.set_activation_mesh(None)
    try:
        server.load_weights(api.family_for(cfg).init_params(cfg, 0, device="cpu"))
    except ValueError as e:
        return str(e)
    return "loaded"


def _worker(rank, store, out_dir):
    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"file://{store}", rank=rank, world_size=WORLD,
                     timeout_s=300)
    res = {}
    for shape in MESHES:
        mesh = shd.make_mesh(shape, devices="cpu", distributed=True)
        res[shape] = {
            "coords": mesh.coords, "device": str(Server(
                get("stablelm-3b-smoke"), mesh, batch=B, prompt_cap=PROMPT_CAP).device),
            "refusal": _refusal(mesh),
            "serve": {a: serve(a, mesh) for a in SERVE_ARCHS},
            "steps": {a: run_steps(a, mesh, lm_params_from_numpy(
                get(a), np_params(get(a), 9), device="cpu"), torch.float32)
                for a in STEP_ARCHS},
            "layout": {a: run_steps(a, mesh, api.family_for(get(a)).init_params(
                get(a), 0, device="cpu"), torch.bfloat16)
                for a in SERVE_ARCHS + STEP_ARCHS}}
        shd.set_activation_mesh(None)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _ref_serve(arch):
    """The reference's ``Server`` under an Auto (1, 1) mesh; its
    activation mesh is cleared (its MoE and recurrent sharding hints
    raise on this jax; on one device they change nothing)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs.registry import get as rget
    from repro.dist import sharding as rshd
    from repro.launch.serve import Server as RServer

    cfg = get(arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    ref = RServer(rget(arch), mesh, batch=B, prompt_cap=PROMPT_CAP, gen_cap=GEN_CAP)
    rshd.set_activation_mesh(None)
    ref.load_weights(jax.tree.map(jnp.asarray, np_params(cfg, 9)))
    return np.asarray(ref.generate(prompts(cfg), N_TOKENS))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the references): the reference's and the
    one-process runs are made here while the ranks run."""
    d = tmp_path_factory.mktemp("multirank_serve")
    ctx = mp.spawn(_worker, args=(str(d / "store"), str(d)), nprocs=WORLD, join=False)
    try:
        ref = {"serve": {a: serve(a, None) for a in SERVE_ARCHS},
               "ref_serve": {a: _ref_serve(a) for a in SERVE_ARCHS},
               "moe_2x2": serve("moonshot-v1-16b-a3b-smoke",
                                shd.make_mesh((2, 2), devices="cpu")),
               "steps": {a: run_steps(a, None, lm_params_from_numpy(
                   get(a), np_params(get(a), 9), device="cpu"), torch.float32)
                   for a in STEP_ARCHS}}
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
    from repro.dist import sharding as rshd

    shd.set_activation_mesh(None)
    rshd.set_activation_mesh(None)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
def test_each_rank_serves_on_its_own_device_at_its_mesh_position(ranks, shape):
    assert [r[shape]["coords"] for r in ranks] == [
        {"data": d, "model": m} for d in range(shape[0]) for m in range(shape[1])]
    assert all(r[shape]["device"] == "cpu" for r in ranks)
    for r in ranks:
        assert "not a block of the server's rank mesh" in r[shape]["refusal"]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_server_tokens_match_the_one_process_and_reference_servers(runs, arch, shape):
    """(b) every rank returns the whole batch's tokens, equal to the port's
    one-process ``Server`` and the reference's (see the module docstring
    for moonshot on (2, 2))."""
    ranks, ref = runs
    want = ref["serve"][arch]
    assert want.shape == (B, N_TOKENS) and np.array_equal(want, ref["ref_serve"][arch])
    if arch.startswith("moonshot") and shape == (2, 2):
        want = ref["moe_2x2"]
    for r in ranks:
        got = r[shape]["serve"][arch]
        assert got.dtype == np.int32 and np.array_equal(got, want), (r[shape]["coords"])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_step_builders_match_the_one_process_steps(runs, arch, shape):
    """(c) internvl2 (patches) and whisper (frames) through the rank step
    builders: prefill and decode logits within TOL x max |logit|, tokens
    equal."""
    ranks, ref = runs
    want = ref["steps"][arch]
    for r in ranks:
        got = r[shape]["steps"][arch]
        for g, w in zip(got["logits"], want["logits"], strict=True):
            assert g.shape == w.shape
            assert float((g - w).abs().max()) <= TOL * float(w.abs().max())
        assert torch.equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("shape", MESHES)
def test_gqa_heads_split_where_model_divides_the_kv_heads(ranks, shape):
    """(d) internvl2 has 4 query heads and 2 KV heads: on (2, 2) each rank
    takes one KV head and its two query heads; on (1, 4) the head dim
    stays replicated (no ranges) and every rank attends with all heads."""
    for r in ranks:
        heads = r[shape]["steps"]["internvl2-26b-smoke"]["heads"]
        m = r[shape]["coords"]["model"]
        if shape == (2, 2):
            assert (heads.q, heads.kv, heads.state) == (slice(2 * m, 2 * m + 2),
                                                         slice(m, m + 1), None)
        else:
            assert heads is None


def _ref_cache_specs(arch, shape):
    """The reference's cache specs and logical shapes at (B, CAP), in the
    leaves' order."""
    import jax
    from jax.sharding import PartitionSpec as RP

    from repro.configs.base import ShapeSpec as RShapeSpec
    from repro.configs.registry import get as rget
    from repro.dist import sharding as rshd
    from repro.models.api import family_for as r_family_for

    class Duck:
        axis_names = ("data", "model")
        devices = np.empty(shape, dtype=object)

    rcfg = rget(arch)
    rs = RShapeSpec("decode", CAP, B, "decode")
    c_specs = r_family_for(rcfg).cache_specs(rcfg, rs)
    real = rshd.NamedSharding
    rshd.NamedSharding = lambda mesh, spec: spec
    try:
        r_c = rshd.cache_shardings(rcfg, Duck(), rs, c_specs)
    finally:
        rshd.NamedSharding = real
    specs = jax.tree.leaves(r_c, is_leaf=lambda x: isinstance(x, RP))
    return [shd.P(*s) for s in specs], [tuple(s.shape) for s in jax.tree.leaves(c_specs)]


class _Position:
    """A rank's mesh position, as ``local_slices`` reads it."""

    def __init__(self, shape, coords):
        self.axis_names = ("data", "model")
        self.devices = np.empty(shape, dtype=object)
        self.coords = coords


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", SERVE_ARCHS + STEP_ARCHS)
def test_cache_blocks_are_the_reference_shards_and_the_dry_runs_bytes(ranks, arch, shape):
    """(a) after the prefill and after two decode steps each rank's cache
    blocks have the shapes ``local_slices`` gives from the reference's
    ``cache_shardings`` specs, and their bytes equal ``_memory_of``'s
    decode alias bytes, exactly."""
    specs, full = _ref_cache_specs(arch, shape)
    want_bytes = _memory_of(get(arch), ShapeSpec("decode", CAP, B, "decode"),
                            shd.make_mesh(shape, devices="cpu"))["alias_size_in_bytes"]
    for r in ranks:
        got = r[shape]["layout"][arch]
        pos = _Position(shape, r[shape]["coords"])
        want = [tuple(torch.empty(f, device="meta")[shd.local_slices(f, s, pos)].shape)
                for s, f in zip(specs, full, strict=True)]
        assert got["after_prefill"] == want and got["after_decode"] == want
        assert got["bytes"] == want_bytes


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", SERVE_ARCHS + STEP_ARCHS)
def test_a_decode_step_all_gathers_no_kv_cache(ranks, arch, shape):
    """(e) a decode step's all-gather bytes (``collectives.counts()``) are
    those of the weights it reads plus one gather of each recurrent state
    block whose heads are split: no KV cache leaf is all-gathered.  Where
    the KV heads are split, the ``wo`` products are all-reduced over
    ``model``."""
    for r in ranks:
        got = r[shape]["layout"][arch]
        counts = got["counts"]
        gathered = counts.get("all-gather", {"bytes": 0})["bytes"]
        assert gathered == got["weight_gather"] + got["state_bytes"]
        heads = got["heads"]
        if heads is not None and heads.kv is not None:
            assert counts["all-reduce"]["by_axis"]["model"][0] > 0
        if arch in ("xlstm-125m-smoke", "zamba2-2.7b-smoke"):
            assert heads.state is not None and got["state_bytes"] > 0
