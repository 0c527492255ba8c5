"""The port's expert-parallel MoE (``models.moe.moe_ffn_ep``) and the
compressed all-reduce (``optim.compress.compressed_psum``) against the
reference.

The reference's ``moe_ffn_ep`` raises on this jax (``shard_map``'s
``check_rep``), so ``moe_ffn_ep`` is held to the reference's plain
``moe_ffn`` -- on each data shard's rows when the mesh splits the batch,
since the capacity follows the shard's tokens -- in fp32 within 1e-5 of
the largest output magnitude, the tolerance of
``tests/test_tm_sharded.py::test_moe_ep_matches_plain``.  Its input and
weight gradients are held to autograd through the port's ``moe_ffn`` (per
data shard) within 5e-5 of each gradient's largest magnitude.  On a
(1, 1) mesh it is ``moe_ffn`` op for op: bit-equal.  ``compressed_psum``
is held to the reference's run under ``jax.vmap(..., axis_name=)``: the
int8 payload and scales exactly, the sums within 1e-6 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get as rget
from repro.dist import sharding as rshd
from repro.models import moe as rmoe
from repro.optim import compress as rcompress
from repro_torch.configs.registry import get
from repro_torch.dist import sharding as shd
from repro_torch.models import moe
from repro_torch.optim import compress

MESHES = [(1, 1), (1, 2), (1, 4), (2, 2), (2, 1)]


@pytest.fixture(autouse=True)
def no_activation_mesh():
    shd.set_activation_mesh(None)
    rshd.set_activation_mesh(None)
    yield
    shd.set_activation_mesh(None)


def _case(seed=0, B=4, S=16, n_experts=4, top_k=2, capacity_factor=1.25):
    """A smoke MoE layer; ``capacity_factor`` 0.5 makes every expert drop
    picks (capacity 8 per data shard of 32 tokens, 16 on 64)."""
    kw = dict(n_experts=n_experts, top_k=top_k, capacity_factor=capacity_factor)
    cfg = dataclasses.replace(get("moonshot-v1-16b-a3b-smoke"), **kw)
    rcfg = dataclasses.replace(rget("moonshot-v1-16b-a3b-smoke"), **kw)
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": rng.normal(size=(D, E)).astype(np.float32),
        "w_gate": (rng.normal(size=(E, D, F)) * 0.05).astype(np.float32),
        "w_up": (rng.normal(size=(E, D, F)) * 0.05).astype(np.float32),
        "w_down": (rng.normal(size=(E, F, D)) * 0.05).astype(np.float32),
    }
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    return cfg, rcfg, p, x


def _t(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("n_experts,top_k,capacity_factor", [(4, 2, 1.25), (8, 3, 1.25),
                                                             (4, 2, 0.5)])
def test_moe_ffn_ep_matches_reference_per_data_shard(shape, n_experts, top_k,
                                                     capacity_factor):
    cfg, rcfg, p, x = _case(n_experts=n_experts, top_k=top_k,
                            capacity_factor=capacity_factor)
    mesh = shd.make_mesh(shape, devices="cpu")
    y = moe.moe_ffn_ep(_t(p), torch.from_numpy(x), cfg, mesh)
    n_data = shape[0]
    rows = x.shape[0] // n_data
    want = np.concatenate([
        np.asarray(rmoe.moe_ffn(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x[i * rows:(i + 1) * rows]), rcfg))
        for i in range(n_data)])
    assert y.shape == x.shape and y.dtype == torch.float32
    assert _rel(y.numpy(), want) <= 1e-5
    if n_data > 1 and capacity_factor < 1:  # the capacity follows the shard
        whole = moe.moe_ffn(_t(p), torch.from_numpy(x), cfg)
        assert not torch.equal(y, whole)


@pytest.mark.parametrize("shape", MESHES)
def test_moe_ffn_ep_gradients_match_plain_autograd(shape):
    cfg, _, p, x = _case(seed=3, capacity_factor=0.5)
    mesh = shd.make_mesh(shape, devices="cpu")
    w = torch.from_numpy(np.random.default_rng(4).normal(size=x.shape).astype(np.float32))

    def grads(fn):
        tp = {k: v.clone().requires_grad_() for k, v in _t(p).items()}
        tx = torch.from_numpy(x).requires_grad_()
        (fn(tp, tx) * w).sum().backward()
        return [tx.grad] + [tp[k].grad for k in sorted(tp)]

    rows = x.shape[0] // shape[0]
    got = grads(lambda tp, tx: moe.moe_ffn_ep(tp, tx, cfg, mesh))
    want = grads(lambda tp, tx: torch.cat([
        moe.moe_ffn(tp, tx[i * rows:(i + 1) * rows], cfg) for i in range(shape[0])]))
    for g, gw in zip(got, want):
        if float(gw.abs().max()) == 0:  # the router's gradient is zero in both
            assert float(g.abs().max()) == 0
            continue
        assert _rel(g.numpy(), gw.numpy()) <= 5e-5


def test_moe_ffn_ep_on_one_tile_is_moe_ffn_bit_for_bit():
    cfg, _, p, x = _case(seed=5, n_experts=4)
    mesh = shd.make_mesh((1, 1), devices="cpu")
    y_ep = moe.moe_ffn_ep(_t(p), torch.from_numpy(x), cfg, mesh)
    y = moe.moe_ffn(_t(p), torch.from_numpy(x), cfg)
    assert torch.equal(y_ep, y)
    pb = {k: v.to(torch.bfloat16) if k != "router" else v for k, v in _t(p).items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(moe.moe_ffn_ep(pb, xb, cfg, mesh), moe.moe_ffn(pb, xb, cfg))


def test_moe_ffn_takes_the_ep_path_under_an_activation_mesh(monkeypatch):
    cfg, _, p, x = _case(seed=6, n_experts=4, capacity_factor=0.5)
    calls = []
    real = moe.moe_ffn_ep
    monkeypatch.setattr(moe, "moe_ffn_ep", lambda *a: calls.append(a[3]) or real(*a))
    plain = moe.moe_ffn(_t(p), torch.from_numpy(x), cfg)
    assert calls == []
    mesh = shd.make_mesh((2, 2), devices="cpu")
    shd.set_activation_mesh(mesh)
    y = moe.moe_ffn(_t(p), torch.from_numpy(x), cfg)
    assert calls == [mesh] and not torch.equal(y, plain)
    # a model axis that does not divide the experts: the plain path
    shd.set_activation_mesh(shd.make_mesh((1, 3), devices="cpu"))
    assert torch.equal(moe.moe_ffn(_t(p), torch.from_numpy(x), cfg), plain)
    shd.set_activation_mesh(shd.make_mesh((2,), ("data",), devices="cpu"))
    assert torch.equal(moe.moe_ffn(_t(p), torch.from_numpy(x), cfg), plain)
    assert calls == [mesh]


@pytest.mark.parametrize("members", [1, 2, 4])
def test_compressed_psum_matches_reference_under_vmap(members):
    rng = np.random.default_rng(members)
    trees = [{"a": (rng.normal(size=(6, 5)) * 10 ** rng.uniform(-3, 1)).astype(np.float32),
              "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
             for _ in range(members)]
    errors = [{"a": (rng.normal(size=(6, 5)) * 1e-3).astype(np.float32),
               "b": {"c": (rng.normal(size=(7,)) * 1e-3).astype(np.float32)}}
              for _ in range(members)]
    stack = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    e_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *errors)

    def ref(g, e):
        cg, _ = rcompress.GradCompressor(error=e).compress(g)
        return cg, rcompress.compressed_psum(cg, "data")

    r_cg, r_sum = jax.vmap(ref, axis_name="data")(stack, e_stack)
    cgs = []
    for i in range(members):
        err = {"a": torch.from_numpy(errors[i]["a"]),
               "b": {"c": torch.from_numpy(errors[i]["b"]["c"])}}
        g = {"a": torch.from_numpy(trees[i]["a"]),
             "b": {"c": torch.from_numpy(trees[i]["b"]["c"])}}
        cg, _ = compress.GradCompressor(error=err).compress(g)
        assert cg.q["a"].dtype == torch.int8
        assert np.array_equal(cg.q["a"].numpy(), np.asarray(r_cg.q["a"][i]))
        assert np.array_equal(cg.q["b"]["c"].numpy(), np.asarray(r_cg.q["b"]["c"][i]))
        assert float(cg.scale["a"]) == float(r_cg.scale["a"][i])
        assert float(cg.scale["b"]["c"]) == float(r_cg.scale["b"]["c"][i])
        cgs.append(cg)
    total = compress.compressed_psum(cgs)
    for i in range(members):  # every member receives the same sum
        assert _rel(total["a"].numpy(), r_sum["a"][i]) <= 1e-6
        assert _rel(total["b"]["c"].numpy(), r_sum["b"]["c"][i]) <= 1e-6
    assert total["a"].dtype == torch.float32
    with pytest.raises(ValueError, match="at least one"):
        compress.compressed_psum([])
