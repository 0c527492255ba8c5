"""The port's AdamW and int8 gradient compression against the
reference's (``tests/test_optim.py``'s cases, plus parity on the same
numpy inputs in fp32).

Tolerances: ``adamw.apply`` params, moments and ``grad_norm`` within 1e-6
of the reference's, relative to each leaf's largest magnitude (fp32; the
two libraries may contract multiply-adds differently); ``step`` equal.
``GradCompressor``: the int8 payload and the scales exactly equal (both
round half to even), the error feedback within 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as radamw
from repro.optim.compress import GradCompressor as RComp
from repro_torch.convert import adamw_state_from_numpy, adamw_state_to_numpy
from repro_torch.optim import adamw
from repro_torch.optim.compress import GradCompressor
from repro_torch.tree import flatten, tree_map


def _tree(rng, scale=1.0):
    return {
        "a": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
        "b": {"c": (rng.normal(size=(7,)) * scale).astype(np.float32),
              "d": (rng.normal(size=(2, 3, 4)) * scale).astype(np.float32)},
    }


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(port, ref, rel):
    for (path, p), (_, r) in zip(flatten(port), flatten(ref)):
        p = p.detach().float().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        r = np.asarray(r, np.float32)
        assert p.shape == r.shape, path
        assert np.max(np.abs(p - r)) <= rel * max(np.max(np.abs(r)), 1e-30), path


@pytest.mark.parametrize("grad_scale,step", [(0.01, 0), (1.0, 3), (100.0, 7)])
def test_apply_matches_reference(grad_scale, step):
    """Clipping off (small grads) and on (large grads), from a fresh
    state and from a state several steps in."""
    rng = np.random.default_rng(step)
    params, grads = _tree(rng), _tree(rng, grad_scale)
    m = _tree(rng, 0.1) if step else tree_map(np.zeros_like, params)
    v = tree_map(np.abs, _tree(rng, 0.1)) if step else tree_map(np.zeros_like, params)
    cfg_r, cfg_t = radamw.AdamWConfig(lr=1e-2), adamw.AdamWConfig(lr=1e-2)
    state_r = radamw.AdamWState(jnp.int32(step), _j(m), _j(v))
    state_t = adamw_state_from_numpy((np.int32(step), m, v), device="cpu")
    p_r, s_r, g_r = radamw.apply(cfg_r, _j(params), _j(grads), state_r)
    p_t, s_t, g_t = adamw.apply(cfg_t, _t(params), _t(grads), state_t)
    assert int(s_t.step) == int(s_r.step) == step + 1
    assert abs(float(g_t) - float(g_r)) <= 1e-6 * float(g_r)
    _close(p_t, p_r, 1e-6)
    _close(s_t.m, s_r.m, 1e-6)
    _close(s_t.v, s_r.v, 1e-6)
    step_np, m_np, v_np = adamw_state_to_numpy(s_t)
    assert int(step_np) == step + 1
    _close(m_np, s_r.m, 1e-6)


def test_apply_updates_in_place_in_slices(monkeypatch):
    """A leaf larger than one slice gives the same result as one whole
    slice, and the returned params and moments are the given tensors."""
    rng = np.random.default_rng(9)
    params, grads = _tree(rng), _tree(rng)
    cfg = adamw.AdamWConfig()
    whole_p = _t(params)
    whole_p, whole_s, whole_g = adamw.apply(cfg, whole_p, _t(grads),
                                            adamw.init(cfg, whole_p))
    monkeypatch.setattr(adamw, "_CHUNK", 4)
    p = _t(params)
    state = adamw.init(cfg, p)
    p2, s2, g2 = adamw.apply(cfg, p, _t(grads), state)
    assert p2 is p and s2.m is state.m
    assert float(g2) == pytest.approx(float(whole_g), rel=1e-6)
    for (_, a), (_, b) in zip(flatten(p2), flatten(whole_p)):
        assert torch.equal(a, b)


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0)
    target = torch.from_numpy(np.random.default_rng(0).normal(size=(8,)).astype(np.float32))
    params = {"w": torch.zeros(8)}
    state = adamw.init(cfg, params)

    def loss_fn(w):
        return torch.sum((w - target) ** 2)

    for _ in range(300):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(loss_fn(w), [w])
        params, state, _ = adamw.apply(cfg, params, {"w": g}, state)
    assert float(loss_fn(params["w"])) < 1e-2


def test_adamw_bf16_moments():
    """The reference's case, and the port's bf16 result within bf16
    rounding of the reference's."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(4, 4)).astype(np.float32)
    g = rng.normal(size=(4, 4)).astype(np.float32)
    cfg_t = adamw.AdamWConfig(moment_dtype=torch.bfloat16)
    cfg_r = radamw.AdamWConfig(moment_dtype=jnp.bfloat16)
    params = {"w": torch.from_numpy(w).to(torch.bfloat16)}
    state = adamw.init(cfg_t, params)
    assert state.m["w"].dtype == torch.bfloat16
    p2, s2, gn = adamw.apply(cfg_t, params, {"w": torch.from_numpy(g).to(torch.bfloat16)},
                             state)
    assert p2["w"].dtype == torch.bfloat16 and s2.v["w"].dtype == torch.bfloat16
    assert bool(torch.isfinite(gn))
    pr = {"w": jnp.asarray(w).astype(jnp.bfloat16)}
    p_r, s_r, g_r = radamw.apply(cfg_r, pr, {"w": jnp.asarray(g).astype(jnp.bfloat16)},
                                 radamw.init(cfg_r, pr))
    assert abs(float(gn) - float(g_r)) <= 1e-6 * float(g_r)
    _close(p2, {"w": np.asarray(p_r["w"].astype(jnp.float32))}, 1e-2)
    _close(s2.m, {"w": np.asarray(s_r.m["w"].astype(jnp.float32))}, 1e-2)


def test_grad_clip():
    cfg = adamw.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = adamw.init(cfg, params)
    p2, _, gnorm = adamw.apply(cfg, params, {"w": torch.full((4,), 100.0)}, state)
    assert float(gnorm) > 100.0
    assert bool(torch.all(torch.abs(p2["w"]) < 10.0))
    _, _, g_r = radamw.apply(radamw.AdamWConfig(lr=1.0, weight_decay=0.0),
                             {"w": jnp.zeros(4)}, {"w": jnp.full(4, 100.0)},
                             radamw.init(radamw.AdamWConfig(), {"w": jnp.zeros(4)}))
    assert float(gnorm) == pytest.approx(float(g_r), rel=1e-6)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e-20])
def test_compress_matches_reference_exactly(scale):
    """Three chained compressions (error feedback carried): the int8
    payload and the scales equal, the residuals within 1e-7."""
    rng = np.random.default_rng(5)
    grads = [_tree(rng, scale) for _ in range(3)]
    comp_r, comp_t = RComp.init(_j(grads[0])), GradCompressor.init(_t(grads[0]))
    for g in grads:
        cg_r, comp_r = comp_r.compress(_j(g))
        cg_t, comp_t = comp_t.compress(_t(g))
        for (path, q), (_, qr) in zip(flatten(cg_t.q), flatten(cg_r.q)):
            assert q.dtype == torch.int8
            assert np.array_equal(q.numpy(), np.asarray(qr)), path
        for (path, s), (_, sr) in zip(flatten(cg_t.scale), flatten(cg_r.scale)):
            assert s.numpy().tobytes() == np.asarray(sr, np.float32).tobytes(), path
        for (path, e), (_, er) in zip(flatten(comp_t.error), flatten(comp_r.error)):
            assert np.max(np.abs(e.numpy() - np.asarray(er))) <= 1e-7 * max(scale, 1e-7)
        for (_, d), (_, dr) in zip(flatten(GradCompressor.decompress(cg_t)),
                                   flatten(RComp.decompress(cg_r))):
            assert np.array_equal(d.numpy(), np.asarray(dr))


def test_compression_roundtrip_bounded_error():
    rng = np.random.default_rng(1)
    grads = {"a": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))}
    comp = GradCompressor.init(grads)
    cg, comp = comp.compress(grads)
    assert cg.q["a"].dtype == torch.int8
    deq = GradCompressor.decompress(cg)
    err = float(torch.max(torch.abs(deq["a"] - grads["a"])))
    assert err <= float(cg.scale["a"]) * 0.51  # rounding bound


def test_error_feedback_accumulates():
    rng = np.random.default_rng(2)
    g = {"a": torch.from_numpy((rng.normal(size=(256,)) * 1e-3).astype(np.float32))}
    comp = GradCompressor.init(g)
    total = torch.zeros(256)
    k = 50
    for _ in range(k):
        cg, comp = comp.compress(g)
        total = total + GradCompressor.decompress(cg)["a"]
    resid = float(torch.max(torch.abs(total - g["a"] * k)))
    assert resid <= float(cg.scale["a"]) * 1.01


def test_compressed_training_converges():
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0)
    target = torch.from_numpy(np.random.default_rng(3).normal(size=(8,)).astype(np.float32))
    params = {"w": torch.zeros(8)}
    state = adamw.init(cfg, params)
    comp = GradCompressor.init(params)
    for _ in range(300):
        w = params["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        cg, comp = comp.compress({"w": g})
        params, state, _ = adamw.apply(cfg, params, GradCompressor.decompress(cg), state)
    assert float(torch.sum((params["w"] - target) ** 2)) < 5e-2
