"""The port's dense/MoE/VLM trunk, its step builders and its serving
driver against the reference's (``tests/test_models_smoke.py``'s cases),
on the same numpy parameters in fp32.

The parameters are drawn with numpy at std 0.3: at the reference's init
scale (0.02) every smoke model predicts close to uniform (loss ln 512 for
all of them), so agreement there would say nothing.

Tolerances (fp32): ``loss`` 1e-4, ``prefill`` logits 1e-4 and caches
1e-5, ``decode`` logits 1e-4 (absolute); gradients within 1e-4 of each
leaf's largest magnitude; ``moe_ffn``'s ``keep`` mask exactly equal and
its output within 1e-5 of its largest magnitude; the train step's ``loss`` and ``grad_norm``
within 1e-4 relative over 5 chained steps (each side chains its own
params: after Adam's first steps, ~sign(g) * lr, parameters are not
compared elementwise); greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get as rget
from repro.dist import sharding as rshd
from repro.dist import steps as rsteps
from repro.launch.serve import Server as RServer
from repro.models import dense as rdense
from repro.models import moe as rmoe
from repro.optim import adamw as radamw
from repro_torch.configs.registry import get
from repro_torch.convert import (
    adamw_state_from_numpy,
    lm_params_from_numpy,
    lm_params_to_numpy,
)
from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
from repro_torch.dist.steps import make_train_step, opt_config_for
from repro_torch.launch.serve import Server
from repro_torch.models import api, dense, moe
from repro_torch.optim import adamw
from repro_torch.tree import flatten, unflatten

ARCHS = ["stablelm-3b-smoke", "starcoder2-7b-smoke", "moonshot-v1-16b-a3b-smoke",
         "internvl2-26b-smoke"]


@pytest.fixture(autouse=True)
def no_reference_mesh():
    """The reference's ``Server`` installs a process-wide activation mesh;
    clear it so no later test takes the reference's mesh paths."""
    yield
    rshd.set_activation_mesh(None)


def np_params(cfg, seed, std=0.3):
    rng = np.random.default_rng(seed)
    return unflatten((p, (rng.normal(size=s.shape) * std).astype(np.float32))
                     for p, s in flatten(dense.param_specs(cfg)))


def np_batch(cfg, seed, B=2, S=16):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    return batch


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _reldiff(a, b):
    return _maxdiff(a, b) / float(np.max(np.abs(np.asarray(b))))


def _pair(arch, seed=0):
    cfg = get(arch)
    tree = np_params(cfg, seed)
    return cfg, rget(arch), tree, lm_params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_prefill_decode_match_reference(arch):
    cfg, rcfg, tree, params = _pair(arch)
    rp = _j(tree)
    batch = np_batch(cfg, 1)
    l_r = jax.jit(lambda p, b: rdense.loss(rcfg, p, b))(rp, _j(batch))
    l_t = dense.loss(cfg, params, _t(batch)).detach()
    assert abs(float(l_t) - float(l_r)) < 1e-4
    assert abs(float(l_r) - np.log(cfg.vocab)) > 0.1  # not the uniform predictor

    logits_r, cache_r = jax.jit(lambda p, b: rdense.prefill(rcfg, p, b))(rp, _j(batch))
    logits_t, cache_t = dense.prefill(cfg, params, _t(batch))
    assert logits_t.shape == (2, cfg.padded_vocab)
    assert _maxdiff(logits_t, logits_r) < 1e-4
    for name in ("k", "v"):
        assert cache_t[name].shape == cache_r[name].shape
        assert _maxdiff(cache_t[name], cache_r[name]) < 1e-5

    S = cache_r["k"].shape[2]
    rng = np.random.default_rng(2)
    for pos in (S - 1, S):  # the last slot, and a write past the end (clamped)
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        lr2, cr2 = jax.jit(lambda p, c, b: rdense.decode(rcfg, p, c, b))(
            rp, cache_r, {"token": jnp.asarray(tok), "pos": jnp.int32(pos)})
        mine = {k: v.clone() for k, v in cache_t.items()}
        lt2, ct2 = dense.decode(cfg, params, mine, {"token": torch.from_numpy(tok),
                                                    "pos": pos})
        assert ct2["k"] is mine["k"]  # donated: written in place
        assert _maxdiff(lt2, lr2) < 1e-4
        assert _maxdiff(ct2["v"], cr2["v"]) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    cfg, rcfg, tree, params = _pair(arch, seed=3)
    batch = np_batch(cfg, 4)
    g_r = jax.jit(jax.grad(lambda p, b: rdense.loss(rcfg, p, b)))(_j(tree), _j(batch))
    xs = {p: t.clone().requires_grad_() for p, t in params.state_dict().items()}
    loss = dense.loss(cfg, unflatten(xs.items()), _t(batch))
    g_t = dict(zip(xs, torch.autograd.grad(loss, list(xs.values()))))
    ref = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(g)
           for p, g in jax.tree_util.tree_leaves_with_path(g_r)}
    assert set(ref) == set(g_t) == set(params.state_dict())
    for path, g in ref.items():
        scale = float(np.max(np.abs(g)))
        assert scale > 0, path
        assert _maxdiff(g_t[path], g) <= 1e-4 * scale, path


@pytest.mark.parametrize("E_local", [4, 2])
def test_moe_keep_mask_and_output_match_reference(E_local):
    """A router skewed towards expert 0 at a capacity of 16 drops
    assignments; which ones survive must be the reference's exactly.
    With weights for 2 of the 4 experts (``_dispatch_compute``'s contract
    for a shard of them) the other assignments go to the sink and drop."""
    rng = np.random.default_rng(5)
    T, D, Fd, E, k, C = 96, 32, 48, 4, 2, 16
    xf = rng.normal(size=(T, D)).astype(np.float32)
    logits = (rng.normal(size=(T, E)) + np.array([1.5, 0.5, 0, -0.5])).astype(np.float32)
    w = [(rng.normal(size=s) * 0.3).astype(np.float32)[:E_local]
         for s in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]

    # the reference's routing lines (models/moe.py:267-281), in JAX
    topw, topi = jax.lax.top_k(jnp.asarray(logits), k)
    flat_e = topi.reshape(-1)
    flat_e = jnp.where((flat_e >= 0) & (flat_e < E_local), flat_e, E_local)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    pos = jnp.arange(T * k) - jnp.searchsorted(se, se, side="left")
    keep_r = np.asarray((pos < C) & (se < E_local))

    se_t, st_t, sw_t, keep_t, pos_t = moe._route(torch.from_numpy(logits), k, E_local,
                                                 C, torch.float32)
    assert np.array_equal(keep_t.numpy(), keep_r)
    assert not keep_r.all() and keep_r.any()
    assert np.array_equal(se_t.numpy(), np.asarray(se))
    assert np.array_equal(st_t.numpy(), np.asarray(jnp.repeat(jnp.arange(T), k)[order]))
    assert np.array_equal(pos_t.numpy(), np.asarray(pos))

    y_r = rmoe._dispatch_compute(jnp.asarray(xf), jnp.asarray(logits),
                                 *map(jnp.asarray, w), k=k, n_experts=E, C=C,
                                 dtype=jnp.float32)
    y_t = moe._dispatch_compute(torch.from_numpy(xf), torch.from_numpy(logits),
                                *map(torch.from_numpy, w), k=k, n_experts=E, C=C,
                                dtype=torch.float32)
    assert _reldiff(y_t, y_r) < 1e-5


def test_moe_ffn_matches_reference():
    cfg, rcfg = get("moonshot-v1-16b-a3b-smoke"), rget("moonshot-v1-16b-a3b-smoke")
    p = np_params(cfg, 6)["layers"]["moe"]
    p0 = {n: a[0] for n, a in p.items()}
    x = np.random.default_rng(7).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    y_r = rmoe.moe_ffn(_j(p0), jnp.asarray(x), rcfg)
    y_t = moe.moe_ffn({n: torch.from_numpy(a) for n, a in p0.items()},
                      torch.from_numpy(x), cfg)
    assert moe.moe_capacity(cfg, 48) == rmoe.moe_capacity(rcfg, 48)
    assert _reldiff(y_t, y_r) < 1e-5


@pytest.mark.parametrize("arch", ["stablelm-3b-smoke", "moonshot-v1-16b-a3b-smoke"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference_over_chained_steps(arch, microbatches):
    cfg, rcfg, tree, params = _pair(arch, seed=8)
    rp = _j(tree)
    r_opt, t_opt = rsteps.opt_config_for(rcfg), opt_config_for(cfg)
    assert t_opt.moment_dtype == torch.float32
    r_state, t_state = radamw.init(r_opt, rp), adamw.init(t_opt, params)
    r_step = jax.jit(rsteps.make_train_step(rcfg, r_opt, microbatches=microbatches))
    t_step = make_train_step(cfg, t_opt, microbatches=microbatches, device="cpu")
    stream = TokenStream(TokenStreamConfig(cfg.vocab, 16, 4, seed=2))
    for _ in range(5):
        batch = stream.next_batch()
        rp, r_state, m_r = r_step(rp, r_state, _j(batch))
        params, t_state, m_t = t_step(params, t_state, batch)
        for name in ("loss", "grad_norm"):
            assert m_t[name].dtype == torch.float32
            assert abs(float(m_t[name]) - float(m_r[name])) <= 1e-4 * abs(float(m_r[name]))
    assert int(t_state.step) == int(r_state.step) == 5


def test_train_step_rejects_an_indivisible_batch():
    cfg, _, _, params = _pair("stablelm-3b-smoke")
    step = make_train_step(cfg, opt_config_for(cfg), microbatches=3, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        step(params, adamw.init(opt_config_for(cfg), params),
             {"tokens": np.zeros((4, 8), np.int32)})


def test_optimizer_state_crosses_from_the_reference():
    """A reference state a few steps in, carried over, gives the next
    step's metrics the reference gives."""
    cfg, rcfg, tree, params = _pair("stablelm-3b-smoke", seed=12)
    rp = _j(tree)
    r_opt = rsteps.opt_config_for(rcfg)
    r_step = jax.jit(rsteps.make_train_step(rcfg, r_opt))
    state = radamw.init(r_opt, rp)
    stream = TokenStream(TokenStreamConfig(cfg.vocab, 16, 2, seed=3))
    for _ in range(2):
        rp, state, _ = r_step(rp, state, _j(stream.next_batch()))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rp), device="cpu")
    t_state = adamw_state_from_numpy(
        (np.asarray(state.step), jax.tree.map(np.asarray, state.m),
         jax.tree.map(np.asarray, state.v)), device="cpu")
    batch = stream.next_batch()
    _, _, m_r = r_step(rp, state, _j(batch))
    _, t_state, m_t = make_train_step(cfg, opt_config_for(cfg), device="cpu")(
        params, t_state, batch)
    assert int(t_state.step) == 3
    assert abs(float(m_t["loss"]) - float(m_r["loss"])) <= 1e-4 * float(m_r["loss"])
    assert abs(float(m_t["grad_norm"]) - float(m_r["grad_norm"])) <= (
        1e-4 * float(m_r["grad_norm"]))


@pytest.mark.parametrize("arch", ["stablelm-3b-smoke", "moonshot-v1-16b-a3b-smoke"])
def test_server_generate_matches_reference(arch):
    """Greedy tokens equal; the first follows the padded position
    ``cache_cap - 1``, as the reference's does."""
    cfg, rcfg, tree, params = _pair(arch, seed=9)
    prompts = np.random.default_rng(10).integers(0, cfg.vocab, (2, 7)).astype(np.int32)
    ref = RServer(rcfg, jax.make_mesh((1, 1), ("data", "model")), batch=2,
                  prompt_cap=8, gen_cap=6)
    # the reference's MoE path under an installed mesh is its shard_map
    # expert-parallel path, which raises on this jax; run its local path
    rshd.set_activation_mesh(None)
    ref.load_weights(_j(tree))
    server = Server(cfg, batch=2, prompt_cap=8, gen_cap=6, device="cpu")
    server.load_weights(params)
    want = ref.generate(prompts, 6)
    got = server.generate(prompts, 6)
    assert got.dtype == np.int32 and got.shape == (2, 6)
    assert np.array_equal(got, want)
    padded = np.zeros((2, 14), np.int32)
    padded[:, :7] = prompts
    logits, _ = dense.prefill(cfg, params, {"tokens": torch.from_numpy(padded)})
    assert np.array_equal(got[:, 0], logits.argmax(-1).numpy())
    with pytest.raises(ValueError, match="prompt_cap"):
        server.generate(np.zeros((2, 9), np.int32), 1)
    with pytest.raises(ValueError, match="gen_cap"):
        server.generate(prompts, 7)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_round_trip_exact(arch):
    cfg, _, tree, params = _pair(arch, seed=11)
    back = lm_params_to_numpy(params)
    assert [p for p, _ in flatten(back)] == [p for p, _ in flatten(tree)]
    for (_, a), (_, b) in zip(flatten(back), flatten(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert set(params.state_dict()) == {p for p, _ in flatten(tree)}
    bf16 = lm_params_from_numpy(cfg, tree, device="cpu", dtype=torch.bfloat16)
    for (_, a), (_, b) in zip(flatten(lm_params_to_numpy(bf16)), flatten(tree)):
        assert a.dtype == np.float32
        assert np.max(np.abs(a - b)) <= np.max(np.abs(b)) * 2.0 ** -8
    bad = {**tree, "embed": tree["embed"][:-1]}
    with pytest.raises(ValueError, match="does not match"):
        lm_params_from_numpy(cfg, bad, device="cpu")


def test_init_params_dtypes_scale_and_seed():
    cfg = get("moonshot-v1-16b-a3b-smoke")
    a = api.family_for(cfg).init_params(cfg, 0, device="cpu")
    b = dense.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    c = dense.init_params(cfg, 1, device="cpu")
    specs = dict(flatten(dense.param_specs(cfg)))
    for path, t in a.state_dict().items():
        assert t.dtype == specs[path].dtype and t.shape == specs[path].shape, path
        assert torch.equal(t, b.state_dict()[path])
        assert not torch.equal(t, c.state_dict()[path])
    assert a.state_dict()["layers.moe.router"].dtype == torch.float32
    assert a.state_dict()["embed"].dtype == torch.bfloat16
    assert float(a.state_dict()["embed"].float().std()) == pytest.approx(0.02, rel=0.05)


@pytest.mark.parametrize("arch,family", [("xlstm-125m", "XLSTM"), ("zamba2-2.7b", "Zamba2"),
                                         ("whisper-medium", "Whisper")])
def test_family_for_serves_the_recurrent_and_encdec_families(arch, family):
    from repro.models import api as rapi

    for name in (arch, arch + "-smoke"):
        fam = api.family_for(get(name))
        assert fam.__name__ == rapi.family_for(rget(name)).__name__ == family
        assert api.count_params(get(name)) == rapi.count_params(rget(name))


def test_input_and_cache_specs_match_reference():
    from repro.configs.base import ShapeSpec as RShape
    from repro_torch.configs.base import ShapeSpec

    for arch in ARCHS:
        cfg, rcfg = get(arch), rget(arch)
        for kind in ("train", "prefill", "decode"):
            t = dense.input_specs(cfg, ShapeSpec("s", 32, 4, kind))
            r = rdense.input_specs(rcfg, RShape("s", 32, 4, kind))
            assert {k: tuple(v.shape) for k, v in t.items()} == {
                k: v.shape for k, v in r.items()}
        t = dense.cache_specs(cfg, ShapeSpec("s", 32, 4, "decode"))
        r = rdense.cache_specs(rcfg, RShape("s", 32, 4, "decode"))
        assert tuple(t["k"].shape) == r["k"].shape and t["k"].device.type == "meta"


def test_loss_decreases_on_tiny_training():
    """End-to-end on the CPU: 60 steps of the port's train step reduce the
    loss on the structured synthetic stream by more than 0.9 nats (the
    reference's own test and bound)."""
    cfg = get("stablelm-3b-smoke")
    params = dense.init_params(cfg, 0, device="cpu")
    opt_cfg = adamw.AdamWConfig(lr=3e-3)
    opt_state = adamw.init(opt_cfg, params)
    step = make_train_step(cfg, opt_cfg, device="cpu")
    stream = TokenStream(TokenStreamConfig(cfg.vocab, 64, 16, seed=1))
    losses = []
    for _ in range(60):
        params, opt_state, m = step(params, opt_state, stream.next_batch())
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.9, losses
