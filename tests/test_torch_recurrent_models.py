"""The port's recurrent (XLSTM, Zamba2) and encoder-decoder (Whisper)
families against the reference's, on the same numpy parameters and
inputs in fp32 (std 0.3, from a seed; at the init scale every smoke
model predicts close to uniform), B = 2, S = 64.

Tolerances (fp32, absolute): ``loss`` 1e-4; ``prefill`` logits 1e-4 and
every cache leaf 1e-5 of its largest magnitude; 3 chained ``decode``
steps' logits 1e-4; gradients within 1e-4 of each leaf's largest
magnitude; 3 chained ``make_train_step`` steps' ``loss`` and
``grad_norm`` within 1e-4 relative; greedy tokens equal; structure,
shapes and dtypes exact.  The reference's own gaps set the scale:
XLSTM's decode after a prefill equals a longer prefill exactly, Zamba2's
within ~4e-6.

Zamba2's gradients and train steps hold the port to the reference with
its SSD at ``chunk`` 16: at one chunk of 64 the reference's masked
``exp`` overflows and its backward is NaN (``models/ssm.py`` of the
port; pinned in ``tests/test_torch_ssm_xlstm.py``).  The chunking is
exact algebra, so this is the same function.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as RShape
from repro.configs.registry import get as rget
from repro.dist import sharding as rshd
from repro.dist import steps as rsteps
from repro.launch.serve import Server as RServer
from repro.models import api as rapi
from repro.models import common as rcommon
from repro.models import recurrent_lm as rrec
from repro.models import ssm as rssm
from repro.optim import adamw as radamw
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
from repro_torch.dist.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.dist.steps import opt_config_for
from repro_torch.launch.serve import Server
from repro_torch.models import api, common
from repro_torch.models.recurrent_lm import XLSTM, Zamba2
from repro_torch.optim import adamw
from repro_torch.tree import flatten, unflatten

ARCHS = ["xlstm-125m-smoke", "zamba2-2.7b-smoke", "whisper-medium-smoke"]
B, S = 2, 64


@pytest.fixture(autouse=True)
def no_reference_mesh():
    """The reference's ``Server`` installs a process-wide activation mesh;
    clear it so no later test takes the reference's mesh paths."""
    yield
    rshd.set_activation_mesh(None)


@pytest.fixture
def reference_ssd_at_chunk_16(monkeypatch):
    """The reference's Zamba2 with its SSD at chunk 16 (no overflow)."""
    monkeypatch.setattr(rrec, "ssm_forward", functools.partial(rssm.ssm_forward,
                                                               chunk=16))


def np_params(cfg, seed, std=0.3):
    rng = np.random.default_rng(seed)
    return unflatten((p, (rng.normal(size=s.shape) * std).astype(np.float32))
                     for p, s in flatten(api.abstract_params(cfg)))


def np_batch(cfg, seed, S=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(B, cfg.encoder_len, cfg.d_model)).astype(
            np.float32)
    return batch


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _leaves(cache):
    """Cache leaves in the reference's flattening order (dict keys sorted,
    tuples in order)."""
    if isinstance(cache, dict):
        return [x for k in sorted(cache) for x in _leaves(cache[k])]
    if isinstance(cache, (tuple, list)):
        return [x for c in cache for x in _leaves(c)]
    return [cache]


def _pair(arch, seed=0):
    cfg = get(arch)
    tree = np_params(cfg, seed)
    return cfg, rget(arch), tree, lm_params_from_numpy(cfg, tree, device="cpu")


def _decode_positions(cfg):
    # Whisper's self-attention cache holds S slots: decode into its last
    # three (a prompt right-padded as ``Server`` pads it); the recurrent
    # families continue past the prompt (Zamba2's ring buffer wraps)
    return [S - 3, S - 2, S - 1] if cfg.family == "encdec" else [S, S + 1, S + 2]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_prefill_decode_match_reference(arch):
    cfg, rcfg, tree, params = _pair(arch)
    fam, rfam = api.family_for(cfg), rapi.family_for(rcfg)
    rp = _j(tree)
    batch = np_batch(cfg, 1)
    l_r = jax.jit(lambda p, b: rfam.loss(rcfg, p, b))(rp, _j(batch))
    l_t = fam.loss(cfg, params, _t(batch)).detach()
    assert abs(float(l_t) - float(l_r)) < 1e-4
    assert abs(float(l_r) - np.log(cfg.vocab)) > 0.1  # not the uniform predictor

    logits_r, cache_r = jax.jit(lambda p, b: rfam.prefill(rcfg, p, b))(rp, _j(batch))
    logits_t, cache_t = fam.prefill(cfg, params, _t(batch))
    assert logits_t.shape == (B, cfg.padded_vocab)
    assert _maxdiff(logits_t, logits_r) < 1e-4
    assert jax.tree.structure(cache_r) == jax.tree.structure(
        jax.tree.map(np.asarray, cache_t, is_leaf=torch.is_tensor))
    for a, b in zip(_leaves(cache_t), jax.tree.leaves(cache_r)):
        assert a.shape == b.shape and str(a.dtype).removeprefix("torch.") == b.dtype.name
        assert _maxdiff(a, b) <= 1e-5 * max(1.0, float(np.max(np.abs(b))))

    rdecode = jax.jit(lambda p, c, b: rfam.decode(rcfg, p, c, b))
    rng = np.random.default_rng(2)
    for pos in _decode_positions(cfg):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        logits_r, cache_r = rdecode(rp, cache_r, {"token": jnp.asarray(tok),
                                                  "pos": jnp.int32(pos)})
        before = _leaves(cache_t)
        logits_t, cache_t = fam.decode(cfg, params, cache_t,
                                       {"token": torch.from_numpy(tok), "pos": pos})
        # donated: every leaf written in place
        assert all(a is b for a, b in zip(_leaves(cache_t), before))
        assert _maxdiff(logits_t, logits_r) < 1e-4
    for a, b in zip(_leaves(cache_t), jax.tree.leaves(cache_r)):
        assert _maxdiff(a, b) <= 1e-5 * max(1.0, float(np.max(np.abs(b))))


def _ref_grads(rcfg, tree, batch):
    rfam = rapi.family_for(rcfg)
    g = jax.jit(jax.grad(lambda p, b: rfam.loss(rcfg, p, b)))(_j(tree), _j(batch))
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(g)}


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch, reference_ssd_at_chunk_16):
    cfg, rcfg, tree, params = _pair(arch, seed=3)
    batch = np_batch(cfg, 4)
    ref = _ref_grads(rcfg, tree, batch)
    xs = {p: t.clone().requires_grad_() for p, t in params.state_dict().items()}
    loss = api.family_for(cfg).loss(cfg, unflatten(xs.items()), _t(batch))
    g_t = dict(zip(xs, torch.autograd.grad(loss, list(xs.values()))))
    assert set(ref) == set(g_t) == set(params.state_dict())
    for path, g in ref.items():
        scale = float(np.max(np.abs(g)))
        assert np.isfinite(scale) and scale > 0, path
        assert _maxdiff(g_t[path], g) <= 1e-4 * scale, path


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_over_chained_steps(arch, reference_ssd_at_chunk_16):
    cfg, rcfg, tree, params = _pair(arch, seed=8)
    rp = _j(tree)
    r_opt, t_opt = rsteps.opt_config_for(rcfg), opt_config_for(cfg)
    r_state, t_state = radamw.init(r_opt, rp), adamw.init(t_opt, params)
    r_step = jax.jit(rsteps.make_train_step(rcfg, r_opt))
    t_step = make_train_step(cfg, t_opt, device="cpu")
    stream = TokenStream(TokenStreamConfig(cfg.vocab, 32, B, seed=2))
    rng = np.random.default_rng(5)
    for _ in range(3):
        batch = stream.next_batch()
        if cfg.family == "encdec":
            batch["frames"] = rng.normal(size=(B, cfg.encoder_len, cfg.d_model)).astype(
                np.float32)
        rp, r_state, m_r = r_step(rp, r_state, _j(batch))
        params, t_state, m_t = t_step(params, t_state, batch)
        for name in ("loss", "grad_norm"):
            assert m_t[name].dtype == torch.float32
            assert abs(float(m_t[name]) - float(m_r[name])) <= 1e-4 * abs(float(m_r[name]))
    assert int(t_state.step) == int(r_state.step) == 3


@pytest.mark.parametrize("arch", ["xlstm-125m-smoke", "zamba2-2.7b-smoke"])
def test_prefill_then_decode_equals_a_longer_prefill(arch):
    """The decode after a prefill of S against a prefill of S + 1 (the
    reference's own gap: XLSTM 0, Zamba2 ~4e-6; tolerance 1e-5)."""
    cfg, rcfg, tree, params = _pair(arch, seed=6)
    fam, rfam = api.family_for(cfg), rapi.family_for(rcfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    _, cache = fam.prefill(cfg, params, {"tokens": torch.from_numpy(tokens[:, :S])})
    step, _ = fam.decode(cfg, params, cache, {"token": torch.from_numpy(tokens[:, S:]),
                                              "pos": S})
    longer, _ = fam.prefill(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert _maxdiff(step, longer) <= 1e-5
    rp = _j(tree)
    _, rc = rfam.prefill(rcfg, rp, {"tokens": jnp.asarray(tokens[:, :S])})
    r_step, _ = rfam.decode(rcfg, rp, rc, {"token": jnp.asarray(tokens[:, S:]),
                                           "pos": jnp.int32(S)})
    r_longer, _ = rfam.prefill(rcfg, rp, {"tokens": jnp.asarray(tokens)})
    assert _maxdiff(r_step, r_longer) <= 1e-5
    assert _maxdiff(step, r_step) < 1e-4


def test_zamba2_ring_buffer_overwrites_a_key_that_is_not_the_oldest():
    """A reference caveat the port follows: after a prefill of S = 80 the
    window (64) keeps positions 16..79 at slots 0..63, and decode at pos
    80 writes slot 80 mod 64 = 16, which holds position 32, not the
    oldest (16, at slot 0).  Port and reference agree on the cache and
    logits, and both differ from a prefill of 81."""
    cfg, rcfg, tree, params = _pair("zamba2-2.7b-smoke", seed=10)
    assert cfg.window == 64
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (B, 81)).astype(np.int32)
    _, cache = Zamba2.prefill(cfg, params, {"tokens": torch.from_numpy(tokens[:, :80])})
    k_before = cache[1][0].clone()
    _, k_pre81 = Zamba2.prefill(cfg, params, {"tokens": torch.from_numpy(tokens)})
    logits, cache = Zamba2.decode(cfg, params, cache,
                                  {"token": torch.from_numpy(tokens[:, 80:]), "pos": 80})
    k_after = cache[1][0]  # [G, B, W, Hkv, hd]
    changed = [s for s in range(64) if not torch.equal(k_after[:, :, s], k_before[:, :, s])]
    assert changed == [16]
    # slot 16 now holds position 80's key (group 0's: the later groups'
    # inputs already differ by the caveat)
    assert _maxdiff(k_after[0, :, 16], k_pre81[1][0][0, :, -1]) <= 1e-4
    rp = _j(tree)
    _, rc = rrec.Zamba2.prefill(rcfg, rp, {"tokens": jnp.asarray(tokens[:, :80])})
    r_logits, rc = rrec.Zamba2.decode(rcfg, rp, rc, {
        "token": jnp.asarray(tokens[:, 80:]), "pos": jnp.int32(80)})
    assert _maxdiff(logits, r_logits) < 1e-4
    assert _maxdiff(k_after, rc[1][0]) <= 1e-5 * float(np.max(np.abs(np.asarray(rc[1][0]))))
    longer, _ = Zamba2.prefill(cfg, params, {"tokens": torch.from_numpy(tokens)})
    r_longer, _ = rrec.Zamba2.prefill(rcfg, rp, {"tokens": jnp.asarray(tokens)})
    assert _maxdiff(logits, longer) > 1e-3 and _maxdiff(r_logits, r_longer) > 1e-3


def test_xlstm_decode_ignores_pos():
    """A reference caveat the port follows: the state carries the
    position, ``batch["pos"]`` is not read."""
    cfg, _, _, params = _pair("xlstm-125m-smoke", seed=12)
    tokens = torch.from_numpy(np_batch(cfg, 13, S=16)["tokens"])
    outs = []
    for pos in (0, 16, 1000):
        _, cache = XLSTM.prefill(cfg, params, {"tokens": tokens})
        outs.append(XLSTM.decode(cfg, params, cache, {"token": tokens[:, :1], "pos": pos})[0])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("arch", ["xlstm-125m-smoke", "zamba2-2.7b-smoke"])
def test_server_generate_matches_reference(arch):
    """Greedy tokens equal.  A reference caveat the port follows: the
    prompt is right-padded to ``cache_cap``, so the recurrent prefill
    folds the pads into the state and the first token follows the last
    pad."""
    cfg, rcfg, tree, params = _pair(arch, seed=9)
    prompts = np.random.default_rng(10).integers(0, cfg.vocab, (B, 7)).astype(np.int32)
    ref = RServer(rcfg, jax.make_mesh((1, 1), ("data", "model")), batch=B,
                  prompt_cap=8, gen_cap=6)
    # under the mesh the reference installs, its sharding hints raise on
    # this jax; on one device they are no-ops, so run without them
    rshd.set_activation_mesh(None)
    ref.load_weights(_j(tree))
    server = Server(cfg, batch=B, prompt_cap=8, gen_cap=6, device="cpu")
    server.load_weights(params)
    want = ref.generate(prompts, 6)
    got = server.generate(prompts, 6)
    assert got.dtype == np.int32 and got.shape == (B, 6)
    assert np.array_equal(got, want)
    padded = np.zeros((B, 14), np.int32)
    padded[:, :7] = prompts
    logits, _ = api.family_for(cfg).prefill(cfg, params, {"tokens": torch.from_numpy(padded)})
    assert np.array_equal(got[:, 0], logits.argmax(-1).numpy())


def test_server_without_frames_raises_keyerror_for_whisper():
    """``Server.generate`` sends no ``frames``: both packages' Whisper
    prefill raises ``KeyError``; Whisper is served through the step
    builders (next test)."""
    cfg, rcfg, tree, params = _pair("whisper-medium-smoke", seed=14)
    prompts = np.zeros((B, 4), np.int32)
    ref = RServer(rcfg, jax.make_mesh((1, 1), ("data", "model")), batch=B,
                  prompt_cap=4, gen_cap=2)
    rshd.set_activation_mesh(None)
    ref.load_weights(_j(tree))
    with pytest.raises(KeyError, match="frames"):
        ref.generate(prompts, 2)
    server = Server(cfg, batch=B, prompt_cap=4, gen_cap=2, device="cpu")
    server.load_weights(params)
    with pytest.raises(KeyError, match="frames"):
        server.generate(prompts, 2)


def test_whisper_through_the_step_builders_matches_reference():
    """``make_prefill_step`` on frames and a right-padded prompt, then
    greedy ``make_decode_step`` steps from the prompt's end: the tokens
    equal the reference's step builders'."""
    cfg, rcfg, tree, params = _pair("whisper-medium-smoke", seed=15)
    batch = np_batch(cfg, 16, S=24)
    batch["tokens"][:, 16:] = 0
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    r_prefill = jax.jit(rsteps.make_prefill_step(rcfg))
    r_decode = jax.jit(rsteps.make_decode_step(rcfg))
    rp = _j(tree)
    logits, cache = prefill(params, _t(batch))
    r_logits, r_cache = r_prefill(rp, _j(batch))
    assert _maxdiff(logits, r_logits) < 1e-4
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    r_tok = jnp.argmax(r_logits, -1).astype(jnp.int32)[:, None]
    for pos in range(16, 24):
        assert np.array_equal(tok.numpy(), np.asarray(r_tok))
        tok, cache = decode(params, cache, {"token": tok, "pos": pos})
        r_tok, r_cache = r_decode(rp, r_cache, {"token": r_tok, "pos": jnp.int32(pos)})
        tok, r_tok = tok[:, None], r_tok[:, None]
    assert np.array_equal(tok.numpy(), np.asarray(r_tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_reference(arch):
    cfg, rcfg = get(arch), rget(arch)
    fam, rfam = api.family_for(cfg), rapi.family_for(rcfg)

    def shapes(tree, port):
        leaves = _leaves(tree) if port else jax.tree.leaves(tree)
        return [(tuple(s.shape), str(s.dtype).removeprefix("torch.") if port
                 else s.dtype.name) for s in leaves]

    for kind in ("train", "prefill", "decode"):
        t = fam.input_specs(cfg, ShapeSpec("s", 32, 4, kind))
        r = rfam.input_specs(rcfg, RShape("s", 32, 4, kind))
        assert sorted(t) == sorted(r)
        assert shapes(t, True) == shapes(r, False)
    for seq in (32, 100):  # Zamba2's ring buffer: min(window, seq)
        t = fam.cache_specs(cfg, ShapeSpec("s", seq, 4, "decode"))
        r = rfam.cache_specs(rcfg, RShape("s", seq, 4, "decode"))
        assert shapes(t, True) == shapes(r, False)
        assert all(s.device.type == "meta" for s in _leaves(t))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_round_trip_exact(arch):
    cfg, _, tree, params = _pair(arch, seed=11)
    back = lm_params_to_numpy(params)
    assert [p for p, _ in flatten(back)] == [p for p, _ in flatten(tree)]
    for (_, a), (_, b) in zip(flatten(back), flatten(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert isinstance(params, common.LMParams)
    bad = {**tree, "embed": tree["embed"][:-1]}
    with pytest.raises(ValueError, match="does not match"):
        lm_params_from_numpy(cfg, bad, device="cpu")


FP32_LEAVES = {"A_log", "D", "dt_bias", "wi", "wf", "ri", "rf"}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_dtypes_scale_and_seed(arch):
    cfg = get(arch)
    fam = api.family_for(cfg)
    a = fam.init_params(cfg, 0, device="cpu")
    b = fam.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    specs = dict(flatten(fam.param_specs(cfg)))
    assert set(a.state_dict()) == set(specs)
    for path, t in a.state_dict().items():
        want = torch.float32 if path.rsplit(".", 1)[-1] in FP32_LEAVES else torch.bfloat16
        assert t.dtype == specs[path].dtype == want, path
        assert t.shape == specs[path].shape, path
        assert torch.equal(t, b.state_dict()[path])
    assert float(a.state_dict()["embed"].float().std()) == pytest.approx(0.02, rel=0.05)
    if not torch.cuda.is_available():  # the card by default: raises without one
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fam.init_params(cfg, 0)


def test_stack_apply_with_state_returns_the_layer_outputs():
    """``stack_apply_with_state`` returns ``layer_fn``'s state outputs
    stacked on axis 0 in their own structure, as the reference does: a
    4-tuple in and a 2-tuple out of other shapes (Whisper's decode), and
    a nested state (Zamba2's); an output leaf of the input leaf's shape
    and dtype is written into it in place."""
    rng = np.random.default_rng(17)
    L = 3
    params = {"w": rng.normal(size=(L, 4)).astype(np.float32)}
    x = rng.normal(size=(4,)).astype(np.float32)
    flat = tuple(rng.normal(size=(L, 4)).astype(np.float32) for _ in range(4))
    nested = ((rng.normal(size=(L, 2, 4)).astype(np.float32),
               rng.normal(size=(L, 4)).astype(np.float32)),
              (rng.normal(size=(L, 4)).astype(np.float32),))

    def four_to_two(p, h, s):
        a, b, c, d = s
        return h * p["w"] + a, (a + c * h, (b * d).sum()[None] + p["w"][:2])

    def nested_fn(p, h, s):
        (m, n), (k,) = s
        return h + n, ((m * p["w"], n + h), (k - h,))

    for fn, state in ((four_to_two, flat), (nested_fn, nested)):
        h_r, s_r = rcommon.stack_apply_with_state(fn, _j(params), jnp.asarray(x),
                                                  _j(state), unrolled=False)
        ts = jax.tree.map(torch.from_numpy, state)
        h_t, s_t = common.stack_apply_with_state(
            fn, jax.tree.map(torch.from_numpy, params), torch.from_numpy(x), ts)
        assert jax.tree.structure(s_r) == jax.tree.structure(
            jax.tree.map(np.asarray, s_t, is_leaf=torch.is_tensor))
        assert _maxdiff(h_t, h_r) <= 1e-6
        for a, b in zip(_leaves(s_t), jax.tree.leaves(s_r)):
            assert a.shape == b.shape and _maxdiff(a, b) <= 1e-6
        # the leaves of the input's shape were written in place
        assert s_t[0] is ts[0] if fn is four_to_two else s_t[0][1] is ts[0][1]
