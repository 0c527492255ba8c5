"""The port's Mamba2 (SSD) and xLSTM blocks against the reference's, on
the same numpy parameters and inputs in fp32 (std 0.3, from a seed).

``ssm_forward`` and ``mlstm_forward`` run at ``chunk`` 16 (S = 64: four
chunks, so the carried inter-chunk state is exercised) and at 256 (one
chunk).  Each decode step is chained over 8 steps from the empty state.

Tolerances (fp32): block outputs 1e-5 of the output's largest
magnitude; decode outputs and states 1e-5 of their
largest magnitudes at every step; gradients (of ``sum(out * r)`` for a
random ``r``) within 1e-4 of each leaf's largest magnitude, the input's
included; the chunked forms against the port's own step scans 1e-4 of
the largest output.  Exact: the chunk-length refusal, the bf16 key scale
and the bf16 causal conv's taps (its SiLU within 2 bf16 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get as rget
from repro.models import ssm as rssm
from repro.models import xlstm as rxlstm
from repro_torch.configs.registry import get
from repro_torch.models import ssm, xlstm
from repro_torch.tree import flatten, unflatten

B, S = 2, 64
OUT_TOL, GRAD_TOL = 1e-5, 1e-4

BLOCKS = {
    # name: (arch, param specs, port forward, reference forward)
    "ssm": ("zamba2-2.7b-smoke", ssm.ssm_param_specs, ssm.ssm_forward,
            rssm.ssm_forward),
    "mlstm": ("xlstm-125m-smoke", xlstm.mlstm_param_specs, xlstm.mlstm_forward,
              rxlstm.mlstm_forward),
    "slstm": ("xlstm-125m-smoke", xlstm.slstm_param_specs, xlstm.slstm_forward,
              rxlstm.slstm_forward),
}


def np_block(specs, seed, std=0.3):
    rng = np.random.default_rng(seed)
    return unflatten((p, (rng.normal(size=s.shape) * std).astype(np.float32))
                     for p, s in flatten(specs))


def _rel(a, b):
    b = np.asarray(b)
    return float(np.max(np.abs(np.asarray(a) - b))) / float(np.max(np.abs(b)))


def _case(name, chunk):
    arch, specs, fwd, rfwd = BLOCKS[name]
    cfg, rcfg = get(arch), rget(arch)
    tree = np_block(specs(cfg), 0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    r = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    kw = {} if chunk is None else {"chunk": chunk}
    return cfg, rcfg, tree, x, r, (lambda p, xx: fwd(p, xx, cfg, **kw)), (
        lambda p, xx: rfwd(p, xx, rcfg, **kw))


CASES = [("ssm", 16), ("ssm", 256), ("mlstm", 16), ("mlstm", 256), ("slstm", None)]


@pytest.mark.parametrize("name,chunk", CASES)
def test_block_forward_matches_reference(name, chunk):
    _, _, tree, x, _, fwd, rfwd = _case(name, chunk)
    want = jax.jit(rfwd)(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    got = fwd(jax.tree.map(torch.from_numpy, tree), torch.from_numpy(x))
    assert got.shape == (B, S, x.shape[-1]) and got.dtype == torch.float32
    assert _rel(got, want) <= OUT_TOL


def _ref_grads(tree, x, r, rfwd):
    g = jax.jit(jax.grad(lambda p, xx: jnp.sum(rfwd(p, xx) * r), argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    out = dict(flatten(jax.tree.map(np.asarray, g[0])))
    out["x"] = np.asarray(g[1])
    return out


@pytest.mark.parametrize("name,chunk", CASES)
def test_block_gradients_match_reference(name, chunk):
    """Per leaf against ``jax.grad`` of the reference at the same chunk.
    The reference's SSD backward at one chunk of 64 is NaN through ``dt``
    and the input (its masked ``exp`` overflows; ``models/ssm.py``); the
    port's is finite there and equals the reference's at chunk 16, the
    same function evaluated without the overflow, and equals the
    reference at 256 wherever that is finite."""
    _, _, tree, x, r, fwd, rfwd = _case(name, chunk)
    ref = _ref_grads(tree, x, r, rfwd)
    overflowed = any(np.isnan(g).any() for g in ref.values())
    assert overflowed == (name == "ssm" and chunk == 256)
    if overflowed:
        ref16 = _ref_grads(tree, x, r, _case(name, 16)[6])
    leaves = {p: torch.from_numpy(a).requires_grad_() for p, a in flatten(tree)}
    xt = torch.from_numpy(x).requires_grad_()
    out = fwd(unflatten(leaves.items()), xt)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(r)),
                                [*leaves.values(), xt])
    got = {p: g.numpy() for p, g in zip([*leaves, "x"], grads)}
    assert set(got) == set(ref)
    for path, g in ref.items():
        assert np.isfinite(got[path]).all(), path
        finite = np.isfinite(g)
        scale = float(np.max(np.abs(g[finite]))) if finite.any() else 0.0
        if overflowed:
            scale = float(np.max(np.abs(ref16[path])))
            assert _rel(got[path], ref16[path]) <= GRAD_TOL, path
        assert scale > 0, path
        assert float(np.max(np.abs(got[path][finite] - g[finite]), initial=0)) <= (
            GRAD_TOL * scale), path


def _state0(name, cfg, port: bool):
    """The empty decode state of each block (the reference's prefill
    starts from these)."""
    if name == "ssm":
        d_inner, H, P, N = ssm.ssm_dims(cfg)
        st = (np.zeros((B, ssm.CONV_K - 1, d_inner + 2 * N), np.float32),
              np.zeros((B, H, N, P), np.float32))
    else:
        D, H, hd = xlstm.xlstm_dims(cfg)
        if name == "mlstm":
            st = (np.zeros((B, H, hd, hd), np.float32), np.zeros((B, H, hd), np.float32),
                  np.full((B, H), -1e30, np.float32))
        else:
            st = (np.zeros((B, D), np.float32), np.zeros((B, D), np.float32),
                  np.full((B, D), -1e30, np.float32), np.zeros((B, D), np.float32))
    conv = torch.from_numpy if port else jnp.asarray
    return tuple(conv(a) for a in st)


STEPS = {"ssm": (ssm.ssm_decode_step, rssm.ssm_decode_step),
         "mlstm": (xlstm.mlstm_decode_step, rxlstm.mlstm_decode_step),
         "slstm": (xlstm.slstm_decode_step, rxlstm.slstm_decode_step)}


@pytest.mark.parametrize("name", ["ssm", "mlstm", "slstm"])
def test_decode_steps_chained_match_reference(name):
    arch, specs, _, _ = BLOCKS[name]
    cfg, rcfg = get(arch), rget(arch)
    step, rstep = STEPS[name]
    tree = np_block(specs(cfg), 2)
    pt, pr = jax.tree.map(torch.from_numpy, tree), jax.tree.map(jnp.asarray, tree)
    st, sr = _state0(name, cfg, True), _state0(name, cfg, False)
    rstep = jax.jit(lambda p, x, c, f=rstep: f(p, x, c, rcfg))
    xs = np.random.default_rng(3).normal(size=(8, B, 1, cfg.d_model)).astype(np.float32)
    for x in xs:
        y_r, sr = rstep(pr, jnp.asarray(x), sr)
        y_t, st = step(pt, torch.from_numpy(x), st, cfg)
        assert y_t.shape == (B, 1, cfg.d_model)
        assert _rel(y_t, y_r) <= OUT_TOL
        assert len(st) == len(sr)
        for a, b in zip(st, sr):
            assert a.shape == b.shape and a.dtype == torch.float32
            assert _rel(a, b) <= OUT_TOL


@pytest.mark.parametrize("name", ["ssm", "mlstm"])
def test_chunked_forward_equals_the_step_scan(name):
    """The chunked form at chunk 16 against the port's own decode steps
    over the same 64 positions (the recurrence both compute)."""
    cfg, _, tree, x, _, fwd, _ = _case(name, 16)
    p = jax.tree.map(torch.from_numpy, tree)
    st, ys = _state0(name, cfg, True), []
    for t in range(S):
        y, st = STEPS[name][0](p, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        ys.append(y)
    assert _rel(fwd(p, torch.from_numpy(x)), torch.cat(ys, 1)) <= 1e-4


@pytest.mark.parametrize("name", ["ssm", "mlstm"])
def test_chunk_that_does_not_divide_raises(name):
    """A divergence by design: the reference ``assert``s ``S % Q == 0``
    (gone under ``python -O``); the port raises ``ValueError``."""
    _, _, tree, x, _, _, _ = _case(name, None)
    arch, _, fwd, _ = BLOCKS[name]
    with pytest.raises(ValueError, match="chunks of 16"):
        fwd(jax.tree.map(torch.from_numpy, tree), torch.from_numpy(x[:, :40]), get(arch),
            chunk=16)
    assert ssm.chunk_len(48, 256) == 48 and ssm.chunk_len(1024, 256) == 256


def test_key_scale_is_rounded_to_the_activation_dtype():
    assert xlstm._key_scale(192, torch.bfloat16) == 13.875
    assert xlstm._key_scale(192, torch.float32) == float(np.float32(np.sqrt(192)))
    assert float(jnp.sqrt(jnp.float32(192)).astype(jnp.bfloat16)) == 13.875


def test_causal_conv_in_bf16_matches_reference(monkeypatch):
    """The four taps summed in the reference's order from 0, each product
    and sum rounded to bf16: with the SiLU taken out of both, equal to
    the reference's bf16 conv run op by op; with it, within 2 bf16 ulps
    (the two libraries round the SiLU differently)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 48)).astype(np.float32)
    w = rng.normal(size=(ssm.CONV_K, 48)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)]
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b)]
    want = np.asarray(jax.jit(rssm._causal_conv)(*jargs), np.float32)
    got = ssm._causal_conv(*targs)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
    assert np.all(np.abs(got.float().numpy() - want) <= 2 * ulp)
    with monkeypatch.context() as m:
        m.setattr(jax.nn, "silu", lambda v: v)
        m.setattr(ssm.F, "silu", lambda v: v)
        taps_r = np.asarray(rssm._causal_conv(*jargs), np.float32)
        taps_t = ssm._causal_conv(*targs).float().numpy()
    assert np.array_equal(taps_t, taps_r)
