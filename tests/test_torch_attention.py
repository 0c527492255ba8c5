"""The port's attention paths, RoPE and loss against the reference's
(``tests/test_attention.py``'s cases), with ``ATTN_CHUNK`` set to 16 in
both packages, on the same numpy inputs in fp32.

Tolerances: forward 2e-5 and backward 5e-5 max abs (the reference's own
flash-vs-plain bounds), ``causal_lm_loss`` 1e-5; ``attention_block``'s outputs and caches within
1e-5 of their largest magnitude, the cache slots it does not write
exactly unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as rcm
import repro_torch.models.common as cm
from repro.configs.registry import get as rget
from repro_torch.configs.registry import get


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(rcm, "ATTN_CHUNK", 16)
    monkeypatch.setattr(cm, "ATTN_CHUNK", 16)


def _qkv(rng, B=2, Sq=48, Skv=48, Hq=8, Hkv=4, hd=16):
    return (rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32))


def _t(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _reldiff(a, b):
    return _maxdiff(a, b) / float(np.max(np.abs(np.asarray(b))))


CASES = [(True, 0, 48), (True, 24, 48), (False, 0, 50), (True, 0, 70)]


@pytest.mark.parametrize("causal,window,Skv", CASES)
def test_flash_forward_matches_plain_and_reference(causal, window, Skv):
    q, k, v = _qkv(np.random.default_rng(0), Skv=Skv)
    ref_f = rcm._flash_attention(*map(jnp.asarray, (q, k, v)), causal, 0, window)
    ref_p = rcm._plain_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 q_offset=0, window=window, kv_len=None)
    out_f = cm._flash_attention(*_t(q, k, v), causal, 0, window)
    out_p = cm._plain_attention(*_t(q, k, v), causal=causal, q_offset=0,
                                window=window, kv_len=None)
    assert _maxdiff(out_f, out_p) < 2e-5
    assert _maxdiff(out_f, ref_f) < 2e-5
    assert _maxdiff(out_p, ref_p) < 2e-5


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_flash_backward_matches_plain_and_reference(causal, window):
    q, k, v = _qkv(np.random.default_rng(1))

    def ref_loss(q, k, v):
        return jnp.sum(jnp.sin(rcm._flash_attention(q, k, v, causal, 0, window)))

    g_ref = jax.grad(ref_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    grads = []
    for fn in (lambda *a: cm._flash_attention(*a, causal, 0, window),
               lambda *a: cm._plain_attention(*a, causal=causal, q_offset=0,
                                              window=window, kv_len=None)):
        args = _t(q, k, v, grad=True)
        grads.append(torch.autograd.grad(torch.sum(torch.sin(fn(*args))), args))
    for gf, gp, gr in zip(*grads, g_ref):
        assert _maxdiff(gf, gp) < 5e-5
        assert _maxdiff(gf, gr) < 5e-5


def test_all_masked_rows_follow_the_reference():
    """Rows with no key left (an offset before every key): the -1e30 mask
    gives finite outputs, not NaN.  The plain path averages v uniformly;
    the streaming path also weighs the block padding's zero keys, as the
    reference's does."""
    q, k, v = _qkv(np.random.default_rng(6), Sq=20, Skv=40)
    args = tuple(map(jnp.asarray, (q, k, v)))
    ref_f = rcm._flash_attention(*args, True, -25, 4)
    ref_p = rcm._plain_attention(*args, causal=True, q_offset=-25, window=4,
                                 kv_len=None)
    out_f = cm._flash_attention(*_t(q, k, v), True, -25, 4)
    out_p = cm._plain_attention(*_t(q, k, v), causal=True, q_offset=-25, window=4,
                                kv_len=None)
    assert torch.isfinite(out_f).all() and torch.isfinite(out_p).all()
    uniform = np.repeat(v.mean(axis=1, keepdims=True), 2, axis=2)  # GQA rep 2
    assert _maxdiff(out_p, np.broadcast_to(uniform, out_p.shape)) < 1e-5
    assert _maxdiff(out_p, ref_p) < 2e-5
    assert _maxdiff(out_f, ref_f) < 2e-5


def test_gqa_attention_path_rule(monkeypatch):
    calls = []
    monkeypatch.setattr(cm, "ATTN_CHUNK_THRESHOLD", 32)
    monkeypatch.setattr(cm, "_flash_attention", lambda *a: calls.append(a) or a[0])
    q, k, v = _t(*_qkv(np.random.default_rng(7), Sq=2, Skv=33))
    cm.gqa_attention(q, k, v, causal=True)
    assert len(calls) == 1
    cm.gqa_attention(q, k, v, causal=False, kv_len=20)  # decode masking: plain
    cm.gqa_attention(q[:, :1], k, v, causal=True)  # one query: plain
    cm.gqa_attention(q, k[:, :32], v[:, :32], causal=True)  # at the threshold
    assert len(calls) == 1


def test_decode_path_uses_kv_len_mask():
    """Garbage beyond kv_len must not affect the output."""
    q, k, v = _t(*_qkv(np.random.default_rng(2), Sq=1, Skv=32))
    k2, v2 = k.clone(), v.clone()
    k2[:, 20:] = 999.0
    v2[:, 20:] = -999.0
    out1 = cm.gqa_attention(q, k, v, causal=False, kv_len=20)
    out2 = cm.gqa_attention(q, k2, v2, causal=False, kv_len=20)
    assert _maxdiff(out1, out2) < 1e-6
    ref = rcm.gqa_attention(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())),
                            causal=False, kv_len=jnp.int32(20))
    assert _maxdiff(out1, ref) < 2e-5


def test_rope_relative_property_and_reference():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(1, 1, 1, 32)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(1, 1, 1, 32)).astype(np.float32))

    def dot_at(p_q, p_k):
        xq = cm.rope(x, torch.tensor([[p_q]]), 10000.0)
        yk = cm.rope(y, torch.tensor([[p_k]]), 10000.0)
        return float(torch.sum(xq * yk))

    assert abs(dot_at(5, 3) - dot_at(105, 103)) < 1e-3
    assert abs(dot_at(5, 3) - dot_at(6, 3)) > 1e-4  # sanity: not constant
    z = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = np.arange(9)[None] + 1000
    ref = rcm.rope(jnp.asarray(z), jnp.asarray(pos), 10000.0)
    assert _maxdiff(cm.rope(torch.from_numpy(z), torch.from_numpy(pos), 10000.0),
                    ref) < 1e-5


def test_rms_norm_and_swiglu_match_reference():
    rng = np.random.default_rng(8)
    x, s = rng.normal(size=(2, 5, 16)).astype(np.float32), rng.normal(size=16).astype(np.float32)
    assert _maxdiff(cm.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
                    rcm.rms_norm(jnp.asarray(x), jnp.asarray(s))) < 1e-6
    w = [rng.normal(size=sh).astype(np.float32) for sh in ((16, 24), (16, 24), (24, 16))]
    assert _maxdiff(cm.swiglu(torch.from_numpy(x), *map(torch.from_numpy, w)),
                    rcm.swiglu(jnp.asarray(x), *map(jnp.asarray, w))) < 1e-4


def test_causal_lm_loss_masks_padded_vocab_and_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 8, 16)).astype(np.float32)
    tokens = rng.integers(0, 10, (2, 8)).astype(np.int32)
    l1 = cm.causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(tokens), 10)
    logits2 = logits.copy()
    logits2[:, :, 10:] = 1e4  # huge logits on padded rows must not matter
    l2 = cm.causal_lm_loss(torch.from_numpy(logits2), torch.from_numpy(tokens), 10)
    assert abs(float(l1) - float(l2)) < 1e-4
    ref = rcm.causal_lm_loss(jnp.asarray(logits), jnp.asarray(tokens), true_vocab=10)
    assert abs(float(l1) - float(ref)) < 1e-5


def _block_params(cfg, rng):
    D, hq, hkv = cfg.d_model, cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {"wq": (D, hq), "wk": (D, hkv), "wv": (D, hkv), "wo": (hq, D)}
    return {n: (rng.normal(size=s) * 0.3).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("arch", ["stablelm-3b-smoke", "starcoder2-7b-smoke"])
@pytest.mark.parametrize("S,pos", [(3, 0), (1, 13), (2, 30), (1, 32), (3, 32)])
def test_attention_block_with_cache_matches_reference(arch, S, pos):
    """Cache writes at the start, in the middle, and past the end
    (``pos >= Smax - S``): the reference's ``dynamic_update_slice``
    clamps the write to ``Smax - S`` while q_offset and kv_len keep
    ``pos``; the port must do the same."""
    cfg, rcfg = get(arch), rget(arch)
    rng = np.random.default_rng(S * 100 + pos)
    p = _block_params(cfg, rng)
    B, Smax = 2, 32
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    kc = rng.normal(size=(B, Smax, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    positions = np.arange(S) + pos
    out_r, (kr, vr) = rcm.attention_block(
        rcm.AttnParams(**{n: jnp.asarray(a) for n, a in p.items()}), jnp.asarray(x),
        rcfg, positions=jnp.asarray(positions), cache_kv=(jnp.asarray(kc), jnp.asarray(vc)),
        cache_pos=jnp.int32(pos),
    )
    kt, vt = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out_t, (kt2, vt2) = cm.attention_block(
        cm.AttnParams(**{n: torch.from_numpy(a) for n, a in p.items()}),
        torch.from_numpy(x), cfg, positions=torch.from_numpy(positions),
        cache_kv=(kt, vt), cache_pos=pos,
    )
    assert kt2 is kt and vt2 is vt  # written in place
    start = min(pos, Smax - S)
    untouched = np.ones(Smax, bool)
    untouched[start:start + S] = False
    assert np.array_equal(kt2.numpy()[:, untouched], kc[:, untouched])
    assert _reldiff(kt2, kr) < 1e-5 and _reldiff(vt2, vr) < 1e-5
    assert _reldiff(out_t, out_r) < 1e-5


def test_attention_block_without_cache_streams_like_reference(monkeypatch):
    """Above the threshold the block takes the streaming path in both."""
    monkeypatch.setattr(rcm, "ATTN_CHUNK_THRESHOLD", 32)
    monkeypatch.setattr(cm, "ATTN_CHUNK_THRESHOLD", 32)
    cfg, rcfg = get("starcoder2-7b-smoke"), rget("starcoder2-7b-smoke")
    rng = np.random.default_rng(11)
    p = _block_params(cfg, rng)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    out_r, (kr, _) = rcm.attention_block(
        rcm.AttnParams(**{n: jnp.asarray(a) for n, a in p.items()}), jnp.asarray(x),
        rcfg, positions=jnp.arange(40))
    out_t, (kt, _) = cm.attention_block(
        cm.AttnParams(**{n: torch.from_numpy(a) for n, a in p.items()}),
        torch.from_numpy(x), cfg, positions=torch.arange(40))
    assert _reldiff(out_t, out_r) < 1e-5 and _reldiff(kt, kr) < 1e-5
