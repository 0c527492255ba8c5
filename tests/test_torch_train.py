"""Training in the port (``repro_torch.core.train`` and
``repro_torch.kernels.tm_train`` on the CPU: the plain twins) against the
JAX reference (``repro.core.train``, ``repro.kernels.tm_train``), on the
same numpy inputs, bit for bit (tolerance 0): the sequential and
summed-delta trainers, resumable steps at offsets 0, 1 and 7, ``fit``
with its shuffles, the class-slice delta, the packed representation,
the fused step (twin and oracle) with all-excluded clauses and ragged
batches, and the training clause words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tm as jtm
from repro.core import train as jtrain
from repro.kernels import tm_train as jtt
from repro_torch.core import prng
from repro_torch.core import tm
from repro_torch.core import train
from repro_torch.core.bits import to_u32
from repro_torch.kernels import tm_train as tt

# (M, C, F, B): tiny; C > 32 with a ragged batch; a sub-word batch
SHAPES = [(2, 6, 5, 16), (3, 40, 11, 33), (5, 10, 16, 7)]


def _cfgs(M, C, F):
    return jtm.TMConfig(M, C, F), tm.TMConfig(M, C, F)


def _state(rng, M, C, F, kind="random"):
    """int32[M, C, 2F] TA states: random over [1, 2N] with rows at both
    walls and on both sides of the action boundary, or all excluded."""
    if kind == "excluded":
        return np.ones((M, C, 2 * F), np.int32)
    s = rng.integers(1, 257, (M, C, 2 * F)).astype(np.int32)
    s[:, 0], s[:, 1], s[:, 2], s[:, 3] = 1, 256, 128, 129
    return s


def _batch(rng, B, F, M):
    return (rng.integers(0, 2, (B, F)).astype(np.uint8),
            rng.integers(0, M, B).astype(np.int32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("M,C,F,B", SHAPES)
@pytest.mark.parametrize("parallel", [False, True])
def test_fit_step_matches_reference_at_step_offsets(M, C, F, B, parallel):
    jcfg, cfg = _cfgs(M, C, F)
    rng = np.random.default_rng(M * 100 + C)
    state = _state(rng, M, C, F)
    jstate, pstate = jnp.asarray(state), _t(state)
    for step in (0, 1, 7):
        x, y = _batch(rng, B, F, M)
        jstate = jtrain.fit_step(jcfg, jstate, jax.random.key(17), jnp.asarray(x),
                                 jnp.asarray(y), step=step, parallel=parallel)
        pstate = train.fit_step(cfg, pstate, prng.key(17), _t(x), _t(y),
                                step=step, parallel=parallel)
        assert np.array_equal(pstate.numpy(), np.asarray(jstate)), step


# labels past either end: the reference reads a clamped row, counts a
# negative label from the end, drops a target update still out of range,
# and draws the negative class against the label as given
OUT_OF_RANGE = np.resize(np.array([3, -1, -3, -4, 7, 2**31 - 1, -(2**31)], np.int32), 20)


@pytest.mark.parametrize("labels", ["in range", "out of range"])
@pytest.mark.parametrize("trainer", ["train_batch", "train_batch_parallel"])
def test_trainers_match_reference_and_leave_the_input(trainer, labels):
    jcfg, cfg = _cfgs(3, 12, 9)
    rng = np.random.default_rng(5)
    state = _state(rng, 3, 12, 9)
    x, y = _batch(rng, 20, 9, 3)
    if labels == "out of range":
        y = OUT_OF_RANGE
    key = jax.random.fold_in(jax.random.key(3), 4)
    want = getattr(jtrain, trainer)(jcfg, jnp.asarray(state), key,
                                    jnp.asarray(x), jnp.asarray(y))
    before = _t(state)
    got = getattr(train, trainer)(cfg, before, prng.fold_in(prng.key(3), 4),
                                  _t(x), _t(y))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(before.numpy(), state)  # no donation in the port


def test_summed_delta_chunks_do_not_change_the_sum(monkeypatch):
    """Chunks of one sample give the same state as one chunk."""
    _, cfg = _cfgs(3, 12, 9)
    rng = np.random.default_rng(8)
    state, (x, y) = _t(_state(rng, 3, 12, 9)), _batch(rng, 9, 9, 3)
    whole = train.train_batch_parallel(cfg, state, prng.key(1), _t(x), _t(y))
    monkeypatch.setattr(train, "_CHUNK_TAS", 1)
    assert train.chunk_samples(cfg) == 1
    one = train.train_batch_parallel(cfg, state, prng.key(1), _t(x), _t(y))
    assert torch.equal(whole, one)


@pytest.mark.parametrize("shuffle,parallel", [(True, True), (True, False), (False, True)])
def test_fit_matches_reference(shuffle, parallel):
    jcfg, cfg = _cfgs(3, 8, 6)
    rng = np.random.default_rng(12)
    x, y = _batch(rng, 70, 6, 3)  # 2 batches of 32 and a ragged tail
    state = jtm.init_state(jcfg, jax.random.key(0))
    want = jtrain.fit(jcfg, state, jax.random.key(4), jnp.asarray(x), jnp.asarray(y),
                      epochs=2, batch=32, shuffle=shuffle, parallel=parallel)
    got = train.fit(cfg, tm.init_state(cfg), prng.key(4), _t(x), _t(y),
                    epochs=2, batch=32, shuffle=shuffle, parallel=parallel)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert train.accuracy(cfg, got, _t(x), _t(y)) == jtrain.accuracy(
        jcfg, want, jnp.asarray(x), jnp.asarray(y))


def test_sample_class_delta_matches_reference():
    jcfg, cfg = _cfgs(5, 10, 7)
    rng = np.random.default_rng(3)
    state = _state(rng, 5, 10, 7)
    x = rng.integers(0, 2, 7).astype(np.uint8)
    m_ids = np.array([1, 3, 4], np.int32)
    for y in range(5):
        jk = jtrain.sample_keys(jax.random.key(6), 4)[2]
        pk = train.sample_keys(prng.key(6), 4)[2]
        want = jtrain.sample_class_delta(jcfg, jnp.asarray(state[m_ids]), jnp.asarray(m_ids),
                                         jk, jnp.asarray(x), jnp.int32(y))
        got = train.sample_class_delta(cfg, _t(state[m_ids]), _t(m_ids), pk, _t(x), y)
        assert np.array_equal(got.numpy(), np.asarray(want)), y


def test_batch_capacity_raises_the_structured_error():
    from repro_torch.accel import CapacityExceeded, CapacityPlan

    _, cfg = _cfgs(2, 4, 3)
    x, y = _batch(np.random.default_rng(0), 65, 3, 2)
    with pytest.raises(CapacityExceeded) as err:
        train.fit_step(cfg, tm.init_state(cfg), prng.key(0), _t(x), _t(y),
                       step=0, plan=CapacityPlan(batch_words=2))
    assert (err.value.knob, err.value.required, err.value.capacity) == ("batch_words", 3, 2)


# -- the packed representation and the fused step ---------------------------


def test_pack_roundtrip_and_action_boundary():
    jcfg, cfg = _cfgs(3, 10, 8)
    state = _state(np.random.default_rng(1), 3, 10, 8)
    packed = tt.pack_ta_state(cfg, _t(state))
    assert packed.dtype == torch.int8 and packed.shape == (3, 10, 8, 2)
    assert np.array_equal(packed.numpy(), np.asarray(jtt.pack_ta_state(jcfg, jnp.asarray(state))))
    assert np.array_equal(tt.unpack_ta_state(cfg, packed).numpy(), state)
    acts = tt.packed_include_actions(packed.reshape(3, 10, 16))
    assert torch.equal(acts, _t(state) > cfg.n_states)


def test_packable_gate():
    ok = tm.TMConfig(2, 4, 4, n_states=tt.MAX_PACKED_STATES)
    too_big = tm.TMConfig(2, 4, 4, n_states=tt.MAX_PACKED_STATES + 1)
    assert tt.supports_packed_states(ok) and not tt.supports_packed_states(too_big)
    tt.check_packable(ok)
    with pytest.raises(ValueError, match="reference"):
        tt.check_packable(too_big)


# the reference's engine-test shapes (tests/test_train_engine.py): C > 32
# with ragged B = 33, a sub-word B = 7, and an all-excluded start
@pytest.mark.parametrize("M,C,F,B,kind", [
    (2, 6, 5, 16, "random"), (3, 40, 11, 33, "random"),
    (5, 10, 16, 7, "random"), (3, 12, 9, 20, "excluded"),
])
def test_fused_step_matches_reference(M, C, F, B, kind):
    jcfg, cfg = _cfgs(M, C, F)
    rng = np.random.default_rng(23 + B)
    state = _state(rng, M, C, F, kind)
    jpacked = jtt.pack_ta_state(jcfg, jnp.asarray(state))
    packed = tt.pack_ta_state(cfg, _t(state))
    for step in (0, 1, 7):
        x, y = _batch(rng, B, F, M)
        want = jtrain.fit_step(jcfg, jnp.asarray(state), jax.random.key(17), jnp.asarray(x),
                               jnp.asarray(y), step=step, parallel=True)
        jpacked = jtt.fused_fit_step(jcfg, jpacked, jax.random.key(17), jnp.asarray(x),
                                     jnp.asarray(y), step=step)
        packed = tt.fused_fit_step(cfg, packed, prng.key(17), _t(x), _t(y), step=step)
        assert np.array_equal(packed.numpy(), np.asarray(jpacked)), step
        state = np.asarray(want)
        assert np.array_equal(tt.unpack_ta_state(cfg, packed).numpy(), state), step


@pytest.mark.parametrize("labels", ["in range", "out of range"])
def test_fused_twin_oracle_and_reference_agree(labels):
    jcfg, cfg = _cfgs(4, 24, 12)
    rng = np.random.default_rng(11)
    x, y = _batch(rng, 40, 12, 4)
    if labels == "out of range":
        y = np.resize(OUT_OF_RANGE, 40)
    packed = tt.pack_ta_state(cfg, _t(_state(rng, 4, 24, 12)))
    jkey = jax.random.fold_in(jax.random.key(9), 4)
    key = prng.fold_in(prng.key(9), 4)
    want = jtt.fused_train_batch(jcfg, jnp.asarray(packed.numpy()), jkey,
                                 jnp.asarray(x), jnp.asarray(y))
    for fn in (tt.fused_train_batch, tt.fused_train_batch_plain, tt.fused_train_batch_ref):
        got = fn(cfg, packed, key, _t(x), _t(y))
        assert np.array_equal(got.numpy(), np.asarray(want)), fn.__name__


@pytest.mark.parametrize("B", [7, 33])
def test_packed_clause_words_match_reference(B):
    rng = np.random.default_rng(B)
    actions = rng.random((3, 9, 22)) < 0.1
    actions[1, 2] = False  # an empty clause: all ones in training
    x = rng.integers(0, 2, (B + (-B % 32), 11)).astype(np.uint8)
    want = jtt.packed_clause_words(jnp.asarray(actions), jtm.pack_literals(jnp.asarray(x)))
    got = tt.packed_clause_words(_t(actions), tm.pack_literals(_t(x)))
    assert np.array_equal(to_u32(got), np.asarray(want))
    assert (to_u32(got[1, 2]) == 0xFFFFFFFF).all()


def test_tm_train_twin_is_the_update_given_clause_words():
    """``tm_train`` on CPU tensors is the plain twin, and with the batch's
    clause words it is the whole fused step; it counts no launch."""
    _, cfg = _cfgs(3, 40, 11)
    rng = np.random.default_rng(2)
    packed = tt.pack_ta_state(cfg, _t(_state(rng, 3, 40, 11)))
    x, y = _batch(rng, 33, 11, 3)
    plits = tm.pack_literals(_t(np.pad(x, ((0, 31), (0, 0)))))
    cw = tt.packed_clause_words(packed.reshape(3, 40, 22) >= 0, plits)
    before = tt.kernel.launches
    got = tt.tm_train(cfg, packed, cw, plits, _t(y), prng.key(5))
    assert tt.kernel.launches == before
    assert torch.equal(got, tt.fused_train_batch(cfg, packed, prng.key(5), _t(x), _t(y)))
    with pytest.raises(ValueError, match="B <= 32"):
        tt.tm_train(cfg, packed, cw, plits, _t(np.zeros(65, np.int32)), prng.key(5))
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        tt.tm_train(cfg, packed.to("meta"), cw.to("meta"), plits.to("meta"),
                    _t(y).to("meta"), prng.key(5))
