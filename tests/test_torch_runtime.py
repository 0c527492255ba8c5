"""The port's stream protocol and stream interpreter (``repro_torch.core.
runtime``, ``core.interp``, ``kernels.interp_stream``) against the JAX
reference (``repro.core.runtime``, ``repro.core.interp``) on the CPU, on
the same numpy inputs, exactly (integer streams and sums: tolerance 0):
the stream bytes and headers and their overflow errors, ``pack_features``,
``interpret_stream`` on well-formed and malformed streams (its plain twin
and its step-by-step oracle too), ``plan_class_sums``/``pad_plan``, the
base ``Accelerator`` across model, task and dimensionality swaps, and the
Fig-7 ``MultiCoreAccelerator``.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jcompress
from repro.core import interp as jinterp
from repro.core import runtime as jrt
from repro.core.tm import TMConfig as JTMConfig
from repro.core.tm import literals as jliterals
from repro_torch.core import interp, runtime
from repro_torch.core.bits import from_u32
from repro_torch.core.compress import decode_to_plan, encode
from repro_torch.core.tm import TMConfig
from repro_torch.kernels.interp_stream import (
    interp_stream,
    interpret_stream_plain,
    interpret_stream_ref,
)


def _acts(rng, M, C, F, density=0.08):
    return rng.random((M, C, 2 * F)) < density


def _both_models(rng, M, C, F, weighted=False, density=0.08):
    """The same actions encoded by both packages (and their weights)."""
    cfg = TMConfig(M, C, F)
    acts = _acts(rng, M, C, F, density)
    w = rng.integers(1, 9, (M, C)) if weighted else None
    jcfg = JTMConfig(M, C, F)
    return cfg, acts, w, encode(cfg, acts, w), jcompress.encode(jcfg, acts, w)


# -- stream bytes and headers ---------------------------------------------------


@pytest.mark.parametrize("M,C,F,weighted", [(4, 10, 50, False), (3, 6, 32, True),
                                            (1, 1, 1, False), (7, 14, 33, False)])
def test_stream_builders_are_byte_identical(M, C, F, weighted):
    rng = np.random.default_rng(M * C + F)
    _, _, _, model, jmodel = _both_models(rng, M, C, F, weighted)
    got, want = runtime.build_instruction_stream(model), jrt.build_instruction_stream(jmodel)
    assert got.dtype == want.dtype == np.uint16 and np.array_equal(got, want)
    assert runtime.parse_header(got) == jrt.parse_header(want)
    for B in (1, 20, 37):
        X = rng.integers(0, 2, (B, F)).astype(np.uint8)
        got, want = runtime.build_feature_stream(X), jrt.build_feature_stream(X)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert runtime.parse_header(got) == jrt.parse_header(want)
        body = got[4:]
        assert np.array_equal(runtime._unpack_feature_payload(body, B, F),
                              jrt._unpack_feature_payload(body, B, F))


def _fake_model(**kw):
    fields = dict(n_classes=2, n_clauses=3, n_features=4,
                  instructions=np.zeros(5, np.uint16))
    fields.update(kw)
    if "n_instructions" not in fields:
        fields["n_instructions"] = fields["instructions"].shape[0]
    return types.SimpleNamespace(**fields)


@pytest.mark.parametrize("build,arg", [
    ("instruction", _fake_model(n_classes=runtime.PAYLOAD_MASK)),
    ("instruction", _fake_model(n_clauses=0xFFFF)),
    ("instruction", _fake_model(n_classes=runtime.PAYLOAD_MASK + 1)),
    ("instruction", _fake_model(n_clauses=0x10000)),
    ("instruction", _fake_model(n_instructions=1 << 32)),
    ("feature", np.zeros((0xFFFF, 4), np.uint8)),
    ("feature", np.zeros((0x10000, 4), np.uint8)),
    ("feature", np.zeros((1, runtime.PAYLOAD_MASK + 1), np.uint8)),
])
def test_header_boundaries_and_overflow_errors_match(build, arg):
    fns = [getattr(mod, f"build_{build}_stream") for mod in (runtime, jrt)]
    outcomes = []
    for fn in fns:
        try:
            outcomes.append(("ok", fn(arg).tobytes()))
        except ValueError as err:
            outcomes.append(("ValueError", str(err)))
    assert outcomes[0] == outcomes[1]
    assert (runtime.RESET_BIT, runtime.TYPE_BIT, runtime.PAYLOAD_MASK) == (
        jrt.RESET_BIT, jrt.TYPE_BIT, jrt.PAYLOAD_MASK)


@pytest.mark.parametrize("B,F,f_cap,w_cap", [(32, 10, 16, 1), (37, 50, 64, 3),
                                             (1, 3, 3, 2), (0, 4, 8, 1)])
def test_pack_features_matches_reference(B, F, f_cap, w_cap):
    X = np.random.default_rng(B + F).integers(0, 2, (B, F)).astype(np.uint8)
    got = interp.pack_features(torch.from_numpy(X), f_cap, w_cap)
    want = np.asarray(jinterp.pack_features(jnp.asarray(X), f_cap, w_cap))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy().view(np.uint32), want)


def test_pack_features_errors_match():
    for shape, caps in (((8, 100), (64, 1)), ((40, 16), (64, 1))):
        x = np.zeros(shape, np.uint8)
        with pytest.raises(ValueError) as ours:
            interp.pack_features(torch.from_numpy(x), *caps)
        with pytest.raises(ValueError) as theirs:
            jinterp.pack_features(jnp.asarray(x), *caps)
        assert str(ours.value) == str(theirs.value)


# -- the stream interpreter -----------------------------------------------------

_E_CC = (1 << 15) | (1 << 14)


def _stream_case(case):
    """(imem uint16[I_cap], n_inst, features uint32[F_cap, W], weights
    int32[I_cap] or None, m_cap) of one case."""
    rng = np.random.default_rng(STREAM_CASES.index(case))
    M, C, F, W, weighted, extra = 4, 6, 20, 2, False, 7
    if case == "weighted":
        weighted = True
    if case == "EXTENDs":  # a literal slot past 4095: F >= 2048
        M, C, F = 2, 2, 2100
    if case == "ragged B":
        W = 3
    _, acts, w, model, _ = _both_models(rng, M, C, F, weighted)
    if case == "EXTENDs":
        acts[:] = False
        acts[0, 0, [3, 4150]] = acts[1, 1, [4101, 4198]] = True
        model = encode(TMConfig(M, C, F), acts)
        assert (model.instructions & 0x0FFF == 0x0FFF).sum() >= 2
    ins = model.instructions.astype(np.uint16)
    if case == "no opening toggle":  # E and CC flipped: the first clause has no boundary
        ins = ins ^ np.uint16(_E_CC)
    m_cap = {"m_cap above classes": M + 5, "classes past m_cap": 2}.get(case, M)
    imem = np.zeros(ins.size + extra, np.uint16)
    imem[: ins.size] = ins
    f_cap = F + 3
    if case == "ragged B":
        X = rng.integers(0, 2, (70, F)).astype(np.uint8)
        feats = np.array(jinterp.pack_features(jnp.asarray(X), f_cap, W))
    else:
        feats = rng.integers(0, 2**32, (f_cap, W), dtype=np.uint64).astype(np.uint32)
        feats[::2] |= rng.integers(0, 2**32, (feats[::2].shape), dtype=np.uint64).astype(np.uint32)
    wmem = None
    if weighted:
        wmem = np.ones(imem.size, np.int32)
        wmem[: model.n_weights] = model.clause_weights
    return imem, ins.size, feats, wmem, m_cap


STREAM_CASES = ["weightless", "weighted", "EXTENDs", "ragged B", "m_cap above classes",
                "no opening toggle", "classes past m_cap"]


@pytest.mark.parametrize("case", STREAM_CASES)
def test_interpret_stream_matches_reference(case):
    imem, n_inst, feats, wmem, m_cap = _stream_case(case)
    want = np.asarray(jinterp.interpret_stream(
        jnp.asarray(imem), jnp.int32(n_inst), jnp.asarray(feats), jnp.int32(0),
        None if wmem is None else jnp.asarray(wmem), m_cap=m_cap,
    ))
    args = (torch.from_numpy(imem.astype(np.int32)), n_inst, from_u32(feats),
            None if wmem is None else torch.from_numpy(wmem))
    got = interp.interpret_stream(*args[:3], 0, args[3], m_cap=m_cap)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(interpret_stream_plain(*args, m_cap), got)
    assert torch.equal(interpret_stream_ref(*args, m_cap), got)
    assert want.any()
    if case == "no opening toggle":  # the class -1 clause lands on the last row
        assert want[m_cap - 1].any()
    if case == "m_cap above classes":
        assert not want[m_cap - 5:].any()


@pytest.mark.parametrize("n_inst", [0, 5, 10_000])
def test_interpret_stream_counts_only_live_instructions(n_inst):
    imem, _, feats, wmem, m_cap = _stream_case("weighted")
    want = np.asarray(jinterp.interpret_stream(
        jnp.asarray(imem), jnp.int32(n_inst), jnp.asarray(feats), jnp.int32(0),
        jnp.asarray(wmem), m_cap=m_cap,
    ))
    got = interp_stream(torch.from_numpy(imem.astype(np.int32)), n_inst,
                        from_u32(feats), torch.from_numpy(wmem), m_cap=m_cap)
    assert np.array_equal(got.numpy(), want)


def test_interpret_predict_matches_reference():
    rng = np.random.default_rng(3)
    _, _, _, model, _ = _both_models(rng, 5, 8, 30)
    X = rng.integers(0, 2, (64, 30)).astype(np.uint8)
    imem = np.zeros(model.n_instructions + 3, np.uint16)
    imem[: model.n_instructions] = model.instructions
    want = np.asarray(jinterp.interpret_predict(
        jnp.asarray(imem), jnp.int32(model.n_instructions),
        jinterp.pack_features(jnp.asarray(X), 32, 2), jnp.int32(64), jnp.int32(5),
        m_cap=8,
    ))
    got = interp.interpret_predict(
        torch.from_numpy(imem.astype(np.int32)), model.n_instructions,
        interp.pack_features(torch.from_numpy(X), 32, 2), 64, 5, m_cap=8,
    )
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_interp_stream_wrapper_refuses_bad_operands():
    imem, feats = torch.zeros(4, dtype=torch.int32), torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(TypeError, match="imem must be int32"):
        interp_stream(imem.to(torch.int64), 1, feats, m_cap=2)
    with pytest.raises(ValueError, match="wmem must be a non-empty"):
        interp_stream(imem, 1, feats, torch.zeros(0, dtype=torch.int32), m_cap=2)
    with pytest.raises(ValueError, match="m_cap must be positive"):
        interp_stream(imem, 1, feats, m_cap=0)
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        interp_stream(imem.to("meta"), 1, feats.to("meta"), m_cap=2)


# -- the decoded-plan executor ---------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_plan_class_sums_matches_reference(weighted):
    rng = np.random.default_rng(4)
    _, _, _, model, jmodel = _both_models(rng, 4, 7, 12, weighted)
    plan, jplan = decode_to_plan(model), jcompress.decode_to_plan(jmodel)
    i_cap, ncl_cap, m_cap = plan.n_includes + 9, 4 * 7 + 3, 6
    ops, jops = interp.pad_plan(plan, i_cap, ncl_cap), jinterp.pad_plan(jplan, i_cap, ncl_cap)
    for a, b in zip(ops, jops):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    X = rng.integers(0, 2, (45, 12)).astype(np.uint8)
    want = np.asarray(jinterp.plan_class_sums(
        *map(jnp.asarray, jops), jliterals(jnp.asarray(X)),
        n_clause_cap=ncl_cap, m_cap=m_cap,
    ))
    from repro_torch.core.tm import literals

    got = interp.plan_class_sums(
        *map(torch.from_numpy, ops), literals(torch.from_numpy(X)),
        n_clause_cap=ncl_cap, m_cap=m_cap,
    )
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# -- the base accelerator and the multi-core split ------------------------------


def _configs():
    kw = dict(instruction_capacity=4096, feature_capacity=256, class_capacity=16,
              batch_words=2)
    return runtime.AcceleratorConfig(**kw), jrt.AcceleratorConfig(**kw)


def test_accelerator_config_matches_reference():
    cfg, jcfg = _configs()
    assert (cfg.batch_capacity, cfg.bram_bytes) == (jcfg.batch_capacity, jcfg.bram_bytes)
    assert runtime.AcceleratorConfig().bram_bytes == jrt.AcceleratorConfig().bram_bytes


def test_accelerator_matches_reference_across_swaps():
    """A model swap, a task swap (class count) and a change of input
    dimensionality are buffer rewrites: the same predictions and sums as
    the reference, and one operand signature throughout."""
    cfg, jcfg = _configs()
    acc, jacc = runtime.Accelerator(cfg, device="cpu"), jrt.Accelerator(jcfg)
    rng = np.random.default_rng(5)
    for M, C, F in [(4, 10, 50), (4, 10, 50), (2, 6, 120), (7, 14, 33), (3, 20, 200)]:
        _, _, _, model, jmodel = _both_models(rng, M, C, F, density=0.05)
        X = rng.integers(0, 2, (37, F)).astype(np.uint8)
        assert acc.feed(runtime.build_instruction_stream(model)) is None
        jacc.feed(jrt.build_instruction_stream(jmodel))
        stream = runtime.build_feature_stream(X)
        got, want = acc.feed(stream), np.asarray(jacc.feed(stream))
        assert got.dtype == np.int32 and np.array_equal(got, want)
        assert np.array_equal(acc.infer(X), np.asarray(jacc.infer(X)))
        sums = acc.class_sums(X)
        assert sums.shape == (37, M) and np.array_equal(sums, np.asarray(jacc.class_sums(X)))
    assert acc.programs_loaded == jacc.programs_loaded == 5
    assert acc.compile_cache_size() == 1
    acc.load_model(model)
    assert acc.programs_loaded == 6


def test_accelerator_guards_match_reference():
    cfg, jcfg = _configs()
    acc, jacc = runtime.Accelerator(cfg, device="cpu"), jrt.Accelerator(jcfg)
    rng = np.random.default_rng(6)
    _, _, _, big, jbig = _both_models(rng, 8, 200, 500, density=0.5)
    _, _, _, wide, jwide = _both_models(rng, 20, 2, 4)
    X = rng.integers(0, 2, (8, 1000)).astype(np.uint8)
    for ours, theirs in (
        (lambda: acc.load_model(big), lambda: jacc.load_model(jbig)),
        (lambda: acc.load_model(wide), lambda: jacc.load_model(jwide)),
        (lambda: acc.feed(runtime.build_feature_stream(X)),
         lambda: jacc.feed(jrt.build_feature_stream(X))),
        (lambda: acc.infer(X[:, :10].repeat(10, 0)), lambda: jacc.infer(X[:, :10].repeat(10, 0))),
    ):
        with pytest.raises(ValueError) as a:
            ours()
        with pytest.raises(ValueError) as b:
            theirs()
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("n_cores", [1, 2, 3, 4])
def test_multicore_matches_reference(n_cores):
    """Up to 4 cores over a 3-class model: 4 cores leave one core idle."""
    rng = np.random.default_rng(7)
    cfg, jcfg = _configs()
    _, _, _, model, jmodel = _both_models(rng, 3, 12, 40, density=0.06)
    X = rng.integers(0, 2, (64, 40)).astype(np.uint8)
    mc = runtime.MultiCoreAccelerator(n_cores, cfg, device="cpu")
    jmc = jrt.MultiCoreAccelerator(n_cores, jcfg)
    with pytest.raises(RuntimeError, match="no model loaded"):
        mc.infer(X)
    mc.load_model(model)
    jmc.load_model(jmodel)
    assert mc._class_slices == jmc._class_slices
    got = mc.infer(X)
    assert got.dtype == np.int32 and np.array_equal(got, np.asarray(jmc.infer(X)))
    single = runtime.Accelerator(cfg, device="cpu")
    single.load_model(model)
    assert np.array_equal(got, single.infer(X))
