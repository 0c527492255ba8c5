"""Parity of the port's program format with the JAX reference: the uint16
instruction stream, the decoded plan, CapacityPlan negotiation and
TMProgram bytes are byte-identical, and artifacts written by either
package load in the other (repro_torch.core.compress, repro_torch.accel).
"""

from pathlib import Path

import numpy as np
import pytest

from repro.accel import CapacityPlan as JCapacityPlan
from repro.accel import TMProgram as JTMProgram
from repro.core import compress as jcomp
from repro.core.tm import TMConfig as JTMConfig
from repro_torch.accel import CapacityPlan, TMProgram
from repro_torch.core import compress
from repro_torch.core.tm import TMConfig

GOLDEN = Path(__file__).parent / "data" / "tmprogram_v1_golden.bin"


def _acts(seed, M=5, C=8, F=24, density=0.15):
    rng = np.random.default_rng(seed)
    acts = rng.random((M, C, 2 * F)) < density
    acts[1] = False  # a class with zero includes: a lone boundary EXTEND
    acts[0, 2] = False  # an empty clause, skipped at encode time
    return rng, acts


def _cfgs(M, C, F):
    return (
        JTMConfig(n_classes=M, n_clauses=C, n_features=F),
        TMConfig(n_classes=M, n_clauses=C, n_features=F),
    )


def _same_model(a, b):
    np.testing.assert_array_equal(a.instructions, b.instructions)
    assert a.instructions.dtype == b.instructions.dtype == np.uint16
    assert (a.n_classes, a.n_clauses, a.n_features) == (
        b.n_classes, b.n_clauses, b.n_features
    )
    if a.clause_weights is None:
        assert b.clause_weights is None
    else:
        np.testing.assert_array_equal(a.clause_weights, b.clause_weights)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_encode_streams_identical(seed, weighted):
    rng, acts = _acts(seed)
    jcfg, tcfg = _cfgs(*acts.shape[:2], acts.shape[2] // 2)
    w = rng.integers(1, 6, acts.shape[:2]) if weighted else None
    jm, tm_ = jcomp.encode(jcfg, acts, w), compress.encode(tcfg, acts, w)
    _same_model(jm, tm_)
    assert tm_.n_bytes == jm.n_bytes
    assert tm_.weight_planes == jm.weight_planes
    assert tm_.compression_ratio(tcfg) == jm.compression_ratio(jcfg)


def test_encode_offsets_above_4094_use_extend():
    M, C, F = 2, 2, 2100  # 4200 literal slots: offsets past MAX_OFF
    acts = np.zeros((M, C, 2 * F), bool)
    acts[0, 0, [0, 4199]] = True
    acts[0, 1, [4100]] = True
    acts[1, 0, [3, 4096, 4198]] = True
    jcfg, tcfg = _cfgs(M, C, F)
    jm, tm_ = jcomp.encode(jcfg, acts), compress.encode(tcfg, acts)
    _same_model(jm, tm_)
    offs = tm_.instructions & compress.OFF_MASK
    assert (offs == compress.EXTEND).sum() == 2
    np.testing.assert_array_equal(compress.decode(tm_), acts)


@pytest.mark.parametrize("seed", [0, 3])
def test_decode_and_plan_fields_equal(seed):
    rng, acts = _acts(seed)
    jcfg, tcfg = _cfgs(*acts.shape[:2], acts.shape[2] // 2)
    w = rng.integers(1, 6, acts.shape[:2])
    for weights in (None, w):
        jm = jcomp.encode(jcfg, acts, weights)
        tm_ = compress.encode(tcfg, acts, weights)
        np.testing.assert_array_equal(compress.decode(tm_), jcomp.decode(jm))
        for a, b in zip(compress.decode_weights(tm_), jcomp.decode_weights(jm)):
            np.testing.assert_array_equal(a, b)
        jp, tp = jcomp.decode_to_plan(jm), compress.decode_to_plan(tm_)
        for field in ("lit_idx", "clause_id", "clause_class", "clause_pol",
                      "weights", "weighted_pol"):
            a, b = getattr(tp, field), getattr(jp, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert (tp.n_includes, tp.n_clauses_total, tp.weight_planes) == (
            jp.n_includes, jp.n_clauses_total, jp.weight_planes
        )
        np.testing.assert_array_equal(
            tp.clauses_per_class(), jp.clauses_per_class()
        )
        np.testing.assert_array_equal(
            tp.includes_per_clause(), jp.includes_per_clause()
        )


def test_decode_rejects_the_same_malformed_streams():
    _, acts = _acts(4)
    jcfg, tcfg = _cfgs(*acts.shape[:2], acts.shape[2] // 2)
    jm, tm_ = jcomp.encode(jcfg, acts), compress.encode(tcfg, acts)
    bad = [
        dict(n_classes=2),  # class alignment slips past n_classes
        dict(n_clauses=1),  # more clauses than slots
        dict(n_features=3),  # literal slot out of range
    ]
    for change in bad:
        fields = dict(
            instructions=tm_.instructions, n_classes=tm_.n_classes,
            n_clauses=tm_.n_clauses, n_features=tm_.n_features,
        )
        fields.update(change)
        with pytest.raises(ValueError) as te:
            compress.decode(compress.CompressedModel(**fields))
        with pytest.raises(ValueError) as je:
            jcomp.decode(jcomp.CompressedModel(**fields))
        assert str(te.value) == str(je.value)
    del jm


def test_validate_roundtrip_passes_and_refuses():
    rng, acts = _acts(5)
    M, C, L2 = acts.shape
    _, tcfg = _cfgs(M, C, L2 // 2)
    X = rng.integers(0, 2, (64, L2 // 2), dtype=np.uint8)
    w = rng.integers(1, 4, (M, C))
    model = compress.encode(tcfg, acts, w)
    compress.validate_roundtrip(tcfg, acts, model, X, clause_weights=w)
    other = acts.copy()
    other[0, 0, :] = False
    other[0, 0, 0] = True
    with pytest.raises(ValueError, match="not bit-exact"):
        compress.validate_roundtrip(
            tcfg, acts, compress.encode(tcfg, other, w), X, clause_weights=w
        )


@pytest.mark.parametrize("weighted,planes", [(False, 1), (False, 2), (True, 1)])
def test_tmprogram_bytes_identical(weighted, planes):
    rng, acts = _acts(6)
    M, C, L2 = acts.shape
    jcfg, tcfg = _cfgs(M, C, L2 // 2)
    w = rng.integers(1, 6, (M, C)) if weighted else None
    jm, tm_ = jcomp.encode(jcfg, acts, w), compress.encode(tcfg, acts, w)
    jplan = JCapacityPlan.for_models([jm], batch_words=2)
    tplan = CapacityPlan.for_models([tm_], batch_words=2)
    assert tplan.as_dict() == jplan.as_dict()
    if planes > 1:
        jplan = JCapacityPlan(**{**jplan.as_dict(), "weight_planes": planes})
        tplan = CapacityPlan(**{**tplan.as_dict(), "weight_planes": planes})
    jp, tp = JTMProgram(jplan, jm), TMProgram(tplan, tm_)
    assert tp.format_version == jp.format_version
    assert tp.format_version == (1 if not weighted and planes == 1 else 2)
    assert tp.to_bytes() == jp.to_bytes()
    assert (tp.checksum, tp.n_bytes) == (jp.checksum, jp.n_bytes)


def test_golden_v1_fixture_loads_and_reserializes():
    blob = GOLDEN.read_bytes()
    tp, jp = TMProgram.from_bytes(blob), JTMProgram.from_bytes(blob)
    assert tp.format_version == 1
    assert tp.capacity.as_dict() == jp.capacity.as_dict()
    _same_model(tp.model, jp.model)
    assert tp.to_bytes() == blob


def test_bytes_cross_load_both_directions():
    rng, acts = _acts(7)
    M, C, L2 = acts.shape
    jcfg, tcfg = _cfgs(M, C, L2 // 2)
    w = rng.integers(1, 6, (M, C))
    for weights in (None, w):
        jm, tm_ = jcomp.encode(jcfg, acts, weights), compress.encode(tcfg, acts, weights)
        jblob = JTMProgram(JCapacityPlan.for_models([jm]), jm).to_bytes()
        tblob = TMProgram(CapacityPlan.for_models([tm_]), tm_).to_bytes()
        from_j, from_t = TMProgram.from_bytes(jblob), JTMProgram.from_bytes(tblob)
        _same_model(from_j.model, jm)
        _same_model(from_t.model, tm_)
        assert from_j.to_bytes() == jblob and from_t.to_bytes() == tblob


def test_from_bytes_refuses_the_same_corruptions():
    _, acts = _acts(8)
    M, C, L2 = acts.shape
    _, tcfg = _cfgs(M, C, L2 // 2)
    tm_ = compress.encode(tcfg, acts)
    blob = TMProgram(CapacityPlan.for_models([tm_]), tm_).to_bytes()
    flipped = bytearray(blob)
    flipped[-1] ^= 0xFF
    for bad in (blob[:10], b"XXXX" + blob[4:], bytes(flipped), blob[:-2]):
        with pytest.raises(ValueError) as te:
            TMProgram.from_bytes(bad)
        with pytest.raises(ValueError) as je:
            JTMProgram.from_bytes(bad)
        assert str(te.value) == str(je.value)


def test_capacity_negotiation_matches():
    models = []
    for seed, (M, C, F) in enumerate([(5, 8, 24), (3, 12, 40), (6, 6, 16)]):
        rng = np.random.default_rng(seed)
        acts = rng.random((M, C, 2 * F)) < 0.1
        models.append((acts, (M, C, F)))
    jms = [jcomp.encode(_cfgs(*d)[0], a) for a, d in models]
    tms = [compress.encode(_cfgs(*d)[1], a) for a, d in models]
    for headroom in (0.0, 0.5):
        jplan = JCapacityPlan.for_models(jms, headroom=headroom, batch_words=3)
        tplan = CapacityPlan.for_models(tms, headroom=headroom, batch_words=3)
        assert tplan.as_dict() == jplan.as_dict()
    small = CapacityPlan(instruction_capacity=32, feature_capacity=16)
    jsmall = JCapacityPlan(instruction_capacity=32, feature_capacity=16)
    for jm, tm_ in zip(jms, tms):
        assert small.violations(tm_) == jsmall.violations(jm)
        assert small.widen_to(tm_).as_dict() == jsmall.widen_to(jm).as_dict()
        assert tplan.shrink_diagnostics(tm_) == jplan.shrink_diagnostics(jm)
