"""The port's LM configs, parameter counts and token stream against the
reference's, exactly: ``repro_torch.configs`` is a copy of
``repro.configs`` (equal field by field), the parameter trees' shapes and
counts are the reference's (specs only, nothing allocated), and
``TokenStream`` batches are bit-identical with an exact resume.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.data import pipeline as rpipe
from repro.models import api as rapi
from repro.optim import adamw as radamw
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.models import api as tapi
from repro_torch.optim import adamw as tadamw
from repro_torch.tree import flatten

ARCHS = rreg.all_arch_names()


def test_arch_registry_is_the_references():
    assert treg.all_arch_names() == ARCHS
    assert len(ARCHS) == 10
    # every family of the registry is served by the port
    assert {rreg.get(a).family for a in ARCHS} == set(tapi._FAMILIES)


@pytest.mark.parametrize("name", [a + s for a in ARCHS for s in ("", "-smoke")])
def test_arch_config_equal_field_by_field(name):
    r, t = rreg.get(name), treg.get(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert (t.head_dim, t.padded_vocab, t.is_moe) == (r.head_dim, r.padded_vocab, r.is_moe)
    assert [s.name for s in tbase.shapes_for(t)] == [s.name for s in rbase.shapes_for(r)]


def test_shapes_equal():
    assert [dataclasses.asdict(s) for s in tbase.ALL_SHAPES] == [
        dataclasses.asdict(s) for s in rbase.ALL_SHAPES
    ]
    for s in rbase.ALL_SHAPES:
        assert dataclasses.asdict(tbase.shape_by_name(s.name)) == dataclasses.asdict(s)
    with pytest.raises(KeyError):
        tbase.shape_by_name("no-such-shape")


@pytest.mark.parametrize("name", ARCHS + [a + "-smoke" for a in ARCHS])
def test_param_specs_and_counts_equal(name):
    r, t = rreg.get(name), treg.get(name)
    ref = {jax.tree_util.keystr(p, simple=True, separator="."): (s.shape, s.dtype.name)
           for p, s in jax.tree_util.tree_leaves_with_path(rapi.abstract_params(r))}
    port = {p: (tuple(s.shape), str(s.dtype).removeprefix("torch."))
            for p, s in flatten(tapi.abstract_params(t))}
    assert port == ref
    assert all(s.device.type == "meta" for _, s in flatten(tapi.abstract_params(t)))
    assert tapi.count_params(t) == rapi.count_params(r)
    assert tapi.active_params(t) == rapi.active_params(r)


def test_stablelm_3b_count():
    assert tapi.count_params(treg.get("stablelm-3b")) == 2_666_826_240


@pytest.mark.parametrize("name,n", [
    ("zamba2-2.7b", 2_340_750_240), ("xlstm-125m", 77_716_224),
    ("whisper-medium", 757_983_232)])
def test_recurrent_and_encdec_counts(name, n):
    assert tapi.count_params(treg.get(name)) == n


@pytest.mark.parametrize("name", ["stablelm-3b", "llama4-maverick-400b-a17b"])
def test_optimizer_specs_equal(name):
    from repro.dist.steps import opt_config_for as r_opt
    from repro_torch.dist.steps import opt_config_for as t_opt

    r, t = rreg.get(name), treg.get(name)
    rs = radamw.init_specs(r_opt(r), rapi.abstract_params(r))
    ts = tadamw.init_specs(t_opt(t), tapi.abstract_params(t))
    assert str(ts.m["embed"].dtype).removeprefix("torch.") == rs.m["embed"].dtype.name
    assert ts.step.dtype.itemsize == 4 and ts.step.shape == ()
    assert sum(math.prod(s.shape) for _, s in flatten(ts.v)) == tapi.count_params(t)


@pytest.mark.parametrize("cfg", [(512, 64, 16, 1), (50304, 128, 4, 7), (97, 33, 3, 0)])
def test_token_stream_bit_identical_with_exact_resume(cfg):
    vocab, seq, batch, seed = cfg
    r = rpipe.TokenStream(rpipe.TokenStreamConfig(vocab, seq, batch, seed=seed))
    t = tpipe.TokenStream(tpipe.TokenStreamConfig(vocab, seq, batch, seed=seed))
    for _ in range(3):
        a, b = r.next_batch(), t.next_batch()
        assert a.keys() == b.keys()
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        assert np.array_equal(a["tokens"], b["tokens"])
    state = t.state()
    ahead = [t.next_batch()["tokens"] for _ in range(2)]
    t.restore(state)
    again = [t.next_batch()["tokens"] for _ in range(2)]
    assert all(np.array_equal(x, y) for x, y in zip(ahead, again))
    resumed = tpipe.TokenStream(t.cfg, start_step=state)
    assert np.array_equal(resumed.next_batch()["tokens"], ahead[0])
    assert np.array_equal(r.next_batch()["tokens"], ahead[0])


def test_batch_to_device_on_the_cpu():
    batch = tpipe.TokenStream(tpipe.TokenStreamConfig(512, 8, 2)).next_batch()
    out = tpipe.batch_to_device(batch, "cpu")
    assert out["tokens"].device.type == "cpu"
    assert np.array_equal(out["tokens"].numpy(), batch["tokens"])
