"""The port's booleanization and synthetic TM datasets
(``repro_torch.core.booleanize``, ``repro_torch.data.pipeline``) against
the JAX reference on the CPU: the same thresholds, bits, samples and
labels for every entry of ``TM_DATASETS``, drifted or not, at small n."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import booleanize as jbool
from repro.data import pipeline as jpipe
from repro_torch.core import booleanize
from repro_torch.data import pipeline


def test_dataset_table_matches_reference():
    assert {k: dataclasses.astuple(v) for k, v in pipeline.TM_DATASETS.items()} == \
        {k: dataclasses.astuple(v) for k, v in jpipe.TM_DATASETS.items()}


@pytest.mark.parametrize("name", sorted(jpipe.TM_DATASETS))
@pytest.mark.parametrize("drift", [0.0, 1.2])
def test_datasets_match_reference(name, drift):
    spec, jspec = pipeline.TM_DATASETS[name], jpipe.TM_DATASETS[name]
    x, y = pipeline.make_tm_dataset(spec, 50, seed=3, drift=drift)
    jx, jy = jpipe.make_tm_dataset(jspec, 50, seed=3, drift=drift)
    assert x.dtype == jx.dtype and y.dtype == jy.dtype
    assert np.array_equal(x, jx) and np.array_equal(y, jy)
    xb, yb, booler = pipeline.booleanized_tm_dataset(spec, 50, seed=3, drift=drift)
    jxb, jyb, jbooler = jpipe.booleanized_tm_dataset(jspec, 50, seed=3, drift=drift)
    assert xb.dtype == jxb.dtype == np.uint8
    assert np.array_equal(xb, jxb) and np.array_equal(yb, jyb)
    assert booler.bits == jbooler.bits
    assert np.array_equal(booler.thresholds, jbooler.thresholds)
    assert booler.n_boolean_features == jbooler.n_boolean_features == xb.shape[1]
    # a fitted booleanizer carries over to another split
    xt, _, _ = pipeline.booleanized_tm_dataset(spec, 20, seed=4, booleanizer=booler)
    jxt, _, _ = jpipe.booleanized_tm_dataset(jspec, 20, seed=4, booleanizer=jbooler)
    assert np.array_equal(xt, jxt)


@pytest.mark.parametrize("bits", [1, 3, 8])
def test_booleanizer_matches_reference(bits):
    x = np.random.default_rng(bits).normal(size=(40, 6)).astype(np.float32)
    b, jb = booleanize.Booleanizer.fit(x, bits), jbool.Booleanizer.fit(x, bits)
    assert np.array_equal(b.thresholds, jb.thresholds)
    assert np.array_equal(b.transform(x), jb.transform(x))
    img = np.random.default_rng(0).random((3, 28, 28))
    assert np.array_equal(booleanize.booleanize_images(img),
                          jbool.booleanize_images(img))
    assert np.array_equal(booleanize.booleanize_images(img, 0.7),
                          jbool.booleanize_images(img, 0.7))


def test_to_device_bool():
    x = np.array([[0, 1, 1], [1, 0, 0]], np.uint8)
    t = booleanize.to_device_bool(x, device="cpu")
    assert t.dtype == torch.bool and t.device.type == "cpu"
    assert np.array_equal(t.numpy(), np.asarray(jbool.to_device_bool(x)))
