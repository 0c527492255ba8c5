"""The plain reference against a brute-force loop, and the frozen data
generator against the port's booleanizer."""

import json

import numpy as np
import torch

from tmbench.reference.classsums import class_sums, predictions
from tmbench.reference.data import DataSource, Thermometer
from tmbench.weights import include_actions
from tmbench.work import n_includes

from .conftest import REPO, TINY_CONFIG


def brute_force(actions, x):
    M, C, L2 = actions.shape
    out = np.zeros((x.shape[0], M), np.int64)
    for r in range(x.shape[0]):
        lits = [x[r, k // 2] if k % 2 == 0 else 1 - x[r, k // 2] for k in range(L2)]
        for m in range(M):
            for c in range(C):
                inc = [k for k in range(L2) if actions[m, c, k]]
                fires = bool(inc) and all(lits[k] == 1 for k in inc)
                out[r, m] += (1 if c % 2 == 0 else -1) * fires
    return out


def test_class_sums_match_brute_force_with_an_empty_clause():
    rng = np.random.default_rng(0)
    actions = rng.random((3, 6, 16)) < 0.15
    actions[1, 2] = False  # a clause with no includes outputs 0
    actions[2, 3] = False
    x = rng.integers(0, 2, (40, 8)).astype(np.uint8)
    want = brute_force(actions, x)
    got = class_sums(torch.from_numpy(actions), torch.from_numpy(x), block_rows=7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    narrow = class_sums(torch.from_numpy(actions), torch.from_numpy(x), dtype=torch.int16)
    np.testing.assert_array_equal(narrow.numpy(), want)


def test_an_empty_clause_does_not_fire_on_any_row():
    actions = np.zeros((1, 2, 4), bool)
    actions[0, 1, 0] = True  # the negative clause needs feature 0
    x = np.array([[0, 0], [1, 1]], np.uint8)
    got = class_sums(torch.from_numpy(actions), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, [[0], [-1]])


def test_prediction_takes_the_first_class_of_a_tie():
    sums = np.array([[3, 5, 5, 1], [2, 2, 2, 2], [-1, -4, -1, -2]], np.int32)
    np.testing.assert_array_equal(predictions(sums), [1, 0, 0])


def test_thermometer_equals_the_ports_booleanizer():
    from repro_torch.core.booleanize import Booleanizer

    x = np.random.default_rng(1).normal(size=(500, 7)).astype(np.float32)
    for bits in (1, 2, 4):
        port = Booleanizer.fit(x, bits=bits)
        ours = Thermometer.fit(torch.from_numpy(x), bits)
        np.testing.assert_allclose(ours.thresholds.numpy(), port.thresholds, rtol=1e-5)
        probe = np.random.default_rng(2).normal(size=(300, 7)).astype(np.float32)
        np.testing.assert_array_equal(
            Thermometer(torch.from_numpy(port.thresholds).float()).transform(
                torch.from_numpy(probe)).numpy(),
            port.transform(probe))


def test_data_is_fixed_by_the_seed():
    a = DataSource(TINY_CONFIG, 2**31 + 9, "cpu").pool(1000, block=300)
    b = DataSource(TINY_CONFIG, 2**31 + 9, "cpu").pool(1000, block=300)
    c = DataSource(TINY_CONFIG, 3, "cpu").pool(1000, block=300)
    assert a.shape == (1000, 30) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_include_actions_hold_the_stated_count_on_every_seed():
    for name in ("tm-mnist", "tm-har"):
        config = json.loads((REPO / "tmbench" / "configs" / f"{name}.json").read_text())
        config = {**config, "n_clauses": 20}  # fewer clauses, the same widths
        for seed in (0, 2**31 + 1):
            source = DataSource(config, seed, "cpu")
            acts = include_actions(config, source, seed)
            M, C, F = config["n_classes"], 20, config["n_features"]
            assert acts.shape == (M, C, 2 * F)
            assert int(acts.sum()) == n_includes(config)
            per = acts.sum(dim=2).flatten()
            assert int(per.max()) - int(per.min()) <= 1
            # never a feature and its negation in one clause
            assert not bool((acts[..., 0::2] & acts[..., 1::2]).any())
