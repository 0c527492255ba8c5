"""Weighted configurations: the seeded clause weights, the weighted
reference, the work count, the refusal of inconsistent keys and
``correct`` at a tiny weighted size on the CPU."""

import hashlib
import json

import numpy as np
import pytest
import torch

from tmbench.clients import schedule
from tmbench.harness import Run
from tmbench.reference.classsums import class_sums
from tmbench.reference.data import DataSource
from tmbench.weights import clause_weights, include_actions
from tmbench.work import inference_work

from .conftest import REPO, TINY_CONFIG, TINY_TRAFFIC, add_cell, run_python

WEIGHTS_255 = {"dist": "log_uniform", "min": 1, "max": 255}
TINY_WEIGHTED = {**TINY_CONFIG, "name": "tm-tiny-weighted", "weighted": True,
                 "clause_weights": WEIGHTS_255}


def load(name):
    return json.loads((REPO / "tmbench" / name).read_text())


def digest(*arrays):
    d = hashlib.sha256()
    for a in arrays:
        d.update(np.ascontiguousarray(a).tobytes())
    return d.hexdigest()[:16]


def brute_force(actions, x, weights):
    M, C, L2 = actions.shape
    out = np.zeros((x.shape[0], M), np.int64)
    for r in range(x.shape[0]):
        lits = [x[r, k // 2] if k % 2 == 0 else 1 - x[r, k // 2] for k in range(L2)]
        for m in range(M):
            for c in range(C):
                inc = [k for k in range(L2) if actions[m, c, k]]
                fires = bool(inc) and all(lits[k] == 1 for k in inc)
                out[r, m] += (1 if c % 2 == 0 else -1) * int(weights[m, c]) * fires
    return out


def test_weighted_sums_match_brute_force_with_an_empty_clause():
    rng = np.random.default_rng(3)
    actions = rng.random((3, 6, 16)) < 0.15
    actions[1, 2] = False  # a clause with no includes outputs 0, whatever its weight
    weights = rng.integers(1, 65536, (3, 6)).astype(np.int32)
    weights[1, 2] = 65535
    x = rng.integers(0, 2, (40, 8)).astype(np.uint8)
    want = brute_force(actions, x, weights)
    got = class_sums(torch.from_numpy(actions), torch.from_numpy(x), block_rows=7,
                     weights=torch.from_numpy(weights))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ones = class_sums(torch.from_numpy(actions), torch.from_numpy(x),
                      weights=torch.ones((3, 6), dtype=torch.int32))
    np.testing.assert_array_equal(
        ones.numpy(), class_sums(torch.from_numpy(actions), torch.from_numpy(x)).numpy())


def test_weighted_sums_match_the_ports_weighted_class_sums():
    from repro_torch.core.tm import TMConfig, batch_class_sums_weighted, state_from_actions

    config = {**load("configs/tm-mnist.json"), "n_clauses": 20, "weighted": True,
              "clause_weights": WEIGHTS_255}
    seed = 2**31 + 5
    source = DataSource(config, seed, "cpu")
    actions = include_actions(config, source, seed)
    weights = clause_weights(config, seed)
    x = torch.from_numpy(source.pool(256))
    cfg = TMConfig(n_classes=10, n_clauses=20, n_features=784)
    want = batch_class_sums_weighted(cfg, state_from_actions(cfg, actions), x, weights)
    got = class_sums(actions, x, weights=weights)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool((got != class_sums(actions, x)).any())  # the weights count


def test_the_int32_bound_is_checked():
    actions = torch.ones((1, 4, 2), dtype=torch.bool)
    x = torch.ones((1, 1), dtype=torch.uint8)
    big = torch.full((1, 4), 2**30, dtype=torch.int64)
    with pytest.raises(ValueError, match="exceed int32"):
        class_sums(actions, x, weights=big)  # 2 positive clauses x 2^30


@pytest.mark.parametrize("w_min, w_max", [(1, 255), (1, 2), (300, 65535)])
def test_clause_weights_are_fixed_by_the_seed_and_hold_max(w_min, w_max):
    config = {**TINY_WEIGHTED, "n_clauses": 50,
              "clause_weights": {"dist": "log_uniform", "min": w_min, "max": w_max}}
    draws = {seed: clause_weights(config, seed) for seed in (0, 1, 2, 2**31 + 7)}
    for seed, w in draws.items():
        assert w.dtype == torch.int32 and tuple(w.shape) == (4, 50)
        assert int(w.max()) == w_max and int(w.min()) >= w_min
        torch.testing.assert_close(w, clause_weights(config, seed), rtol=0, atol=0)
    assert not torch.equal(draws[0], draws[1])
    assert len(torch.cat([w.flatten() for w in draws.values()]).unique()) > min(50, w_max - 1)


def test_log_uniform_weights_spread_over_the_decades():
    config = {**TINY_WEIGHTED, "n_classes": 10, "n_clauses": 200}
    w = clause_weights(config, 2**31 + 9).flatten().double()
    # log-uniform over [1, 256): a quarter below 4, half below 16
    assert 0.2 < float((w < 4).double().mean()) < 0.3
    assert 0.45 < float((w < 16).double().mean()) < 0.55


def test_a_weightless_configuration_draws_no_weights():
    assert clause_weights(TINY_CONFIG, 5) is None
    assert clause_weights({**TINY_CONFIG, "weighted": False}, 5) is None


@pytest.mark.parametrize("seed", [5, 2**31 + 17])
def test_weights_leave_the_actions_pool_and_requests_of_a_seed_alone(seed):
    """Include actions, pool and requests are byte-equal to a weightless
    draw, and to what the harness drew before it knew of weights (the
    digests below were taken with it)."""
    parent = {
        5: ("6d7923b01f0298ff", "ac3adef2842d048d", "0a1f10c8b583863e",
            "e91223fde35c68f7", "c23594b68a33fb46"),
        2**31 + 17: ("d631c14363e553ee", "eea1cf191bc31124", "200f06791fef5ec0",
                     "b6938a3702424a24", "0b7e96c8b0f48723"),
    }[seed]
    runs = []
    for config in (TINY_CONFIG, TINY_WEIGHTED):
        run = Run(config, TINY_TRAFFIC, seed, "cpu")
        run.setup()
        run.acc.stop()
        runs.append(run)
    plain, weighted = runs
    assert plain.weights is None and weighted.weights is not None
    assert digest(plain.actions.numpy()) == digest(weighted.actions.numpy()) == parent[0]
    np.testing.assert_array_equal(plain.pool, weighted.pool)
    assert digest(plain.pool) == parent[1]
    traffic = [load("traffic/bulk.json"), load("traffic/sensors.json")]
    requests = [schedule(t, 262144, seed, c, "schedule", 64) for t in traffic for c in (0, 3)]
    assert digest(*[a for r in requests for a in r]) == parent[2]
    mnist = {**load("configs/tm-mnist.json"), "n_clauses": 20}
    source = DataSource(mnist, seed, "cpu")
    assert digest(include_actions(mnist, source, seed).numpy()) == parent[3]
    assert digest(source.pool(2048, block=1000)) == parent[4]


def test_work_is_unchanged_for_unit_weights():
    mnist = load("configs/tm-mnist.json")
    assert not mnist["weighted"] and "clause_weights" not in mnist
    w = inference_work(mnist, 32768)
    assert w["bytes"] == 32768 * (98 + 10)
    assert w["ops"] == 32768 * 17000 / 32
    unit = {**mnist, "weighted": True,
            "clause_weights": {"dist": "log_uniform", "min": 1, "max": 1}}
    assert inference_work(unit, 32768) == w
    for C in (1, 2, 127, 254, 255, 256, 511):  # C + 1 sum values, as before
        base = {"n_classes": 3, "n_features": 8, "include_density": 0.1, "n_clauses": C}
        sum_bytes = -(-int(np.ceil(np.log2(C + 1))) // 8)
        assert inference_work(base, 7)["bytes"] == 7 * (1 + 3 * sum_bytes)


def test_the_sum_width_grows_with_the_largest_weight():
    mnist = load("configs/tm-mnist.json")

    def row_bytes(w_max):
        config = {**mnist, "weighted": True,
                  "clause_weights": {"dist": "log_uniform", "min": 1, "max": w_max}}
        return inference_work(config, 1)["bytes"]

    # 200 clauses: 200 W + 1 values in 1, 2, 3 bytes
    assert row_bytes(1) == 98 + 10
    assert row_bytes(255) == 98 + 20
    assert row_bytes(327) == 98 + 20  # 65,401 values
    assert row_bytes(328) == 98 + 30  # 65,601 values
    assert row_bytes(65535) == 98 + 30
    ops = {inference_work({**mnist, "weighted": True, "clause_weights": {
        "dist": "log_uniform", "min": 1, "max": w}}, 1)["ops"] for w in (1, 255, 65535)}
    assert ops == {17000 / 32}


@pytest.mark.parametrize("keys", [
    {"weighted": True},
    {"weighted": False, "clause_weights": WEIGHTS_255},
    {"clause_weights": WEIGHTS_255},
    {"weighted": True, "clause_weights": {**WEIGHTS_255, "max": 65536}},
    {"weighted": True, "clause_weights": {**WEIGHTS_255, "min": 0}},
    {"weighted": True, "clause_weights": {**WEIGHTS_255, "dist": "zipf"}},
])
def test_inconsistent_weight_keys_are_refused(keys):
    config = {k: v for k, v in TINY_WEIGHTED.items() if k not in ("weighted", "clause_weights")}
    run = Run({**config, **keys}, TINY_TRAFFIC, 7, "cpu")
    with pytest.raises(ValueError, match="weighted|clause_weights"):
        run.setup()
    assert not hasattr(run, "pool")  # refused before anything was made


PROBE = r"""
import json
from tmbench import control
for seed in (7, 2**31 + 11):
    for variant, res in control.readings(".", "tiny-w", seed, 0.5, "cpu", True):
        print(json.dumps({"variant": variant, "correct": res["correct"],
                          **{k: v["value"] for k, v in res["checks"].items()}}))
"""


def test_weighted_controls_and_faults_fail_the_program_passes(tiny_copy):
    """The program serves the weights and reads ``correct``; the reference
    with the weights ignored, int8 (ceil(12/2) x 255 exceeds it), the tie
    rule broken and both faults do not.  int16 holds these sums."""
    add_cell(tiny_copy, "tiny-w", TINY_WEIGHTED, "tiny", TINY_TRAFFIC)
    proc = run_python(tiny_copy, PROBE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert [x["variant"] for x in lines[:7]] == [
        "program", "int16", "int8", "weights_ignored", "tie_high",
        "answer_altered", "half_batch_left_out"]
    assert len(lines) == 2 * 7
    for line in lines:
        assert line["correct"] == (line["variant"] in ("program", "int16")), line
        if line["variant"] in ("int8", "weights_ignored"):
            assert line["rows_wrong_sums"] > 0 and line["rows_wrong_class"] > 0, line
        if line["variant"] == "tie_high":
            assert line["rows_wrong_class"] > 0 and line["rows_wrong_sums"] == 0
