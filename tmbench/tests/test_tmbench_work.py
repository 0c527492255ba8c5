"""The inference work count against a count made by hand."""

import inspect

from tmbench.work import HBM_BW, PEAK_FP32_FLOPS, inference_work, n_includes


def test_work_count_by_hand():
    config = {"n_classes": 2, "n_clauses": 4, "n_features": 20, "include_density": 0.1}
    # 2 x 4 x 40 automata at 10%: 32 includes
    assert n_includes(config) == 32
    w = inference_work(config, 64)
    # 64 rows x (20 features at one bit: 3 bytes + 2 classes x 1 byte)
    assert w["bytes"] == 64 * (3 + 2)
    # one 32-bit AND per include per 32 rows
    assert w["ops"] == 2 * 32
    assert w["seconds"] == max(320 / HBM_BW, 64 / PEAK_FP32_FLOPS)
    assert w["bound"] == "bytes"


def test_sum_bytes_grow_with_the_clause_count():
    base = {"n_classes": 1, "n_features": 8, "include_density": 0.0}
    # [-C/2, C/2] takes one byte up to 255 clauses, two beyond
    assert inference_work({**base, "n_clauses": 254}, 1)["bytes"] == 1 + 1
    assert inference_work({**base, "n_clauses": 256}, 1)["bytes"] == 1 + 2


def test_the_paper_mnist_count():
    config = {"n_classes": 10, "n_clauses": 200, "n_features": 784,
              "include_density": 17000 / 3136000}
    w = inference_work(config, 32768)
    assert n_includes(config) == 17000
    assert w["bytes"] == 32768 * (98 + 10)
    assert w["ops"] == 32768 * 17000 / 32
    assert w["bound"] == "bytes"


def test_work_takes_only_the_configuration_and_rows():
    assert list(inspect.signature(inference_work).parameters) == ["config", "rows"]
