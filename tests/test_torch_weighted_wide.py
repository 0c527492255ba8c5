"""Integer-weighted machines served through ``Accelerator.for_models`` on
the default engine (``popcount``) at eight and sixteen weight planes:
class sums and predictions equal to the benchmark's plain reference
(``tmbench/reference/classsums.py``) and ``batch.launch`` carrying the
program's weight planes x clause chunks.  The ``cuda`` case serves the
integer-weighted MNIST machine at its full width (10 x 2,000 x 784,
weights to 255) and holds ``tm_popcount`` to its plain twin there; it
skips without a card:

    python -m pytest -q -m cuda tests/test_torch_weighted_wide.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.accel import Accelerator
from repro_torch.core import compress, tm
from repro_torch.kernels.pack_literals.kernel import pack_literals
from repro_torch.kernels.tm_popcount import kernel as tp_kernel

REPO = Path(__file__).resolve().parents[1]


def _reference():
    """The benchmark's plain reference, loaded from its file (it imports
    torch and numpy only)."""
    path = REPO / "tmbench" / "reference" / "classsums.py"
    spec = importlib.util.spec_from_file_location("tmbench_classsums", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _machine(seed, M, C, F, w_max, per_clause=(3, 6)):
    """Seeded include actions bool[M, C, 2F] (a few includes a clause, one
    clause empty) and weights int32[M, C], log-uniform over [1, w_max],
    one clause at ``w_max``."""
    rng = np.random.default_rng(seed)
    actions = np.zeros((M, C, 2 * F), bool)
    for m in range(M):
        for c in range(C):
            k = rng.integers(*per_clause)
            feats = rng.choice(F, k, replace=False)
            actions[m, c, 2 * feats + rng.integers(0, 2, k)] = True
    actions[0, 1] = False
    u = rng.random((M, C))
    weights = np.floor(np.exp(u * np.log(w_max + 1))).clip(1, w_max).astype(np.int32)
    weights[M - 1, C - 2] = w_max
    return actions, weights


def _rows(rng, n, F, actions):
    """Rows that make some clauses fire: half random, half copies of a
    clause's includes with the rest random."""
    x = rng.integers(0, 2, (n, F), dtype=np.uint8)
    M, C, _ = actions.shape
    for r in range(0, n, 2):
        lits = np.flatnonzero(actions[rng.integers(M), rng.integers(C)])
        x[r, lits // 2] = 1 - lits % 2
    return x


@pytest.mark.parametrize("w_max, planes", [(255, 8), (65535, 16)])
def test_weighted_machine_served_exact_with_planes_and_chunks(w_max, planes):
    M, C, F = 3, 96, 64
    actions, weights = _machine(w_max, M, C, F, w_max)
    model = compress.encode(tm.TMConfig(M, C, F), actions, weights)
    acc = Accelerator.for_models([model], batch_words=2, device="cpu")
    assert acc.engine.name == "popcount"
    assert acc.capacity.weight_planes == planes
    rng = np.random.default_rng(w_max + 1)
    x = _rows(rng, 150, F, actions)
    ref = _reference()
    want = ref.class_sums(torch.from_numpy(actions), torch.from_numpy(x),
                          weights=torch.from_numpy(weights)).numpy()
    assert np.abs(want).max() > w_max  # the weights reach the sums
    chunks = -(-(M * C - 1) // 32)  # the empty clause is dropped
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        acc.load("w", acc.compile(model).to_bytes())
        handles = [acc.submit("w", x[i:i + 50]) for i in range(0, 150, 50)]
        acc.flush()
    np.testing.assert_array_equal(np.concatenate([h.class_sums for h in handles]), want)
    np.testing.assert_array_equal(np.concatenate([h.result() for h in handles]),
                                  ref.predictions(want))
    np.testing.assert_array_equal(acc.class_sums("w", x[:64]), want[:64])
    spans = acc.metrics.spans()
    launch = spans[spans["name"] == "batch.launch"]
    assert launch.size == 3 and (launch["arg"] == planes * chunks).all()


def test_weightless_machine_launches_one_plane_and_builds_unlogged():
    """One plane for a weightless machine; no profile, no spans, and a
    profiled batch's ``batch.launch`` carries the one plane's chunks."""
    M, C, F = 3, 40, 20
    actions, _ = _machine(3, M, C, F, 1)
    model = compress.encode(tm.TMConfig(M, C, F), actions)
    acc = Accelerator.for_models([model], batch_words=1, device="cpu")
    acc.load("u", acc.compile(model))
    x = _rows(np.random.default_rng(4), 64, F, actions)
    acc.infer("u", x[:32])
    chunks = -(-(M * C - 1) // 32)
    assert acc.registry.get("u").program["plane_chunks"] == chunks
    assert acc.metrics.spans().size == 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        acc.infer("u", x[32:])
    launch = acc.metrics.spans()
    launch = launch[launch["name"] == "batch.launch"]
    assert launch.size == 1 and launch["arg"][0] == chunks


@pytest.mark.cuda
def test_iwtm_mnist_width_kernel_matches_plain_twin_and_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    M, C, F = 10, 2000, 784
    actions, weights = _machine(7, M, C, F, 255, per_clause=(8, 10))
    model = compress.encode(tm.TMConfig(M, C, F), actions, weights)
    acc = Accelerator.for_models([model], batch_words=64, device=dev)
    acc.load("w", acc.compile(model))
    prog = acc.registry.get("w").program
    assert acc.capacity.weight_planes == 8
    assert prog["plane_chunks"] == 8 * 625
    x = _rows(np.random.default_rng(8), 64 * 32, F, actions)
    ref = _reference()
    want = ref.class_sums(torch.from_numpy(actions).to(dev), torch.from_numpy(x).to(dev),
                          weights=torch.from_numpy(weights)).cpu().numpy()
    np.testing.assert_array_equal(acc.class_sums("w", x), want)
    cap = acc.capacity  # the block the engine packs: rows and features padded
    block = np.zeros((cap.batch_capacity, cap.feature_capacity), np.uint8)
    block[: x.shape[0], :F] = x
    packed = pack_literals(torch.from_numpy(block).to(dev))
    program = prog["popcount"]
    before = tp_kernel.launches
    got = tp_kernel.tm_popcount(program, packed)
    torch.cuda.synchronize()
    assert tp_kernel.launches == before + 2
    plain = tp_kernel.tm_popcount_plain(*program[:4], packed)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    np.testing.assert_array_equal(got[:M, : x.shape[0]].T.cpu().numpy(), want)
