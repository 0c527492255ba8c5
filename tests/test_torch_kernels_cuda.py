"""The dense and interpreter kernels against their plain twins on a CUDA
card, exact (integer words, counts and sums: tolerance 0).

Marked ``cuda``; every test skips itself without a card.  The file
imports no JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import compress
from repro_torch.core.bits import from_u32
from repro_torch.core.tm import TMConfig
from repro_torch.kernels.clause_eval import kernel as ce_kernel
from repro_torch.kernels.clause_eval.ref import clause_eval_ref
from repro_torch.kernels.clause_matmul import kernel as cm_kernel
from repro_torch.kernels.tm_interp import kernel as ti_kernel
from repro_torch.kernels.tm_interp.ops import clause_ends, plan_to_operands

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _u32(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("nc,l2,w", [(33, 30, 2), (200, 1568, 37), (7, 5000, 300)])
def test_clause_eval_kernel_matches_plain_twin(dev, nc, l2, w):
    rng = np.random.default_rng(nc)
    actions = (rng.random((nc, l2)) < 0.01).astype(np.int32)
    actions[0] = 0
    a, lits = torch.from_numpy(actions).to(dev), from_u32(_u32(rng, (l2, w)), dev)
    before = ce_kernel.launches
    got = ce_kernel.clause_eval(a, lits)
    assert ce_kernel.launches == before + 1
    torch.testing.assert_close(got, ce_kernel.clause_eval_plain(a, lits), rtol=0, atol=0)
    torch.testing.assert_close(
        got.cpu(), clause_eval_ref(a.cpu(), lits.cpu()), rtol=0, atol=0
    )


@pytest.mark.parametrize("nc,l2,b", [(33, 30, 40), (200, 1568, 8191), (129, 33, 129)])
def test_clause_matmul_kernel_matches_plain_twin(dev, nc, l2, b):
    rng = np.random.default_rng(nc + b)
    actions = (rng.random((nc, l2)) < 0.01).astype(np.int32)
    actions[::2, l2 // 2:] = 0  # even clauses include only the all-ones half
    actions[1] = 0
    lits = rng.integers(0, 2, (l2, b)).astype(np.int32)
    lits[: l2 // 2] = 1
    a, l01 = torch.from_numpy(actions).to(dev), torch.from_numpy(lits).to(dev)
    before = cm_kernel.launches
    got = cm_kernel.clause_matmul(a, l01)
    assert cm_kernel.launches == before + 3  # narrow A, narrow L, product
    torch.testing.assert_close(got, cm_kernel.clause_matmul_plain(a, l01), rtol=0, atol=0)
    assert got.any() and not got[1].any()


@pytest.mark.parametrize(
    "i_cap_extra,w,zero_class", [(0, 8, None), (13, 37, 2), (5, 300, None)]
)
def test_tm_interp_kernel_matches_plain_twin(dev, i_cap_extra, w, zero_class):
    rng = np.random.default_rng(11)
    acts = rng.random((20, 30, 80)) < 0.08
    if zero_class is not None:
        acts[zero_class] = False
    plan = compress.decode_to_plan(compress.encode(TMConfig(20, 30, 40), acts))
    i_cap = plan.n_includes + i_cap_extra
    ops = [torch.from_numpy(a).to(dev) for a in plan_to_operands(plan, i_cap)]
    lits = from_u32(_u32(rng, (80, w)), dev)
    lits[::2] = -1  # positive literals all ones, so that clauses fire
    before = ti_kernel.launches
    got = ti_kernel.tm_interp(*ops, lits, m_cap=20)
    assert ti_kernel.launches == before + 1
    torch.testing.assert_close(
        got, ti_kernel.tm_interp_plain(*ops, lits, 20), rtol=0, atol=0
    )
    assert got.any()
    if zero_class is not None:
        assert not got[zero_class].any()
    table = torch.from_numpy(clause_ends(ops[1].cpu().numpy())).to(dev)
    torch.testing.assert_close(
        ti_kernel.tm_interp(*ops, lits, m_cap=20, clause_end=table), got,
        rtol=0, atol=0,
    )


def test_tm_interp_kernel_stays_in_bounds_on_a_bad_clause_table(dev):
    """Entries outside [0, I_cap) are skipped and a run never starts
    before instruction 0: a malformed table reads nothing outside the
    operands (the sums are then not the plan's)."""
    acts = np.random.default_rng(5).random((4, 6, 20)) < 0.2
    plan = compress.decode_to_plan(compress.encode(TMConfig(4, 6, 10), acts))
    ops = [torch.from_numpy(a).to(dev) for a in plan_to_operands(plan, 256)]
    lits = torch.full((20, 3), -1, dtype=torch.int32, device=dev)
    table = torch.tensor([-7, 2, 1 << 30, 5, 3], dtype=torch.int32, device=dev)
    got = ti_kernel.tm_interp(*ops, lits, m_cap=4, clause_end=table)
    torch.cuda.synchronize()
    assert got.shape == (4, 96)
    assert got.abs().max() <= 3  # at most the three in-range entries emit
