"""The served packing's entry point (``kernels.pack_literals``) on the CPU,
exact: it equals ``core.tm.pack_literals`` and the JAX reference's
``pack_literals`` bit for bit (and a numpy packing of ``x != 0`` up to
8,192 rows), at the served widths (784 MNIST features, 1,122 HAR) and the
widths that break a 16-byte row (1, 15, 16, 17), from one word to 1,024
(32,768 rows, the mnist-bulk batch).  Feature bytes are drawn in [0, 4):
any nonzero byte packs as 1.  The kernel itself is held to the twin on
the card (``test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import tm as jtm
from repro_torch.accel import Accelerator
from repro_torch.core import bits, compress, tm
from repro_torch.kernels.pack_literals import kernel as plk

FEATURES = [1, 15, 16, 17, 784, 1122]
WORDS = [1, 3, 256, 1024]


def packed_np(x: np.ndarray) -> np.ndarray:
    """uint32[2F, B // 32]: bit b of word [2k, w] is x[32w + b, k] != 0,
    word [2k + 1, w] its complement."""
    on = x != 0
    b, f = on.shape
    lits = np.empty((b, 2 * f), bool)
    lits[:, 0::2], lits[:, 1::2] = on, ~on
    words = np.packbits(lits.T.reshape(2 * f, b // 32, 32), axis=-1, bitorder="little")
    return np.ascontiguousarray(words).view("<u4")[..., 0]


@pytest.mark.parametrize("w", WORDS)
@pytest.mark.parametrize("f", FEATURES)
def test_entry_point_equals_the_twin_the_reference_and_numpy(f, w):
    x = np.random.default_rng(f * 7919 + w).integers(0, 4, (32 * w, f), dtype=np.uint8)
    before = plk.launches
    got = plk.pack_literals(torch.from_numpy(x))
    assert plk.launches == before
    assert got.dtype == torch.int32 and got.shape == (2 * f, w)
    assert torch.equal(got, tm.pack_literals(torch.from_numpy(x)))
    got = bits.to_u32(got)
    np.testing.assert_array_equal(got, np.asarray(jtm.pack_literals(jnp.asarray(x))))
    if w <= 256:  # the layout from first principles (a second at 32,768 rows)
        np.testing.assert_array_equal(got, packed_np(x))


@pytest.mark.parametrize("fill", [0, 1, 255])
def test_uniform_blocks_pack_to_all_ones_or_all_zeros(fill):
    x = torch.full((96, 17), fill, dtype=torch.uint8)
    got = bits.to_u32(plk.pack_literals(x))
    on = 0xFFFFFFFF if fill else 0
    assert (got[0::2] == on).all() and (got[1::2] == (~on & 0xFFFFFFFF)).all()
    np.testing.assert_array_equal(
        got, np.asarray(jtm.pack_literals(jnp.asarray(x.numpy())))
    )


def test_entry_point_raises_on_what_it_does_not_take():
    x = torch.zeros((64, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of 32"):
        plk.pack_literals(x[:40])
    for dtype in (torch.int32, torch.bool):
        with pytest.raises(TypeError, match="uint8"):
            plk.pack_literals(x.to(dtype))
    with pytest.raises(ValueError, match=r"\[B, F\]"):
        plk.pack_literals(x[0])
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        plk.pack_literals(x.to("meta"))


@pytest.mark.parametrize("engine", ["popcount", "sharded"])
def test_packing_engines_on_the_cpu_serve_the_dense_sums(engine):
    rng = np.random.default_rng(5)
    cfg = tm.TMConfig(4, 8, 40)
    acts = rng.random((4, 8, 80)) < 0.1
    x = rng.integers(0, 2, (100, 40), dtype=np.uint8)
    acc = Accelerator.for_models([compress.encode(cfg, acts)], batch_words=4,
                                 engine=engine, device="cpu")
    acc.load("s", acc.compile(compress.encode(cfg, acts)))
    state = tm.state_from_actions(cfg, torch.from_numpy(acts))
    want = tm.batch_class_sums(cfg, state, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(acc.class_sums("s", x), want)
