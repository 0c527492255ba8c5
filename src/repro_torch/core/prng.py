"""Counter-based random numbers that reproduce ``jax.random`` bit for bit.

The port trains under the reference's seeding contract (``core.train``),
so its random streams must be the reference's: JAX's default PRNG,
threefry2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011) with ``jax_threefry_partitionable`` on, JAX's default.
Under that setting

  * ``key(seed)``           is the word pair ``[seed >> 32, seed & M]``;
  * ``fold_in(k, d)``       is ``threefry2x32(k, (0, d))``;
  * ``split(k, n)[i]``      is ``fold_in(k, i)``;
  * ``random_bits(k, s)``   hashes each row-major flat index ``j`` of the
                            shape ``s`` as ``threefry2x32(k, (j >> 32,
                            j & M))`` and keeps ``x0 ^ x1``;
  * ``uniform``             puts the top 23 bits into a float32 mantissa
                            of exponent 0 and subtracts 1;
  * ``randint``             reduces two 32-bit draws modulo the span in
                            uint32 arithmetic;
  * ``permutation``         sorts by fresh 32-bit keys, stably, in
                            ``ceil(3 ln n / ln(2^32 - 1))`` rounds.

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words (CPU
torch has no shifts on ``uint32``, so words are carried in int64 and
masked back to 32 bits after every operation).  Every function takes a
batch of keys in the leading dimensions and works on the device of the
key; a single key lives on the host unless the caller moves it.  The
hash itself (``threefry2x32``) is written once, over anything with
Python's integer operators: int64 tensors or plain ints.  The CUDA
training kernel (``csrc/tm_train.cu``) repeats it in registers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 hash of the counter pair ``(x0, x1)``
    under the key ``(k0, k1)``: every operand a uint32 value held in an
    int64 tensor or a Python int (broadcast together) -> ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)``'s words as an int64 tensor ``[2]`` (a
    seed in the int32 range, as JAX takes it without 64-bit mode, or a
    non-negative seed below 2**64)."""
    seed = int(seed)
    words = [seed >> 32, seed & M32] if seed >= 0 else [0, seed & M32]
    return torch.tensor(words, dtype=torch.int64, device=device)


def key_data(k: torch.Tensor) -> np.ndarray:
    """A key's words as numpy ``uint32[..., 2]`` (what
    ``jax.random.wrap_key_data`` takes)."""
    return k.detach().cpu().numpy().astype(np.uint32)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``[..., 2]`` and data (an int or an
    integer tensor broadcast against the keys' leading dims) -> keys."""
    if isinstance(data, int) and k.device.type == "cpu" and k.dim() == 1:
        # one host key: plain integer arithmetic, no tensor operations
        k0, k1 = (int(w) for w in k.tolist())
        return torch.tensor(threefry2x32(k0, k1, 0, data & M32), dtype=torch.int64)
    if isinstance(data, torch.Tensor):
        data = data.to(device=k.device, dtype=torch.int64) & M32
    else:
        data = int(data) & M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys ``[..., 2]`` -> ``[..., num, 2]``."""
    idx = torch.arange(num, dtype=torch.int64, device=k.device)
    return fold_in(k[..., None, :], idx)


def random_bits(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): keys ``[..., 2]`` -> uint32 words in
    int64, shape ``[..., *shape]``."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(
        k[..., 0, None], k[..., 1, None], idx >> 32, idx & M32
    )
    return (y0 ^ y1).reshape((*k.shape[:-1], *shape))


def uniform(k: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` in float32 over [0, 1): the top 23
    random bits under the exponent of 1.0, minus 1."""
    mantissa = (random_bits(k, shape) >> 9) | 0x3F800000
    return mantissa.to(torch.int32).view(torch.float32) - 1.0


def randint(k: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32 result):
    two words from ``split(k)``, ``(hi % span) * (2**32 % span) + lo %
    span`` reduced modulo the span, all in uint32 arithmetic."""
    sub = split(k)
    hi = random_bits(sub[..., 0, :], shape)
    lo = random_bits(sub[..., 1, :], shape)
    span = (maxval - minval) & M32 if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & M32) % span
    offset = (((hi % span) * multiplier) & M32) + lo % span
    offset = (offset & M32) % span
    return (minval + offset).to(torch.int32)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: int64 ``[n]``, a stable sort by
    fresh 32-bit keys per round (``k, sub = split(k)``)."""
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(M32))
    for _ in range(rounds):
        sub = split(k)
        k, sub = sub[0], sub[1]
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
