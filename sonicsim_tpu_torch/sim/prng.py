"""jax's threefry-2x32 random stream in torch, without jax.

The RIR renderers draw their tail noise as
``jax.random.normal(fold_in(PRNGKey(seed), channel), (n,), float32)``
(``sonicsim_tpu/sim/image_source.py`` ``tail_noise``). This module computes
the same stream on any device, in the form jax uses with
``jax_threefry_partitionable=True`` (its default): element ``i`` of a draw
hashes the counter pair ``(0, i)`` under the key and keeps the xor of the
two output words.

Keys and raw bits equal jax's exactly. Uniforms follow jax's bit recipe, so
they are equal too; normals are ``√2 · erfinv(u)``, whose erfinv differs
from XLA's by a few float32 ulps (within 3e-5 absolute).

torch has no unsigned 32-bit arithmetic, so the words live in int64 and
every sum is cut back with ``& 0xFFFFFFFF``. A key is an int64 tensor
``(..., 2)`` holding two uint32 words.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block (20 rounds) of counters (x0, x1) under the key
    (k0, k1); all int64 tensors of uint32 values that broadcast together.
    Returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2^32): ``[0, seed]``.
    ``seed`` is an int or an integer tensor (a batch of keys)."""
    s = torch.as_tensor(seed, dtype=torch.int64, device=device) & _M32
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed with the counter (0, data)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits per element, ``(..., n)`` int64 in [0, 2^32), for keys
    ``(..., 2)``: element i is the xor of the block of counter (0, i)."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None], torch.zeros_like(i), i)
    return y0 ^ y1


def uniform(k: torch.Tensor, n: int, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled."""
    bits = (random_bits(k, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


_NEXT_BELOW_MINUS_ONE = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.normal(key, (n,), float32)``: √2·erfinv of a uniform on
    [nextafter(−1, 0), 1)."""
    u = uniform(k, n, _NEXT_BELOW_MINUS_ONE, 1.0)
    return torch.erfinv(u) * torch.tensor(math.sqrt(2.0), dtype=torch.float32)
