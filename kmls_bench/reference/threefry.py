"""Threefry-2x32 and the uniform draws built on it, as JAX defines them
(``jax.random`` in its default 32-bit, partitionable mode), in plain
PyTorch.

- ``PRNGKey(seed)`` is ``(0, seed mod 2**32)``;
- key ``i`` of ``split(key, n)`` is ``threefry2x32(key, (0, i))``;
- element ``n`` (the flat row-major index) of a 32-bit ``bits`` draw is
  ``y0 ^ y1`` of ``threefry2x32(key, (n >> 32, n mod 2**32))``;
- ``uniform`` is the float32 with the bits' top 23 as its mantissa over
  the exponent of 1.0, minus 1.0.

Values travel as int64 tensors that hold uint32 values, masked after every
add and shift.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(key0, key1, c0: torch.Tensor, c1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The block cipher on the counter pair ``(c0, c1)`` under the key
    ``(key0, key1)``: 20 rounds, a key injection after every four."""
    k = (key0 & M32, key1 & M32, (key0 ^ key1 ^ _PARITY) & M32)
    x0 = (c0 + k[0]) & M32
    x1 = (c1 + k[1]) & M32
    for block in range(5):
        for r in _ROT[block % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + k[(block + 1) % 3]) & M32
        x1 = (x1 + k[(block + 2) % 3] + block + 1) & M32
    return x0, x1


def split_keys(seed: int, blocks: torch.Tensor) -> torch.Tensor:
    """Keys ``blocks`` (int64 tensor of indices) of
    ``split(PRNGKey(seed), n)`` → int64 ``(len(blocks), 2)``."""
    zero = torch.zeros_like(blocks)
    a, b = threefry2x32(0, int(seed) & M32, zero, blocks)
    return torch.stack([a, b], dim=1)


def bits(key0: torch.Tensor, key1: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The 32 bits of flat element ``index`` of a ``bits`` draw."""
    y0, y1 = threefry2x32(key0, key1, index >> 32, index & M32)
    return y0 ^ y1


def uniform(raw: torch.Tensor) -> torch.Tensor:
    """float32 uniforms of ``[0, 1)`` from 32 random bits."""
    word = ((raw >> 9) | 0x3F800000).to(torch.int32)
    return word.view(torch.float32) - 1.0
