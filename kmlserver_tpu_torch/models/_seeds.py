"""Seed encoding shared by the two model objects."""

from __future__ import annotations

import numpy as np


def encode_seeds(
    index: dict[str, int], seed_sets: list[list[str]], pad_len: int | None = None
) -> np.ndarray:
    """Seed names → int32 (B, L) id batch, -1 padded; unknown names drop."""
    ids = [[index[s] for s in seeds if s in index] for seeds in seed_sets]
    length = pad_len or max((len(r) for r in ids), default=1) or 1
    out = np.full((len(seed_sets), length), -1, dtype=np.int32)
    for r, row in enumerate(ids):
        out[r, : min(len(row), length)] = row[:length]
    return out


def bucketed_seeds(index: dict[str, int], seed_sets: list[list[str]]) -> np.ndarray:
    """The batch padded to power-of-two rows and seed slots — the bounded
    shape set both models' lookups run at (the reference's buckets)."""
    longest = max((len(s) for s in seed_sets), default=1)
    pad_len = 1 << max(longest - 1, 0).bit_length()
    arr = encode_seeds(index, seed_sets, pad_len=pad_len)
    n_rows = 1 << max(len(seed_sets) - 1, 0).bit_length()
    if n_rows > arr.shape[0]:
        arr = np.concatenate(
            [arr, np.full((n_rows - arr.shape[0], pad_len), -1, dtype=np.int32)]
        )
    return arr
