"""Transaction encoding on the device: membership pairs → one-hot or
packed bitsets.

Counterpart of ``kmlserver_tpu/ops/encode.py``:

- :func:`onehot_matrix` — ``X ∈ {0,1}^{P×V}`` as int8, the operand of the
  dense int8 pair-count product (``ops/support.py``);
- :func:`bitpack_matrix` — ``{0,1}^{P×ceil(V/32)}`` in 32-bit words, the
  operand of the popcount kernel (``ops/popcount.py``).

torch's ``uint32`` has few ops, so bitsets are ``int32`` tensors holding the
same bit pattern (``np.ndarray.view(np.int32)`` at the boundary). torch's
``scatter_reduce`` has no bitwise-or, so the pack is the reference's
additive scatter: exact because membership pairs are deduplicated
(``build_baskets``), so every bit is added once, no carry ever happens, and
``1 << 31`` wraps harmlessly to ``-2**31`` in two's complement.
"""

from __future__ import annotations

import torch

WORD_BITS = 32


def n_words(n_tracks: int) -> int:
    return (n_tracks + WORD_BITS - 1) // WORD_BITS


def onehot_matrix(
    playlist_rows: torch.Tensor,
    track_ids: torch.Tensor,
    *,
    n_playlists: int,
    n_tracks: int,
) -> torch.Tensor:
    """Dense int8 one-hot ``(n_playlists, n_tracks)`` on the device of
    ``track_ids``. Pairs are deduplicated, so setting ones equals the
    reference's scatter-max."""
    x = torch.zeros(
        (n_playlists, n_tracks), dtype=torch.int8, device=track_ids.device
    )
    x.index_put_(
        (playlist_rows.to(torch.int64), track_ids.to(torch.int64)),
        torch.ones((), dtype=torch.int8, device=track_ids.device),
    )
    return x


def bitpack_matrix(
    playlist_rows: torch.Tensor,
    track_ids: torch.Tensor,
    *,
    n_playlists: int,
    n_tracks: int,
) -> torch.Tensor:
    """Scatter membership pairs into packed int32 bit-words
    ``(n_playlists, ceil(n_tracks / 32))``: track ``t`` occupies bit
    ``t % 32`` of word ``t // 32``, on the device of ``track_ids``."""
    rows = playlist_rows.to(torch.int64)
    tids = track_ids.to(torch.int64)
    width = n_words(n_tracks)
    # int64 shift, then a wrapping cast: bit 31 becomes -2**31
    bits = (torch.ones_like(tids) << (tids % WORD_BITS)).to(torch.int32)
    packed = torch.zeros(
        n_playlists * width, dtype=torch.int32, device=track_ids.device
    )
    packed.index_add_(0, rows * width + tids // WORD_BITS, bits)
    return packed.view(n_playlists, width)
