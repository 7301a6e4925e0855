"""Support thresholds — counterpart of ``kmlserver_tpu/ops/support.py``.

Thresholding is done in INTEGER counts computed on the host in float64, so
no device float rounding can flip a frequency decision."""

from __future__ import annotations

import math


def min_count_for(min_support: float, n_playlists: int) -> int:
    """Smallest integer count c with c / n_playlists >= min_support, computed
    in float64 exactly as a CPU oracle would compare (mlxtend keeps itemsets
    with support >= min_support). Clamped to at least 1."""
    c = int(math.ceil(min_support * n_playlists))
    # ceil can overshoot when min_support * n is an exact integer in f64
    while c > 1 and (c - 1) / n_playlists >= min_support:
        c -= 1
    return max(c, 1)
