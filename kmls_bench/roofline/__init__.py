"""Roofline counts, one file per kernel, found by the kernel's name.

Each module defines ``work(**dims) -> (ops, bytes, peak_key)``: the
operations and bytes the algorithm needs for one call at those sizes
(each input byte read once, each output byte written once), and the key
of ``peaks.json`` whose rate bounds those operations. :func:`least_seconds`
turns that into the least time the card could take.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"


def peaks_for(device_kind: str) -> dict | None:
    """The published peaks of ``device_kind``, or None for a card the
    table does not hold (a roofline is then not reported)."""
    return json.loads(PEAKS.read_text()).get(device_kind)


def count(kernel: str, **dims) -> tuple[float, float, str]:
    return importlib.import_module(f"{__name__}.{kernel}").work(**dims)


def least_seconds(kernel: str, device_kind: str, **dims) -> float | None:
    """max(operations / peak rate, bytes / peak bandwidth), or None."""
    peaks = peaks_for(device_kind)
    if peaks is None:
        return None
    ops, nbytes, key = count(kernel, **dims)
    return max(ops / peaks[key], nbytes / peaks["hbm_bytes_per_s"])
