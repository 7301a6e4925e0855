"""ctypes bindings for the native CPU mining kernels
(``native/kmls_popcount.cpp``) — counterpart of
``kmlserver_tpu/ops/cpu_popcount.py``: the miner's count route and host
emission when the caller asks for the CPU.

- :func:`pair_counts` — the ``XᵀX`` pair-count matrix, by either an
  L2-tiled POPCNT scan over bit-packed rows or a sparse per-playlist pair
  scatter whose cost is the pair mass Σ_p C(k_p, 2); a cost model picks
  (:func:`choose_method`).
- :func:`bitpack_rows` — one scatter pass over the membership rows, no
  V×P transient (little bit order: bit p of row t's words ⇔ playlist p
  contains track t; zero padding contributes zero counts).
- :func:`emit_topk` — per-row rule emission with the device emission's
  exact tie order (count desc, column asc) via a bounded min-heap.

Built by ``utils/nativelib.py`` at first use; callers check
:func:`available` and take the PyTorch route otherwise. ``KMLS_NATIVE=0``
turns every native route off; ``KMLS_NATIVE_PAIR_METHOD`` and
``KMLS_NATIVE_THREADS`` are read per call.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils import nativelib

# must match kAbiVersion in native/kmls_popcount.cpp
_ABI_VERSION = 4

# calls of each counter and of the top-k (host calls, not kernel launches)
CALLS = {"bitset": 0, "sparse": 0, "emit_topk": 0}


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.kmls_popcount_abi_version.restype = ctypes.c_int32
    lib.kmls_popcount_abi_version.argtypes = []
    got = lib.kmls_popcount_abi_version()
    if got != _ABI_VERSION:
        raise OSError(
            f"native popcount ABI {got} != expected {_ABI_VERSION}"
        )
    lib.kmls_pair_counts.restype = None
    lib.kmls_pair_counts.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
    ]
    lib.kmls_bitpack_rows.restype = None
    lib.kmls_bitpack_rows.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.kmls_pair_counts_sparse.restype = None
    lib.kmls_pair_counts_sparse.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.kmls_emit_topk.restype = None
    lib.kmls_emit_topk.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


_loader = nativelib.NativeLib("kmls_popcount", _bind)


def _load() -> ctypes.CDLL | None:
    return _loader.load()


def available() -> bool:
    return _loader.available()


def bitpack_rows(
    playlist_rows: np.ndarray,
    track_ids: np.ndarray,
    *,
    n_playlists: int,
    n_tracks: int,
) -> np.ndarray:
    """→ ``(n_tracks, ceil(P/64)) uint64``: bit p of row t set iff playlist
    p contains track t. Duplicate membership rows OR idempotently (same as
    the device one-hot's scatter-max, ops/encode.py).

    Packed by the native scatter — one linear pass over the rows with no
    V×P transient (a numpy ``packbits`` route would need the whole bool
    matrix)."""
    rows = np.ascontiguousarray(playlist_rows, dtype=np.int64)
    ids = np.ascontiguousarray(track_ids, dtype=np.int32)
    if len(rows):
        _validate(rows, ids, n_playlists, n_tracks)
    return _bitpack_unchecked(
        rows, ids, n_playlists=n_playlists, n_tracks=n_tracks
    )


def _bitpack_unchecked(
    rows: np.ndarray, ids: np.ndarray, *, n_playlists: int, n_tracks: int
) -> np.ndarray:
    """The scatter itself: contiguous int64/int32 inputs, ALREADY bounds-
    validated by the caller (the C side is unchecked)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native popcount unavailable")
    w64 = (n_playlists + 63) // 64
    bt = np.zeros((n_tracks, max(w64, 1)), dtype=np.uint64)
    if len(rows):
        lib.kmls_bitpack_rows(
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(len(rows)),
            ctypes.c_int64(bt.shape[1]),
            bt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
    return bt


def emit_topk(
    counts: np.ndarray, min_count: int, *, k_max: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native rule emission: per-row top-k by (count desc, column asc) —
    the device emission's exact tie order — padded to ``k_max``. Same
    outputs as ``ops.rules.emit_rule_tensors_np`` (the fallback and the
    cross-check twin).

    Raises RuntimeError when the native library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native popcount unavailable")
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    v = counts.shape[0]
    k = min(k_max, v)
    rule_ids = np.empty((v, max(k, 0)), dtype=np.int32)
    rule_counts = np.empty((v, max(k, 0)), dtype=np.int32)
    row_valid = np.empty(v, dtype=np.int32)
    CALLS["emit_topk"] += 1
    if v:
        lib.kmls_emit_topk(
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(v),
            ctypes.c_int32(min_count),
            ctypes.c_int32(k),
            rule_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rule_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            row_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    if k < k_max:  # pad up to the declared row capacity
        pad = ((0, 0), (0, k_max - k))
        rule_ids = np.pad(rule_ids, pad, constant_values=-1)
        rule_counts = np.pad(rule_counts, pad)
    return rule_ids, rule_counts, row_valid


def _validate(
    rows: np.ndarray, ids: np.ndarray, n_playlists: int, n_tracks: int
) -> None:
    """Bounds guard the unchecked C kernels (an out-of-range id would be a
    silent out-of-bounds heap write, not an IndexError)."""
    if int(rows.min()) < 0 or int(rows.max()) >= n_playlists:
        raise ValueError(f"playlist_rows out of range [0, {n_playlists})")
    if int(ids.min()) < 0 or int(ids.max()) >= n_tracks:
        raise ValueError(f"track_ids out of range [0, {n_tracks})")


def _effective_threads() -> int:
    """Threads the bitset kernel will actually use (the sparse kernel is
    single-threaded — its scatter targets collide across playlists)."""
    env = int(os.environ.get("KMLS_NATIVE_THREADS", "0"))
    if env > 0:
        return env
    try:
        return min(len(os.sched_getaffinity(0)), 16)
    except AttributeError:  # non-linux
        return min(os.cpu_count() or 4, 16)


def choose_method(
    playlist_rows: np.ndarray, *, n_playlists: int, n_tracks: int
) -> str:
    """Cost-model dispatch between the two exact counters.

    bitset cost ≈ V²/2 · ceil(P/64) sequential popcnt word-ops, divided
    across its threads; sparse cost ≈ Σ_p C(k_p, 2) random scatter-adds
    (+ one counting-sort pass + the V²/2 mirror/memset), single-threaded.
    A scatter-add is weighted as 8 word-ops (random writes into the
    (V, V) matrix vs streamed AND+POPCNT — the reference's calibration),
    so compare word-op-equivalents. Dense-ish small inputs (ds2) pick
    bitset; huge sparse inputs avoid the V²·W scan entirely."""
    k = np.bincount(playlist_rows, minlength=n_playlists)
    pair_mass = float((k.astype(np.float64) * (k - 1)).sum() / 2.0)
    half_matrix = n_tracks * float(n_tracks) / 2.0
    sparse_cost = 8.0 * pair_mass + 2.0 * len(playlist_rows) + half_matrix
    bitset_cost = (
        half_matrix * ((n_playlists + 63) // 64) / _effective_threads()
    )
    return "sparse" if sparse_cost < bitset_cost else "bitset"


def pair_counts(
    playlist_rows: np.ndarray,
    track_ids: np.ndarray,
    *,
    n_playlists: int,
    n_tracks: int,
    n_threads: int | None = None,
    method: str = "auto",
) -> np.ndarray:
    """Exact ``XᵀX`` pair-count matrix (V, V) int32 via the native kernels.

    ``method``: "auto" (cost model, default), "bitset", or "sparse" —
    identical results, different asymptotics (see :func:`choose_method`).
    Env override ``KMLS_NATIVE_PAIR_METHOD`` beats "auto". PRECONDITION:
    (playlist, track) pairs deduplicated — the Baskets contract — or the
    sparse path double-counts where the bitset path ORs idempotently.

    Raises RuntimeError when the native library is unavailable — callers
    gate on :func:`available` and take the PyTorch route otherwise."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native popcount unavailable")
    if n_threads is None:
        n_threads = int(os.environ.get("KMLS_NATIVE_THREADS", "0"))
    if n_tracks == 0 or len(playlist_rows) == 0:
        return np.zeros((n_tracks, n_tracks), dtype=np.int32)
    rows = np.ascontiguousarray(playlist_rows, dtype=np.int64)
    ids = np.ascontiguousarray(track_ids, dtype=np.int32)
    _validate(rows, ids, n_playlists, n_tracks)
    if method == "auto":
        method = os.environ.get("KMLS_NATIVE_PAIR_METHOD", "auto")
    if method == "auto":
        method = choose_method(
            rows, n_playlists=n_playlists, n_tracks=n_tracks
        )
    if method not in ("bitset", "sparse"):
        raise ValueError(f"method must be auto|bitset|sparse, got {method!r}")
    CALLS[method] += 1
    if method == "sparse":
        out = np.zeros((n_tracks, n_tracks), dtype=np.int32)  # C side adds
        lib.kmls_pair_counts_sparse(
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(len(rows)),
            ctypes.c_int64(n_playlists),
            ctypes.c_int32(n_tracks),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out
    out = np.empty((n_tracks, n_tracks), dtype=np.int32)  # C side fully writes
    bt = _bitpack_unchecked(
        rows, ids, n_playlists=n_playlists, n_tracks=n_tracks
    )
    lib.kmls_pair_counts(
        bt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int32(n_tracks),
        ctypes.c_int64(bt.shape[1]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(n_threads),
    )
    return out
