"""Sparsity-adaptive pair-support counting — counterpart of
``kmlserver_tpu/ops/sparse.py``, the third count family.

``C = XᵀX`` decomposes per basket, ``C = Σ_b e_b e_bᵀ``: a basket of length
k contributes its k(k-1)/2 unordered track pairs (mirrored at the end) plus
its k diagonal singles (one bincount over the track ids). The pair events
are expanded straight from the sorted membership rows on the host and
accumulated with integer adds, in any order, so the counts equal the dense
and bit-packed routes' exactly. Only the nnz membership pairs and the
``(V, V)`` counts ever exist; the ``(P, V)`` operand never does.

**The long-basket guard.** Pair expansion is quadratic per basket, so
baskets longer than ``long_basket_threshold`` are split out, their rows
gathered into a COMPACT sub-problem (only the occupied playlists exist in
it) and counted densely there (:func:`_count_long_dense`). On a CUDA device
that block is bit-packed and counted by the tensor-core popcount kernel
(``ops/popcount.py``) — the "bitpacked half of the hybrid"; the reference's
native CPU library plays that part on its host. On the CPU it is the
reference's exact float64 contraction.

The host functions (:func:`sparse_pair_counts_np`, :func:`sparse_rule_rows`)
are copies of the reference's; :func:`sparse_pair_counts_device` scatter-adds
the same event stream into the counts on the device.
:func:`sparse_restricted_pair_counts_np` is the reference's host route of
the delta recount: only the rows of the requested antecedents.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# Baskets longer than this leave the CSR pair expansion for the gathered
# dense/bitpacked sub-count. Env-tunable via KMLS_SPARSE_LONG_BASKET (read
# per call, not at import).
LONG_BASKET_DEFAULT = 256

# Pair events expanded per accumulation chunk (host route): bounds the
# transient expansion arrays and amortizes the per-chunk O(V²) bincount.
EVENT_CHUNK = 16_000_000


def resolve_long_basket(threshold: int | None = None) -> int:
    """``KMLS_SPARSE_LONG_BASKET`` (lazy read) with the module default."""
    if threshold is not None:
        return max(int(threshold), 2)
    raw = os.environ.get("KMLS_SPARSE_LONG_BASKET")
    return max(int(raw), 2) if raw not in (None, "") else LONG_BASKET_DEFAULT


def _sorted_by_playlist(
    playlist_rows: np.ndarray, track_ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Membership rows grouped by playlist (stable). ``build_baskets``
    already emits sorted rows — the monotonicity probe keeps that a no-op."""
    rows = np.asarray(playlist_rows)
    tids = np.asarray(track_ids)
    if rows.size and np.any(np.diff(rows) < 0):
        order = np.argsort(rows, kind="stable")
        rows, tids = rows[order], tids[order]
    return rows, tids


def basket_lengths(playlist_rows: np.ndarray, n_playlists: int) -> np.ndarray:
    """Per-playlist membership counts (int64, O(nnz) host bincount)."""
    return np.bincount(
        np.asarray(playlist_rows, dtype=np.int64), minlength=n_playlists
    )


def pair_event_count(
    playlist_rows: np.ndarray,
    n_playlists: int,
    long_basket_threshold: int | None = None,
) -> tuple[int, int]:
    """``(pair_events, long_rows)`` the hybrid would process: the exact
    Σ k(k-1)/2 over short baskets, and the membership rows the long-basket
    sub-count gathers. The dispatcher's plan-time measurement, O(nnz)."""
    thr = resolve_long_basket(long_basket_threshold)
    lengths = basket_lengths(playlist_rows, n_playlists)
    short = lengths[lengths <= thr].astype(np.int64)
    long_rows = int(lengths[lengths > thr].sum())
    return int(np.sum(short * (short - 1) // 2)), long_rows


def _segments(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(starts, counts)`` of the contiguous playlist segments in the
    sorted membership rows."""
    _, starts, counts = np.unique(rows, return_index=True, return_counts=True)
    return starts.astype(np.int64), counts.astype(np.int64)


def _split_long(
    rows: np.ndarray, tids: np.ndarray, starts: np.ndarray,
    counts: np.ndarray, thr: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """→ ``(short_rows, short_tids, starts, counts, long_rows, long_tids)``
    with the segment structure recomputed for the short remainder."""
    long_seg = counts > thr
    if not np.any(long_seg):
        return rows, tids, starts, counts, rows[:0], tids[:0]
    sel = np.zeros(len(rows), dtype=bool)
    for s, c in zip(starts[long_seg], counts[long_seg]):
        sel[s : s + c] = True
    keep = ~sel
    short_rows, short_tids = rows[keep], tids[keep]
    if short_rows.size:
        starts, counts = _segments(short_rows)
    else:
        starts = counts = np.zeros(0, dtype=np.int64)
    return short_rows, short_tids, starts, counts, rows[sel], tids[sel]


def _iter_pair_keys(
    tids: np.ndarray,
    starts: np.ndarray,
    counts: np.ndarray,
    n_tracks: int,
    event_chunk: int,
    both_directions: bool = False,
):
    """Yield flat ``i·V + j`` keys for every unordered intra-basket pair,
    one POSITION-triangle event per pair (ids may come out either order;
    the caller mirrors, or asks for ``both_directions``). Division-free
    vectorized expansion in bounded chunks."""
    nnz = len(tids)
    if nnz == 0:
        return
    key_dtype = (
        np.int32
        if n_tracks * n_tracks < np.iinfo(np.int32).max
        else np.int64
    )
    seg_of = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    pos = np.arange(nnz, dtype=np.int64)
    # pairs each element opens: the elements AFTER it in its own basket
    rep_all = starts[seg_of] + counts[seg_of] - 1 - pos
    cum = np.cumsum(rep_all)
    lo = 0
    while lo < nnz:
        target = (cum[lo - 1] if lo else 0) + event_chunk
        hi = int(np.searchsorted(cum, target, side="left")) + 1
        hi = min(max(hi, lo + 1), nnz)
        rep = rep_all[lo:hi]
        n_events = int(rep.sum())
        if n_events:
            off = np.concatenate([[0], np.cumsum(rep[:-1])])
            within = np.arange(n_events, dtype=np.int64) - np.repeat(off, rep)
            left = np.repeat(tids[lo:hi], rep).astype(key_dtype)
            right = tids[np.repeat(pos[lo:hi] + 1, rep) + within].astype(
                key_dtype
            )
            v = key_dtype(n_tracks)
            if both_directions:
                yield np.concatenate([left * v + right, right * v + left])
            else:
                yield left * v + right
        lo = hi


def _count_long_dense(
    rows: np.ndarray,
    tids: np.ndarray,
    n_tracks: int,
    device: str | torch.device = "cpu",
) -> torch.Tensor:
    """The dense half over the GATHERED long baskets → int32 ``(V, V)`` on
    ``device``: only the occupied playlists exist in the sub-problem. On a
    CUDA device the block is bit-packed and counted by the tensor-core
    popcount kernel; on the CPU by an exact float64 contraction (counts
    ≤ P ≪ 2^53, so the cast back to int32 is lossless)."""
    from . import popcount as pc

    dev = torch.device(device)
    _, compact = np.unique(rows, return_inverse=True)
    p_long = int(compact.max()) + 1 if compact.size else 0
    if p_long == 0:
        return torch.zeros((n_tracks, n_tracks), dtype=torch.int32, device=dev)
    if dev.type == "cuda":
        v_pad, w_pad = pc.padded_shape(n_tracks, p_long)
        bt = pc.bitpack_by_track(
            compact.astype(np.int32), tids.astype(np.int32),
            n_playlists=p_long, n_tracks=n_tracks,
            v_pad=v_pad, w_pad=w_pad, device=dev,
        )
        counts = pc.popcount_pair_counts_padded(bt)
        return counts[:n_tracks, :n_tracks].contiguous()
    x = np.zeros((p_long, n_tracks), dtype=np.float64)
    x[compact, tids] = 1.0
    return torch.from_numpy((x.T @ x).astype(np.int32))


def sparse_pair_counts_np(
    playlist_rows: np.ndarray,
    track_ids: np.ndarray,
    *,
    n_playlists: int,
    n_tracks: int,
    long_basket_threshold: int | None = None,
    event_chunk: int = EVENT_CHUNK,
) -> np.ndarray:
    """Pair counts ``(V, V) int32`` from membership pairs on the host,
    touching only the nnz that exist. Pairs must be DEDUPLICATED."""
    thr = resolve_long_basket(long_basket_threshold)
    rows, tids = _sorted_by_playlist(playlist_rows, track_ids)
    out = np.zeros((n_tracks, n_tracks), dtype=np.int32)
    if rows.size == 0:
        return out
    starts, counts = _segments(rows)
    rows, tids, starts, counts, lrows, ltids = _split_long(
        rows, tids, starts, counts, thr
    )
    if lrows.size:
        out += _count_long_dense(lrows, ltids, n_tracks).numpy()
    # short-basket diagonal = item supports; the long block above carries
    # its own diagonal (it is a complete sub-count)
    if tids.size:
        out[np.diag_indices(n_tracks)] += np.bincount(
            tids.astype(np.int64), minlength=n_tracks
        ).astype(np.int32, copy=False)
    e_total = int(np.sum(counts * (counts - 1) // 2))
    v2 = n_tracks * n_tracks
    # accumulator: a bincount sweeps O(V²) per chunk, the right trade only
    # while event volume dominates the matrix; past that, sort-unique
    if v2 <= min(4 * max(e_total, 1), 1 << 28):
        upper = np.zeros(v2, dtype=np.int32)
        for keys in _iter_pair_keys(
            tids, starts, counts, n_tracks, event_chunk
        ):
            upper += np.bincount(keys, minlength=v2).astype(
                np.int32, copy=False
            )
        u = upper.reshape(n_tracks, n_tracks)
        out += u
        out += u.T
    else:
        flat = out.reshape(-1)
        for keys in _iter_pair_keys(
            tids, starts, counts, n_tracks, event_chunk,
            both_directions=True,
        ):
            uniq, cnt = np.unique(keys, return_counts=True)
            flat[uniq] += cnt.astype(np.int32, copy=False)
    return out


def sparse_rule_rows(
    playlist_rows: np.ndarray,
    track_ids: np.ndarray,
    *,
    n_playlists: int,
    n_tracks: int,
    min_count: int,
    k_max: int,
    long_basket_threshold: int | None = None,
    event_chunk: int = EVENT_CHUNK,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None:
    """FULLY sparse count→emit on the host: membership pairs straight to
    ``(rule_ids, rule_counts, row_valid, item_counts)`` without the
    ``(V, V)`` matrix. Per-row order (count desc, column asc) — the
    emission's tie order — via one lexsort over the threshold survivors.
    Returns None when long baskets exist under the threshold: the caller
    then counts the matrix and emits from it."""
    rows, tids = _sorted_by_playlist(playlist_rows, track_ids)
    rule_ids = np.full((n_tracks, k_max), -1, dtype=np.int32)
    rule_counts = np.zeros((n_tracks, k_max), dtype=np.int32)
    if rows.size == 0:
        return (
            rule_ids, rule_counts,
            np.zeros(n_tracks, dtype=np.int32),
            np.zeros(n_tracks, dtype=np.int32),
        )
    starts, counts = _segments(rows)
    thr = resolve_long_basket(long_basket_threshold)
    if np.any(counts > thr):
        return None
    item_counts = np.bincount(
        tids.astype(np.int64), minlength=n_tracks
    ).astype(np.int32)
    keys = [
        k for k in _iter_pair_keys(
            tids, starts, counts, n_tracks, event_chunk,
            both_directions=True,
        )
    ]
    if not keys:
        return (
            rule_ids, rule_counts,
            np.zeros(n_tracks, dtype=np.int32), item_counts,
        )
    uq, ct = np.unique(np.concatenate(keys), return_counts=True)
    del keys
    keep = ct >= min_count
    uq, ct = uq[keep], ct[keep].astype(np.int64)
    v = np.int64(n_tracks)
    r_surv = (uq.astype(np.int64) // v).astype(np.int32)
    c_surv = (uq.astype(np.int64) - r_surv.astype(np.int64) * v).astype(
        np.int32
    )
    row_valid = np.bincount(
        r_surv.astype(np.int64), minlength=n_tracks
    ).astype(np.int32)
    # (row asc, count desc, col asc) — survivors only
    order = np.lexsort((c_surv, -ct, r_surv))
    r_o = r_surv[order]
    rank = np.arange(len(r_o), dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(row_valid.astype(np.int64))[:-1]]),
        row_valid,
    )
    sel = rank < k_max
    rule_ids[r_o[sel], rank[sel]] = c_surv[order][sel]
    rule_counts[r_o[sel], rank[sel]] = ct[order][sel].astype(np.int32)
    return rule_ids, rule_counts, row_valid, item_counts


def sparse_pair_counts_device(
    playlist_rows: np.ndarray,
    track_ids: np.ndarray,
    *,
    n_playlists: int,
    n_tracks: int,
    long_basket_threshold: int | None = None,
    event_chunk: int = 1 << 20,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The same event stream scatter-added on ``device`` → ``(V, V)`` int32
    tensor there. Events are generated on the host in chunks (they ARE the
    compressed representation), uploaded, and accumulated with an integer
    ``index_add_`` into the flat upper counts — exact in any order, so the
    result equals :func:`sparse_pair_counts_np`. The diagonal and the
    long-basket block (the popcount kernel on a CUDA device) are more terms
    of the same integer sum."""
    dev = torch.device(device)
    thr = resolve_long_basket(long_basket_threshold)
    rows, tids = _sorted_by_playlist(playlist_rows, track_ids)
    if rows.size == 0:
        return torch.zeros((n_tracks, n_tracks), dtype=torch.int32, device=dev)
    starts, counts = _segments(rows)
    rows, tids, starts, counts, lrows, ltids = _split_long(
        rows, tids, starts, counts, thr
    )
    if lrows.size:
        out = _count_long_dense(lrows, ltids, n_tracks, dev)
    else:
        out = torch.zeros((n_tracks, n_tracks), dtype=torch.int32, device=dev)
    if tids.size:
        out.diagonal().add_(
            torch.bincount(
                torch.as_tensor(tids, device=dev).long(), minlength=n_tracks
            ).to(torch.int32)
        )
    upper = torch.zeros(n_tracks * n_tracks, dtype=torch.int32, device=dev)
    for keys in _iter_pair_keys(tids, starts, counts, n_tracks, event_chunk):
        idx = torch.as_tensor(keys, device=dev).long()
        upper.index_add_(0, idx, torch.ones(len(idx), dtype=torch.int32, device=dev))
    u = upper.view(n_tracks, n_tracks)
    out += u
    out += u.t()
    return out


def sparse_restricted_pair_counts_np(
    playlist_rows: np.ndarray,
    track_ids: np.ndarray,
    row_ids: np.ndarray,
    *,
    n_playlists: int,
    n_tracks: int,
    event_chunk: int = EVENT_CHUNK,
) -> np.ndarray:
    """Rows ``row_ids`` of ``C = XᵀX`` → ``(R, V) int32`` — the sparse
    route of the delta recount (``parallel.support.restricted_pair_counts``):
    only baskets holding a requested antecedent generate events, ``hits_b ·
    k_b`` each, instead of the dense route's full ``P × R`` contraction.
    Integer accumulation, so the rows equal the full count's."""
    row_ids = np.asarray(row_ids, dtype=np.int64)
    r = len(row_ids)
    out = np.zeros((r, n_tracks), dtype=np.int32)
    if r == 0:
        return out
    rank = np.full(n_tracks, -1, dtype=np.int64)
    rank[row_ids] = np.arange(r, dtype=np.int64)
    rows, tids = _sorted_by_playlist(playlist_rows, track_ids)
    if rows.size == 0:
        return out
    starts, counts = _segments(rows)
    # per-element basket handle: which segment each membership row lives in
    seg_of = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    hits = np.flatnonzero(rank[tids] >= 0)  # membership rows that are antecedents
    if hits.size == 0:
        return out
    v = np.int64(n_tracks)
    rep_all = counts[seg_of[hits]]
    cum = np.cumsum(rep_all)
    lo = 0
    n_hits = len(hits)
    while lo < n_hits:
        target = (cum[lo - 1] if lo else 0) + event_chunk
        hi = int(np.searchsorted(cum, target, side="left")) + 1
        hi = min(max(hi, lo + 1), n_hits)
        h = hits[lo:hi]
        rep = rep_all[lo:hi]
        n_events = int(rep.sum())
        off = np.concatenate([[0], np.cumsum(rep[:-1])])
        within = np.arange(n_events, dtype=np.int64) - np.repeat(off, rep)
        left = np.repeat(rank[tids[h]], rep)
        right = tids[np.repeat(starts[seg_of[h]], rep) + within]
        out += np.bincount(
            left * v + right, minlength=r * n_tracks
        ).reshape(r, n_tracks).astype(np.int32, copy=False)
        lo = hi
    return out
