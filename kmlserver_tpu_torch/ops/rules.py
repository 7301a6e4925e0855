"""Rule-tensor emission — counterpart of ``kmlserver_tpu/ops/rules.py``.

The output layout is the reference's padded dense arrays:

    rule_ids    int32 (V, K_max) — consequent track ids, -1 padding
    rule_counts int32 (V, K_max) — co-occurrence counts (pair support × P)
    item_counts int32 (V,)       — singleton supports (the matrix diagonal)

Row *i* holds {j ≠ i : pair_count[i, j] ≥ min_count}, ranked by count with
equal counts in ascending column order — the order ``jax.lax.top_k`` gives
and the published artifacts depend on. ``torch.topk`` promises no order
among equal values, so the device emission ranks a unique composite key
``score·V + (V-1-j)`` instead. Confidences are never computed on the
device: counts travel to the host, where float64 ``count / P`` (then
float32 for serving) reproduces the reference bit for bit.

Beside the emission: :func:`fused_dense_rule_tensors` (one-hot → int8
product → emission on the device, the ``dense-fused`` route) and the
multi-antecedent confidence merge of confidence mode with
``max_itemset_len ≥ 3`` (:func:`antecedent_contributions`,
:func:`merge_confidence_contributions`, host numpy copies of the
reference's).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.profiling import span
from . import encode, support
from .support import min_count_for


def emit_rule_tensors(
    pair_count_matrix: torch.Tensor, min_count: int, *, k_max: int, row_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Threshold + per-row top-k over the pair-count matrix, on its device.

    ``pair_count_matrix`` is the whole ``(V, V)`` matrix, or a slab of its
    rows starting at row ``row_offset`` (the vocab-sharded emission,
    ``parallel/support.py``): each row's diagonal is masked at its global
    index. Returns ``(rule_ids, rule_counts, row_valid_counts)`` where
    ``row_valid_counts[i]`` is the TRUE number of frequent consequents of
    row i (may exceed ``k_max``; the caller detects truncation overflow)."""
    n_rows, v = pair_count_matrix.shape
    dev = pair_count_matrix.device
    counts = pair_count_matrix.to(torch.int64)
    valid = counts >= min_count
    rows = torch.arange(n_rows, device=dev)
    valid[rows, rows + row_offset] = False
    row_valid_counts = valid.sum(dim=1, dtype=torch.int32)
    score = torch.where(valid, counts, torch.full_like(counts, -1))
    k = min(k_max, v)
    # unique key: higher count first, then the LOWER column (lax.top_k order)
    key = score * v + (v - 1 - torch.arange(v, device=dev, dtype=torch.int64))
    top_key = torch.topk(key, k, dim=1, sorted=True).values
    top_ids = (v - 1) - torch.remainder(top_key, v)
    top_counts = torch.gather(score, 1, top_ids)
    keep = top_counts > 0
    rule_ids = torch.where(keep, top_ids, torch.full_like(top_ids, -1))
    rule_counts = torch.where(keep, top_counts, torch.zeros_like(top_counts))
    if k < k_max:  # pad up to the declared row capacity
        rule_ids = torch.nn.functional.pad(rule_ids, (0, k_max - k), value=-1)
        rule_counts = torch.nn.functional.pad(rule_counts, (0, k_max - k))
    return rule_ids.to(torch.int32), rule_counts.to(torch.int32), row_valid_counts


def derive_confs(
    rule_counts: np.ndarray,
    item_counts: np.ndarray,
    n_playlists: int,
    mode: str,
) -> np.ndarray:
    """THE count→confidence arithmetic (float64 division, then float32 for
    the serving tensors)."""
    if mode == "support":
        return (rule_counts.astype(np.float64) / n_playlists).astype(np.float32)
    denom = np.maximum(item_counts, 1)[:, None].astype(np.float64)
    return (rule_counts / denom).astype(np.float32)


def expand_rules_dict(
    vocab_names: list[str],
    rule_ids: np.ndarray,
    rule_counts: np.ndarray,
    item_counts: np.ndarray,
    *,
    n_playlists: int,
    min_support: float,
    mode: str = "support",
    rule_confs64: np.ndarray | None = None,
) -> dict[str, dict[str, float]]:
    """Tensor → the reference pickle's dict: every frequent item is a key
    (empty dict when it has no partners); confidences are float64
    ``count / P`` (support mode) or ``count / item_count`` (confidence
    mode), or the stored ``rule_confs64`` verbatim when given."""
    min_count = min_count_for(min_support, n_playlists)
    freq_rows = np.flatnonzero(item_counts >= min_count)
    if rule_confs64 is not None:
        conf_rows = rule_confs64[freq_rows]
    elif mode == "support":
        conf_rows = rule_counts[freq_rows] / float(n_playlists)
    else:
        conf_rows = rule_counts[freq_rows] / np.maximum(
            item_counts[freq_rows], 1
        )[:, None].astype(np.float64)
    ids_rows = rule_ids[freq_rows]
    valid_rows = ids_rows >= 0
    names_arr = np.asarray(vocab_names, dtype=object)
    rk, ck = np.nonzero(valid_rows)
    flat_names = names_arr[ids_rows[rk, ck]].tolist()
    flat_confs = conf_rows[rk, ck].tolist()
    bounds = np.concatenate([[0], np.cumsum(valid_rows.sum(axis=1))]).tolist()
    key_names = names_arr[freq_rows].tolist()
    out: dict[str, dict[str, float]] = {}
    for k in range(len(freq_rows)):
        lo, hi = bounds[k], bounds[k + 1]
        out[key_names[k]] = dict(zip(flat_names[lo:hi], flat_confs[lo:hi]))
    return out


@dataclasses.dataclass
class RuleTensors:
    """Host-side mined result + provenance (the reference's fields)."""

    rule_ids: np.ndarray  # int32 (V, K_max)
    rule_counts: np.ndarray  # int32 (V, K_max)
    rule_confs: np.ndarray  # float32 (V, K_max), serving-ready
    item_counts: np.ndarray  # int32 (V,)
    n_playlists: int
    min_support: float
    min_count: int
    mode: str  # "support" | "confidence"
    min_confidence: float
    n_frequent_items: int  # == len(keys) of the expanded dict
    n_songs_missing: int  # total_songs - len(keys)
    overflow_rows: int  # rows whose true consequent set exceeded K_max
    row_valid_counts: np.ndarray | None = None  # int32 (V,)
    # set when confidences can NOT be re-derived from counts alone — the
    # multi-antecedent merge (per-rule denominators); float64 so dict
    # expansion keeps full precision
    rule_confs64: np.ndarray | None = None

    @property
    def frequent_item_mask(self) -> np.ndarray:
        return self.item_counts >= self.min_count

    def to_rules_dict(self, vocab_names: list[str]) -> dict[str, dict[str, float]]:
        return expand_rules_dict(
            vocab_names,
            self.rule_ids,
            self.rule_counts,
            self.item_counts,
            n_playlists=self.n_playlists,
            min_support=self.min_support,
            mode=self.mode,
            rule_confs64=self.rule_confs64,
        )


def antecedent_contributions(
    members: tuple[np.ndarray, ...],  # each int (E,), -1 padded
    ant_counts: np.ndarray,  # int (E,) support of the antecedent itemset
    ext_counts: np.ndarray,  # int (E, V) support of antecedent ∪ {col}
    *,
    min_count: int,
    min_confidence: float,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Directed rule contributions from one antecedent size, vectorized
    (a copy of the reference's, host numpy).

    For each row e — an antecedent itemset A = {members[0][e], …} — and each
    column c with ``ext_counts[e, c] ≥ min_count``, the rule A→c holds at
    conf = ext/ant. The reference slow path assigns that confidence from
    EVERY member of A to c (machine-learning/main.py:247-255), so each hit
    yields ``len(members)`` directed (row, col, conf) entries. Columns that
    are themselves members hold the antecedent's own support, not a proper
    extension, and are masked out. → (rows, cols, vals).
    """
    e_valid = np.flatnonzero((members[0] >= 0) & (ant_counts > 0))
    ext = ext_counts[e_valid]  # (E', V)
    ms = [m[e_valid].astype(np.int64) for m in members]
    ac = ant_counts[e_valid].astype(np.int64)
    mask = ext >= min_count
    if e_valid.size:
        e_rows = np.arange(e_valid.size)
        for m in ms:
            mask[e_rows, m] = False
    conf = ext.astype(np.int64) / ac[:, None].astype(np.float64)
    mask &= conf >= min_confidence
    e_hit, k_hit = np.nonzero(mask)
    vals_hit = conf[e_hit, k_hit]
    rows = np.concatenate([m[e_hit] for m in ms])
    cols = np.tile(k_hit.astype(np.int64), len(ms))
    vals = np.tile(vals_hit, len(ms))
    return rows, cols, vals


def merge_confidence_contributions(
    tensors: RuleTensors,
    contributions: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    *,
    k_max: int,
) -> RuleTensors:
    """Fold multi-antecedent rule contributions into the pairwise confidence
    tensors (a copy of the reference's, host numpy): conf({a,b}→c) =
    s3/s(ab) (and conf({a,b,c}→d) = s4/s(abc)) may exceed every pairwise
    confidence involving the consequent. Contributions max-merge with the
    pairwise rows, re-rank per row (confidence descending, ties by lower
    consequent id), truncate to ``k_max``. Counts cannot back the merged
    confidences, so ``rule_counts`` is zeroed and ``rule_confs64`` set."""
    v = tensors.rule_ids.shape[0]
    denom = np.maximum(tensors.item_counts, 1).astype(np.float64)

    # sparse (row, col, conf) entries from the pairwise emission
    rb, kb = np.nonzero(tensors.rule_ids >= 0)
    cols_b = tensors.rule_ids[rb, kb].astype(np.int64)
    vals_b = tensors.rule_counts[rb, kb].astype(np.int64) / denom[rb]

    rows = np.concatenate([rb.astype(np.int64)] + [c[0] for c in contributions])
    cols = np.concatenate([cols_b] + [c[1] for c in contributions])
    vals = np.concatenate([vals_b] + [c[2] for c in contributions])

    # max-dedup per (row, col): sort by (row, col, conf desc), keep first
    order = np.lexsort((-vals, cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    keep_first = np.ones(len(rows), dtype=bool)
    keep_first[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    rows, cols, vals = rows[keep_first], cols[keep_first], vals[keep_first]

    # per-row rank by conf desc (ties: lower col id — deterministic)
    order = np.lexsort((cols, -vals, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    row_start = np.ones(len(rows), dtype=bool)
    row_start[1:] = rows[1:] != rows[:-1]
    seg_id = np.cumsum(row_start) - 1
    rank = np.arange(len(rows)) - np.flatnonzero(row_start)[seg_id]
    # honest overflow: a row is truncated if the MERGED candidate set
    # exceeds k_max, or if emission already truncated it
    overflow_mask = np.zeros(v, dtype=bool)
    if len(rows):
        row_sizes = np.bincount(seg_id)
        overflow_mask[rows[row_start]] = row_sizes > k_max
    if tensors.row_valid_counts is not None:
        overflow_mask |= tensors.row_valid_counts > k_max
    overflow = int(overflow_mask.sum())
    keep = rank < k_max
    rows, cols, vals, rank = rows[keep], cols[keep], vals[keep], rank[keep]

    rule_ids = np.full((v, k_max), -1, dtype=np.int32)
    rule_confs64 = np.zeros((v, k_max), dtype=np.float64)
    rule_ids[rows, rank] = cols
    rule_confs64[rows, rank] = vals
    return dataclasses.replace(
        tensors,
        rule_ids=rule_ids,
        rule_counts=np.zeros((v, k_max), dtype=np.int32),
        rule_confs=rule_confs64.astype(np.float32),
        rule_confs64=rule_confs64,
        overflow_rows=overflow,
    )


def fused_dense_rule_tensors(
    playlist_rows: torch.Tensor,
    track_ids: torch.Tensor,
    min_count: int,
    *,
    n_playlists: int,
    n_tracks: int,
    k_max: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-hot encode → int8 pair product → threshold/top-k emission on the
    device of ``track_ids``: membership pairs in, finished rule tensors out
    (``rule_ids, rule_counts, row_valid, item_counts``), for one fetch.

    The fetch is compacted like the reference's: ids and row sizes are
    int16 whenever V ≤ 32767, counts whenever P ≤ 32767; the host upcasts
    back to the int32 ``RuleTensors`` contract."""
    x = encode.onehot_matrix(
        playlist_rows, track_ids, n_playlists=n_playlists, n_tracks=n_tracks
    )
    counts = support.pair_counts(x)
    del x
    rule_ids, rule_counts, row_valid = emit_rule_tensors(
        counts, min_count, k_max=k_max
    )
    id_dt = torch.int16 if n_tracks <= 32767 else torch.int32
    ct_dt = torch.int16 if n_playlists <= 32767 else torch.int32
    return (
        rule_ids.to(id_dt),
        rule_counts.to(ct_dt),
        row_valid.to(id_dt),
        torch.diagonal(counts).to(ct_dt),
    )


def emit_rule_tensors_np(
    pair_count_matrix: np.ndarray, min_count: int, *, k_max: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy twin of :func:`emit_rule_tensors` (a copy of the reference's
    ``emit_rule_tensors_np``): equal counts rank by ascending column via the
    composite key ``score·V + (V-1-j)``, so partition/sort order is unique."""
    v = pair_count_matrix.shape[0]
    masked = pair_count_matrix.copy()
    np.fill_diagonal(masked, 0)
    max_count = int(masked.max(initial=0))
    del masked
    key_dtype = (
        np.int32 if (max_count + 1) * v < np.iinfo(np.int32).max else np.int64
    )
    counts = pair_count_matrix.astype(key_dtype, copy=False)
    valid = counts >= min_count
    np.fill_diagonal(valid, False)
    row_valid_counts = valid.sum(axis=1, dtype=np.int32)
    score = np.where(valid, counts, key_dtype(-1))
    key = score * key_dtype(v) + (v - 1 - np.arange(v, dtype=key_dtype)[None, :])
    k = min(k_max, v)
    if k < v:
        part = np.argpartition(-key, k - 1, axis=1)[:, :k]
    else:
        part = np.broadcast_to(np.arange(v)[None, :], (v, v)).copy()
    part_key = np.take_along_axis(key, part, axis=1)
    order = np.argsort(-part_key, axis=1)
    top_ids = np.take_along_axis(part, order, axis=1)
    top_counts = np.take_along_axis(score, top_ids, axis=1)
    keep = top_counts > 0
    rule_ids = np.where(keep, top_ids, -1).astype(np.int32)
    rule_counts = np.where(keep, top_counts, 0).astype(np.int32)
    if k < k_max:  # pad up to the declared row capacity
        pad = ((0, 0), (0, k_max - k))
        rule_ids = np.pad(rule_ids, pad, constant_values=-1)
        rule_counts = np.pad(rule_counts, pad)
    return rule_ids, rule_counts, row_valid_counts


def mine_rules_from_counts_np(
    pair_count_matrix: np.ndarray,
    *,
    n_playlists: int,
    min_support: float,
    k_max: int,
    mode: str = "support",
    min_confidence: float = 0.0,
    n_total_songs: int | None = None,
) -> RuleTensors:
    """Host-only emission from a host count matrix (the native-CPU route,
    and the sparse route's long-basket fallback on the CPU): the native
    C++ top-k (``ops/cpu_popcount.emit_topk``, a bounded per-row heap)
    where the library loads, else :func:`emit_rule_tensors_np`, its
    pinned-identical twin; then the shared assembly."""
    from . import cpu_popcount

    min_count = min_count_for(min_support, n_playlists)
    emitted = None
    if cpu_popcount.available():
        try:
            emitted = cpu_popcount.emit_topk(pair_count_matrix, min_count, k_max=k_max)
        except RuntimeError:  # turned off since the check
            emitted = None
    if emitted is None:
        emitted = emit_rule_tensors_np(pair_count_matrix, min_count, k_max=k_max)
    rule_ids, rule_counts, row_valid = emitted
    return assemble_rule_tensors(
        rule_ids, rule_counts, row_valid,
        np.diagonal(pair_count_matrix).astype(np.int32, copy=True),
        n_playlists=n_playlists, min_support=min_support, k_max=k_max,
        mode=mode, min_confidence=min_confidence,
        n_total_songs=n_total_songs,
        n_tracks=int(pair_count_matrix.shape[0]),
    )


def assemble_rule_tensors(
    rule_ids: np.ndarray,
    rule_counts: np.ndarray,
    row_valid: np.ndarray,
    item_counts: np.ndarray,
    *,
    n_playlists: int,
    min_support: float,
    k_max: int,
    mode: str = "support",
    min_confidence: float = 0.0,
    n_total_songs: int | None = None,
    n_tracks: int | None = None,
) -> RuleTensors:
    """Host-side assembly: confidence filtering/derivation in float64 +
    provenance/overflow stats."""
    if mode not in ("support", "confidence"):
        raise ValueError(
            f"confidence mode must be 'support' or 'confidence', got {mode!r}"
        )
    min_count = min_count_for(min_support, n_playlists)
    n_frequent = int((item_counts >= min_count).sum())
    if mode == "confidence":
        # within a row conf ordering == count ordering (fixed denominator),
        # so the filter removes a suffix of each ranked row
        conf64 = rule_counts / np.maximum(item_counts, 1)[:, None].astype(np.float64)
        keep = (rule_ids >= 0) & (conf64 >= min_confidence)
        rule_ids = np.where(keep, rule_ids, -1).astype(np.int32)
        rule_counts = np.where(keep, rule_counts, 0)
    confs = derive_confs(rule_counts, item_counts, n_playlists, mode)
    return RuleTensors(
        rule_ids=rule_ids,
        rule_counts=rule_counts,
        rule_confs=confs,
        item_counts=item_counts,
        n_playlists=n_playlists,
        min_support=min_support,
        min_count=min_count,
        mode=mode,
        min_confidence=min_confidence,
        n_frequent_items=n_frequent,
        n_songs_missing=(
            n_total_songs if n_total_songs is not None else int(n_tracks)
        ) - n_frequent,
        overflow_rows=int((row_valid > k_max).sum()),
        row_valid_counts=row_valid.astype(np.int32),
    )


def mine_rules_from_counts(
    pair_count_matrix: torch.Tensor,
    *,
    n_playlists: int,
    min_support: float,
    k_max: int,
    mode: str = "support",
    min_confidence: float = 0.0,
    n_total_songs: int | None = None,
) -> RuleTensors:
    """Emission from a materialized count matrix: threshold/top-k on its
    device, one fetch of four small arrays, host assembly + stats.

    ``n_total_songs``: the dataset's full unique-track count when the count
    matrix covers an Apriori-pruned vocabulary (keeps the missing-songs
    counter meaning total_songs - frequent keys).

    Under a running profiler the call is a ``kmls:emit`` span (the matrix's
    rows ``f``, ``k_max``) around ``emit.topk`` (the threshold and top-k
    launches), ``emit.fetch`` (the copy to the host, which waits for them)
    and ``emit.assemble`` (the host assembly)."""
    min_count = min_count_for(min_support, n_playlists)
    with span("emit", f=pair_count_matrix.shape[0], k_max=k_max):
        with span("emit.topk"):
            rule_ids, rule_counts, row_valid = emit_rule_tensors(
                pair_count_matrix, min_count, k_max=k_max
            )
            diag = torch.diagonal(pair_count_matrix)
        with span("emit.fetch"):
            rule_ids, rule_counts, row_valid, item_counts = (
                t.cpu().numpy() for t in (rule_ids, rule_counts, row_valid, diag)
            )
        with span("emit.assemble"):
            return assemble_rule_tensors(
                rule_ids, rule_counts, row_valid, item_counts.astype(np.int32),
                n_playlists=n_playlists, min_support=min_support, k_max=k_max,
                mode=mode, min_confidence=min_confidence,
                n_total_songs=n_total_songs,
                n_tracks=int(pair_count_matrix.shape[0]),
            )
