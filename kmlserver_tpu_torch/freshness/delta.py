"""Incremental delta mining — counterpart of
``kmlserver_tpu/freshness/delta.py``.

Without it every sync re-mines the whole dataset and swaps the whole
bundle. With ``KMLS_DELTA_ENABLED=1``:

- after a full publication, :func:`save_base_state` keeps the encode
  state (membership pairs, pid values, the full vocabulary), the published
  rule tensors and the dataset's byte-prefix fingerprint (host numpy only,
  like the checkpoint payloads);
- a later run calls :func:`run_delta_job`, which fingerprints the CSV
  against the base: an unchanged prefix plus appended rows is the delta
  case. Only the appended rows are parsed — by the port's full-path parser
  (``data/csv.py::parse_tracks``: verbatim strings, strict int64 pids), so
  they read exactly as a full read would — and support is recounted for
  the rows of the affected baskets' tracks only
  (``parallel/support.py::restricted_pair_counts``);
- the changed rule rows and tombstones publish as ``delta-<seq>.bundle``
  (``io/artifacts.py``), bound to the base generation by token and by the
  published npz's sha256, under the publication lease. The invalidation
  token is not rewritten: the engine applies the bundle in place
  (``serving/engine.py::apply_pending_deltas``).

**Bit-identity**: base ∘ chain == a full re-mine of the final CSV, tensors
and answers, because the recompute set is sufficient under append-only
input:

- a pair count C[i, j] changes only when a playlist whose basket holds i
  (or j) gained a membership, so every changed row is in the affected
  baskets' vocabulary (the touched set);
- appends only grow ``n_playlists``, so ``min_count`` never falls: rules
  can only leave untouched rows, and a rule that leaves is visible in the
  base tensors — rows with any count in ``[old_min_count, new_min_count)``
  join the recompute set (no truncated rule can re-enter: emission kept
  the top-k by count);
- row identity travels by name: the bundle carries the whole new (pruned)
  vocabulary, unchanged rows re-map into it by name, and a consequent that
  left the vocabulary can only sit in a crossing-band row, which is
  recomputed.

Anything outside that — a rewritten or truncated prefix, ``sample_ratio``
head-slicing, ``max_itemset_len >= 3``, more than one rank, a chain at its
cap, an appended row the full parser refuses — raises
:class:`DeltaIneligible`, and the pipeline re-mines in full: the delta
route never publishes an approximation.

Deltas patch the rule model only: the popularity ranking, the auxiliary
vocab artifacts and the ALS embeddings refresh with the next full mine.

Where the port differs: the reference parses the suffix with pandas' type
inference, which turns a track named ``007`` into ``7`` and accepts a pid
spelled ``5.0`` that its own full path refuses, so its chain can disagree
with its full re-mine; this reader cannot.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import time
from typing import Any

import numpy as np
import torch

from ..config import MiningConfig
from ..data.csv import parse_tracks
from ..io import artifacts
from ..mining.vocab import Baskets, Vocab
from ..ops.rules import derive_confs
from ..ops.support import min_count_for
from ..utils.device import backend_name, resolve_device

BASE_STATE_FILENAME = "freshness.base.pickle"
BASE_STATE_VERSION = 1

# MiningConfig fields that change delta-relevant output; a base state
# written under other values never seeds a delta (full re-mine). The
# reference's list: its fingerprint is over the same JSON
_DELTA_CONFIG_FIELDS = (
    "min_support",
    "sample_ratio",
    "max_itemset_len",
    "k_max_consequents",
    "confidence_mode",
    "min_confidence",
    "prune_vocab_threshold",
    "model_layout",
)


class DeltaIneligible(RuntimeError):
    """This run cannot be served by a delta — full re-mine instead."""


def base_state_path(pickles_dir: str) -> str:
    return os.path.join(pickles_dir, BASE_STATE_FILENAME)


def delta_config_fingerprint(cfg: MiningConfig) -> str:
    ident = {f: getattr(cfg, f) for f in _DELTA_CONFIG_FIELDS}
    blob = json.dumps(ident, sort_keys=True, default=str).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()


# ---------------------------------------------------------------------------
# base state
# ---------------------------------------------------------------------------


def save_base_state(
    cfg: MiningConfig,
    *,
    token: str,
    run_index: int,
    dataset_path: str,
    baskets: Baskets,
    pid_values: np.ndarray,
    published: dict[str, Any],
    npz_sha256: str | None,
    dataset_digest: tuple[int, str] | None = None,
) -> str:
    """Persist the delta seed after a publication (full or delta): the
    encode state the next run extends and the current logical rule tensors
    (base ∘ applied chain) its crossing-band scan reads. Writer only.

    ``dataset_digest``: ``(bytes, sha256)`` when the caller already
    streamed the dataset (the delta route's fingerprint pass), so the
    delta path never re-reads the whole file to hash it."""
    if dataset_digest is not None:
        ds_bytes, ds_sha = dataset_digest
    else:
        digest = artifacts.file_digest(dataset_path)
        ds_bytes, ds_sha = digest["bytes"], digest["sha256"]
    state = {
        "version": BASE_STATE_VERSION,
        "token": token,
        "run_index": run_index,
        "dataset": os.path.basename(dataset_path),
        "dataset_bytes": ds_bytes,
        "dataset_sha256": ds_sha,
        "config_fingerprint": delta_config_fingerprint(cfg),
        "playlist_rows": np.asarray(baskets.playlist_rows, dtype=np.int32),
        "track_ids": np.asarray(baskets.track_ids, dtype=np.int32),
        "n_playlists": int(baskets.n_playlists),
        "vocab_names": list(baskets.vocab.names),
        "pid_values": np.asarray(pid_values, dtype=np.int64),
        "published": published,
        "npz_sha256": npz_sha256,
    }
    path = base_state_path(cfg.pickles_dir)
    artifacts.save_pickle(state, path)
    return path


def load_base_state(pickles_dir: str) -> dict[str, Any] | None:
    try:
        state = artifacts.load_pickle(base_state_path(pickles_dir))
    except Exception:
        return None
    if not isinstance(state, dict) or state.get("version") != BASE_STATE_VERSION:
        return None
    return state


def published_from_tensors(tensors, vocab_names: list[str]) -> dict[str, Any]:
    """The ``published`` slice of the base state from mined rule tensors."""
    return {
        "vocab": list(vocab_names),
        "rule_ids": np.asarray(tensors.rule_ids, dtype=np.int32),
        "rule_counts": np.asarray(tensors.rule_counts, dtype=np.int32),
        "item_counts": np.asarray(tensors.item_counts, dtype=np.int32),
        "n_playlists": int(tensors.n_playlists),
        "min_support": float(tensors.min_support),
        "mode": str(tensors.mode),
        "min_confidence": float(tensors.min_confidence),
    }


# ---------------------------------------------------------------------------
# the one base ∘ delta application (mining, compaction and serving use it)
# ---------------------------------------------------------------------------


def apply_delta_to_tensors(prev: dict[str, Any], bundle: dict[str, Any]) -> dict[str, Any]:
    """Apply one delta bundle to the previous logical tensors → the new
    ones, in :func:`published_from_tensors` shape.

    Every new-vocabulary row is either overwritten from the bundle's
    changed set or copied from the base row of the same name with its
    consequent ids re-mapped old → new. A structural impossibility (a new
    name with no base row and no changed row, or an unchanged row whose
    consequent left the vocabulary) raises ``ValueError``: the caller
    rejects the bundle and keeps serving."""
    prev_vocab: list[str] = prev["vocab"]
    new_vocab: list[str] = bundle["vocab"]
    prev_index = {n: i for i, n in enumerate(prev_vocab)}
    k_prev = prev["rule_ids"].shape[1]
    if len(bundle["changed_rows"]) and bundle["changed_rule_ids"].shape[1] != k_prev:
        raise ValueError(
            f"delta row capacity {bundle['changed_rule_ids'].shape[1]} != "
            f"base row capacity {k_prev}"
        )
    v_new = len(new_vocab)
    # old id → new id (-1: the name left the vocabulary); the extra slot
    # maps the -1 padding
    remap = np.full(len(prev_vocab) + 1, -1, dtype=np.int32)
    new_index = {n: i for i, n in enumerate(new_vocab)}
    for old_i, name in enumerate(prev_vocab):
        remap[old_i] = new_index.get(name, -1)
    changed = np.zeros(v_new, dtype=bool)
    changed[bundle["changed_rows"]] = True
    src = np.full(v_new, -1, dtype=np.int64)
    for new_i, name in enumerate(new_vocab):
        if not changed[new_i]:
            j = prev_index.get(name)
            if j is None:
                raise ValueError(
                    f"new vocab row {name!r} has no base row and no changed "
                    "entry — corrupt delta"
                )
            src[new_i] = j
    rule_ids = np.full((v_new, k_prev), -1, dtype=np.int32)
    rule_counts = np.zeros((v_new, k_prev), dtype=np.int32)
    item_counts = np.zeros(v_new, dtype=np.int32)
    unchanged = ~changed
    if unchanged.any():
        rows = src[unchanged]
        old_ids = prev["rule_ids"][rows]
        mapped = np.where(old_ids >= 0, remap[old_ids], -1)
        if bool(((old_ids >= 0) & (mapped < 0)).any()):
            raise ValueError(
                "an unchanged row's consequent left the vocabulary — the "
                "crossing-band recompute should have covered it; corrupt delta"
            )
        rule_ids[unchanged] = mapped
        rule_counts[unchanged] = prev["rule_counts"][rows]
        item_counts[unchanged] = prev["item_counts"][rows]
    if len(bundle["changed_rows"]):
        rule_ids[bundle["changed_rows"]] = bundle["changed_rule_ids"]
        rule_counts[bundle["changed_rows"]] = bundle["changed_rule_counts"]
        item_counts[bundle["changed_rows"]] = bundle["changed_item_counts"]
    return {
        "vocab": list(new_vocab),
        "rule_ids": rule_ids,
        "rule_counts": rule_counts,
        "item_counts": item_counts,
        "n_playlists": int(bundle["n_playlists"]),
        "min_support": float(prev["min_support"]),
        "mode": str(prev["mode"]),
        "min_confidence": float(prev["min_confidence"]),
    }


def touched_names(bundle: dict[str, Any]) -> set[str]:
    """The seed names whose answers may have changed under ``bundle`` —
    the selective cache-invalidation set: changed rows and tombstones.
    Rows that only re-mapped their ids keep their name-level answers."""
    vocab = bundle["vocab"]
    out = {vocab[int(i)] for i in bundle["changed_rows"]}
    out.update(bundle["tombstones"])
    return out


# ---------------------------------------------------------------------------
# restricted emission (the dense emission's semantics, per selected row)
# ---------------------------------------------------------------------------


def emit_rule_rows_np(
    counts_rows: np.ndarray,
    row_ids: np.ndarray,
    min_count: int,
    k_max: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Emission for selected rows of the count matrix, with the full
    emission's per-row semantics (the diagonal masked at the row's global
    id, the threshold, top-k by count with ascending-column ties through
    the same composite integer key as ``ops/rules.py::emit_rule_tensors_np``)
    → ``(rule_ids, rule_counts, item_counts)`` of those rows."""
    r, v = counts_rows.shape
    if r == 0:
        return (
            np.full((0, k_max), -1, np.int32),
            np.zeros((0, k_max), np.int32),
            np.zeros(0, np.int32),
        )
    counts = counts_rows.astype(np.int64, copy=False)
    rows = np.arange(r)
    item_counts = counts[rows, row_ids].astype(np.int32)
    valid = counts >= min_count
    valid[rows, row_ids] = False
    score = np.where(valid, counts, np.int64(-1))
    key = score * np.int64(v) + (v - 1 - np.arange(v, dtype=np.int64))[None, :]
    k = min(k_max, v)
    if k < v:
        part = np.argpartition(-key, k - 1, axis=1)[:, :k]
    else:
        part = np.broadcast_to(np.arange(v)[None, :], (r, v)).copy()
    part_key = np.take_along_axis(key, part, axis=1)
    order = np.argsort(-part_key, axis=1)
    top_ids = np.take_along_axis(part, order, axis=1)
    top_counts = np.take_along_axis(score, top_ids, axis=1)
    keep = top_counts > 0
    rule_ids = np.where(keep, top_ids, -1).astype(np.int32)
    rule_counts = np.where(keep, top_counts, 0).astype(np.int32)
    if k < k_max:
        pad = ((0, 0), (0, k_max - k))
        rule_ids = np.pad(rule_ids, pad, constant_values=-1)
        rule_counts = np.pad(rule_counts, pad)
    return rule_ids, rule_counts, item_counts


def _confidence_filter_rows(
    rule_ids: np.ndarray,
    rule_counts: np.ndarray,
    item_counts: np.ndarray,
    min_confidence: float,
) -> tuple[np.ndarray, np.ndarray]:
    """The confidence-mode host filter of ``assemble_rule_tensors``, in
    float64 so no float32 rounding can flip a decision."""
    conf64 = rule_counts / np.maximum(item_counts, 1)[:, None].astype(np.float64)
    keep = (rule_ids >= 0) & (conf64 >= min_confidence)
    return (
        np.where(keep, rule_ids, -1).astype(np.int32),
        np.where(keep, rule_counts, 0).astype(np.int32),
    )


# ---------------------------------------------------------------------------
# the delta mining job
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeltaResult:
    """What one delta run produced (``bundle_path`` None = no new rows)."""

    seq: int
    bundle_path: str | None
    n_new_rows: int
    n_changed: int
    n_tombstones: int
    n_touched: int
    duration_s: float
    fencing_token: int | None
    base_token: str
    dataset: str = ""
    run_index: int = 0
    # the recounted shape (the combined baskets after the prune decision):
    # what the recount's cost attribution is computed over; 0/0 when
    # nothing was recounted
    n_playlists: int = 0
    n_tracks: int = 0
    # host wall seconds of the run's steps: fingerprint, suffix_parse,
    # combine, recount, emission, publish
    phase_timings: dict[str, float] = dataclasses.field(default_factory=dict)


def _read_suffix_table(path: str, offset: int, limit: int | None = None):
    """Parse only the appended rows — the header line plus the suffix
    bytes, through the full path's parser — → ``(pids, names)``.
    ``limit`` bounds the suffix to the bytes the caller fingerprinted, so a
    feed appending mid-run cannot desynchronize the saved digest from the
    rows encoded (the extra rows land in the next delta). A row the full
    parser refuses makes the run ineligible: the full re-mine decides."""
    with open(path, "rb") as fh:
        header = fh.readline()
        if offset < len(header):
            raise DeltaIneligible("appended region overlaps the CSV header")
        fh.seek(offset - 1)
        if fh.read(1) != b"\n":
            raise DeltaIneligible(
                "base prefix does not end at a line boundary — the appender "
                "continued a partial row"
            )
        suffix = fh.read() if limit is None else fh.read(limit)
    text = (header + suffix).decode("utf-8", errors="replace")
    try:
        table = parse_tracks(io.StringIO(text, newline=""), path)
    except ValueError as exc:
        raise DeltaIneligible(f"appended rows refused by the CSV parser: {exc}")
    return table.pid, np.asarray(table.track_name, dtype=object)


def _check_eligibility(cfg: MiningConfig, base: dict[str, Any] | None) -> None:
    from ..parallel.mesh import world_ranks

    if len(world_ranks()) > 1:
        raise DeltaIneligible("multi-host gang (delta mining is single-host)")
    if base is None:
        raise DeltaIneligible("no freshness base state on the PVC")
    if base.get("config_fingerprint") != delta_config_fingerprint(cfg):
        raise DeltaIneligible("mining config changed since the base run")
    if cfg.sample_ratio != 1.0:
        raise DeltaIneligible("sample_ratio head-slicing breaks append semantics")
    if cfg.max_itemset_len >= 3:
        raise DeltaIneligible("triple/quad extensions need the full one-hot matrix")


def _combined_baskets(
    base: dict[str, Any], new_pids: np.ndarray, new_names: np.ndarray
) -> tuple[Baskets, np.ndarray, np.ndarray]:
    """Extend the base membership with the appended rows → ``(combined
    baskets over the merged sorted vocabulary, merged pid values, affected
    playlist-row mask)``: what ``build_baskets`` over the whole file gives —
    sorted unique vocabulary, pid-rank playlist rows, deduplicated pairs."""
    base_names = base["vocab_names"]
    merged_names = sorted(set(base_names) | set(new_names.tolist()))
    vocab = Vocab(names=merged_names, index={n: i for i, n in enumerate(merged_names)})
    names_arr = np.asarray(merged_names, dtype=object)
    base_remap = np.searchsorted(names_arr, np.asarray(base_names, dtype=object)).astype(np.int64)
    merged_pids = np.union1d(base["pid_values"], np.unique(new_pids))
    base_row_remap = np.searchsorted(merged_pids, base["pid_values"])
    # one int64 key per (row, track) — row·V + track, monotone in the
    # lexicographic order — so the merge is a union1d, not a 2-D unique
    v_merged = np.int64(len(merged_names))
    old_keys = (
        base_row_remap[base["playlist_rows"].astype(np.int64)].astype(np.int64) * v_merged
        + base_remap[base["track_ids"].astype(np.int64)]
    )
    new_rows = np.searchsorted(merged_pids, new_pids)
    new_tids = vocab.encode(new_names).astype(np.int64)
    keys = np.union1d(old_keys, new_rows.astype(np.int64) * v_merged + new_tids)
    combined = Baskets(
        playlist_rows=(keys // v_merged).astype(np.int32),
        track_ids=(keys % v_merged).astype(np.int32),
        n_playlists=len(merged_pids),
        vocab=vocab,
    )
    affected = np.zeros(len(merged_pids), dtype=bool)
    affected[np.unique(new_rows)] = True
    return combined, merged_pids, affected


def _fingerprint(dataset_path: str, base_bytes: int) -> tuple[str, str, int]:
    """One streaming pass → ``(prefix sha256, whole-file sha256, suffix
    bytes)``: the prefix's digest decides append-only, and the same stream
    continued gives the digest the rolled-forward base state needs."""
    sha = hashlib.sha256()
    with open(dataset_path, "rb") as fh:
        remaining = base_bytes
        while remaining > 0:
            chunk = fh.read(min(1 << 20, remaining))
            if not chunk:
                break
            sha.update(chunk)
            remaining -= len(chunk)
        prefix_hex = sha.hexdigest()
        suffix_len = 0
        while chunk := fh.read(1 << 20):
            sha.update(chunk)
            suffix_len += len(chunk)
    return prefix_hex, sha.hexdigest(), suffix_len


def _recompute_rows(
    prev: dict[str, Any], combined: Baskets, mined: Baskets, affected: np.ndarray,
    old_min: int, new_min: int,
) -> tuple[np.ndarray, list[str], int]:
    """→ ``(row ids to recount in the mined vocabulary, tombstones,
    recompute-set size)``: every track of an affected basket, every base
    row with a count in the crossing band, and every name new to the
    published row space."""
    pruned_index = mined.vocab.index
    touched_full = np.unique(combined.track_ids[affected[combined.playlist_rows]])
    recompute = {combined.vocab.names[int(i)] for i in touched_full}
    if new_min > old_min:
        counts_band = ((prev["rule_counts"] >= old_min) & (prev["rule_counts"] < new_min)).any(axis=1)
        items_band = (prev["item_counts"] >= old_min) & (prev["item_counts"] < new_min)
        for i in np.flatnonzero(counts_band | items_band):
            recompute.add(prev["vocab"][int(i)])
    prev_set = set(prev["vocab"])
    recompute.update(n for n in mined.vocab.names if n not in prev_set)
    r_ids = np.asarray(
        sorted(pruned_index[n] for n in recompute if n in pruned_index), dtype=np.int32
    )
    tombstones = [n for n in prev["vocab"] if n not in pruned_index]
    # every surviving unchanged row must exist in the base
    changed_mark = np.zeros(mined.n_tracks, dtype=bool)
    changed_mark[r_ids] = True
    for i, name in enumerate(mined.vocab.names):
        if not changed_mark[i] and name not in prev_set:
            raise DeltaIneligible(f"row {name!r} is new but outside the recompute set")
    return r_ids, tombstones, len(recompute)


def _shrink(
    prev: dict[str, Any], names: list[str], r_ids: np.ndarray,
    rule_ids: np.ndarray, rule_counts: np.ndarray, item_counts: np.ndarray,
) -> np.ndarray:
    """→ the mask of recomputed rows that differ from their re-mapped base
    row: a row equal to it changed no answer, so neither the bundle nor
    the cache invalidation names it."""
    new_index = {n: i for i, n in enumerate(names)}
    remap = np.full(len(prev["vocab"]) + 1, -1, dtype=np.int32)
    for old_i, name in enumerate(prev["vocab"]):
        remap[old_i] = new_index.get(name, -1)
    prev_index = {n: i for i, n in enumerate(prev["vocab"])}
    keep = np.ones(len(r_ids), dtype=bool)
    for e, row in enumerate(r_ids):
        j = prev_index.get(names[int(row)])
        if j is None:
            continue
        old_ids = prev["rule_ids"][j]
        mapped = np.where(old_ids >= 0, remap[old_ids], -1)
        if (
            bool((mapped == rule_ids[e]).all())
            and bool((prev["rule_counts"][j] == rule_counts[e]).all())
            and int(prev["item_counts"][j]) == int(item_counts[e])
        ):
            keep[e] = False
    return keep


def run_delta_job(cfg: MiningConfig, device: str | torch.device = "cuda") -> DeltaResult:
    """The ``delta`` route of the mining job, its recount on ``device``
    above the host threshold; one rank only (more are ineligible). Raises
    :class:`DeltaIneligible` whenever a full re-mine is the only correct
    answer."""
    from ..mining import dispatch as dispatch_mod
    from ..mining import miner
    from ..parallel.support import restricted_pair_counts

    t0 = time.perf_counter()
    dev = resolve_device(device)
    timings: dict[str, float] = {}
    base = load_base_state(cfg.pickles_dir)
    _check_eligibility(cfg, base)
    assert base is not None

    # the base generation must still be the published one: another writer
    # rewriting the token (or the npz) retires this base state
    token_path = os.path.join(cfg.base_dir, cfg.data_invalidation_file)
    try:
        current_token = artifacts.read_text(token_path)
    except FileNotFoundError:
        raise DeltaIneligible("no invalidation token on the PVC")
    if current_token != base["token"]:
        raise DeltaIneligible("another generation published since the base run")
    npz_path = artifacts.tensor_artifact_path(
        os.path.join(cfg.pickles_dir, cfg.recommendations_file)
    )
    if base.get("npz_sha256") is None or not os.path.exists(npz_path):
        raise DeltaIneligible("base run published no tensor artifact")
    if artifacts.file_digest(npz_path)["sha256"] != base["npz_sha256"]:
        raise DeltaIneligible("published tensor artifact changed on disk")

    # chain cap: past it, accumulated patches cost more than a clean re-mine
    state = artifacts.read_delta_state(cfg.pickles_dir)
    entries: list[dict[str, Any]] = []
    if state is not None:
        if state.get("base_token") != base["token"]:
            raise DeltaIneligible("delta chain bound to another generation")
        entries = list(state["entries"])
    if cfg.delta_max_chain > 0 and len(entries) >= cfg.delta_max_chain:
        raise DeltaIneligible(f"delta chain at its cap ({len(entries)}) — full re-mine")

    # dataset fingerprint: an unchanged prefix plus appended rows is the
    # delta case; anything else is a rewrite and must fully re-mine
    dataset_path = os.path.join(cfg.datasets_dir, base["dataset"])
    if not os.path.exists(dataset_path):
        raise DeltaIneligible(f"base dataset {base['dataset']} is gone")
    t = time.perf_counter()
    size = os.path.getsize(dataset_path)
    if size < base["dataset_bytes"]:
        raise DeltaIneligible("dataset shrank — not append-only")
    prefix_hex, full_sha, suffix_len = _fingerprint(dataset_path, base["dataset_bytes"])
    timings["fingerprint"] = time.perf_counter() - t
    if prefix_hex != base["dataset_sha256"]:
        raise DeltaIneligible("dataset prefix rewritten — not append-only")
    if suffix_len == 0:
        print("Delta mining: no new rows — nothing to publish")
        return DeltaResult(
            seq=entries[-1]["seq"] if entries else 0,
            bundle_path=None, n_new_rows=0, n_changed=0, n_tombstones=0,
            n_touched=0, duration_s=time.perf_counter() - t0,
            fencing_token=None, base_token=base["token"],
            dataset=base["dataset"], run_index=int(base["run_index"]),
            phase_timings=timings,
        )

    # ---------- the lease before the compute (fence zombies early) ----------
    lease = None
    if cfg.lease_enabled:
        lease = artifacts.PublicationLease.acquire(
            cfg.pickles_dir,
            ttl_s=cfg.lease_ttl_s,
            heartbeat_interval_s=cfg.lease_heartbeat_interval_s or None,
        )
        lease.start_heartbeat()
        print(f"Delta publication lease acquired (fencing token {lease.fencing_token})")
    try:
        t = time.perf_counter()
        new_pids, new_names = _read_suffix_table(
            dataset_path, base["dataset_bytes"], limit=suffix_len
        )
        timings["suffix_parse"] = time.perf_counter() - t
        print(
            f"Delta mining: {len(new_pids)} appended rows over "
            f"{len(np.unique(new_pids))} playlists"
        )
        t = time.perf_counter()
        combined, merged_pids, affected = _combined_baskets(base, new_pids, new_names)
        # the full path's Apriori prune decision, exactly
        new_min = min_count_for(cfg.min_support, combined.n_playlists)
        mined = combined
        if combined.n_tracks > cfg.prune_vocab_threshold:
            mined, _ = miner.prune_infrequent(combined, new_min)
            if mined.n_tracks == 0:
                if combined.n_tracks <= 4096:
                    mined = combined
                else:
                    raise DeltaIneligible("pruned vocabulary emptied — full re-mine decides")
        prev = base["published"]
        old_min = min_count_for(cfg.min_support, prev["n_playlists"])
        r_ids, tombstones, n_recompute = _recompute_rows(
            prev, combined, mined, affected, old_min, new_min
        )
        timings["combine"] = time.perf_counter() - t

        # ---------- the restricted recount (the device compute) ----------
        # the full mine's dispatch on this device: a sparse-eligible delta
        # must not pay the dense recount (sparse counts are exact too)
        t = time.perf_counter()
        plan = dispatch_mod.plan_count_path(
            cfg, mined.n_playlists, mined.n_tracks, len(mined.playlist_rows),
            backend=backend_name(dev), n_devices=1, baskets=mined,
        )
        counts_r = restricted_pair_counts(
            mined, r_ids, count_path="sparse" if plan.path == "sparse" else None,
            device=dev,
        )
        timings["recount"] = time.perf_counter() - t
        t = time.perf_counter()
        rule_ids, rule_counts, item_counts = emit_rule_rows_np(
            counts_r, r_ids.astype(np.int64), new_min, cfg.k_max_consequents
        )
        if cfg.confidence_mode == "confidence":
            rule_ids, rule_counts = _confidence_filter_rows(
                rule_ids, rule_counts, item_counts, cfg.min_confidence
            )
        if rule_ids.shape[1] != prev["rule_ids"].shape[1]:
            raise DeltaIneligible("row capacity changed vs the base artifact")
        keep = _shrink(prev, mined.vocab.names, r_ids, rule_ids, rule_counts, item_counts)
        r_ids_k = r_ids[keep]
        timings["emission"] = time.perf_counter() - t

        t = time.perf_counter()
        seq = (entries[-1]["seq"] + 1) if entries else 1
        bundle_name = artifacts.delta_bundle_filename(seq)
        bundle_path = os.path.join(cfg.pickles_dir, bundle_name)
        if lease is not None:
            lease.check()  # fence point: no zombie writes the chain
        artifacts.save_delta_bundle(
            bundle_path,
            seq=seq,
            base_token=base["token"],
            base_npz_sha256=base["npz_sha256"],
            n_playlists=combined.n_playlists,
            min_count=new_min,
            vocab=list(mined.vocab.names),
            changed_rows=r_ids_k,
            changed_rule_ids=rule_ids[keep],
            changed_rule_counts=rule_counts[keep],
            changed_item_counts=item_counts[keep],
            tombstones=tombstones,
        )
        # the chain entry carries the digest of the bytes actually written
        # (savez stamps zip times: two bundles compare by content only)
        digest = artifacts.file_digest(bundle_path)
        entries.append(
            {
                "seq": seq,
                "file": bundle_name,
                "sha256": digest["sha256"],
                "bytes": digest["bytes"],
                "written_at": time.time(),
                "fencing_token": lease.fencing_token if lease else None,
                "n_changed": int(len(r_ids_k)),
                "n_tombstones": len(tombstones),
                "n_playlists": int(combined.n_playlists),
            }
        )
        if lease is not None:
            lease.check()  # the last fence before the chain makes it live
        artifacts.write_delta_state(cfg.pickles_dir, base["token"], base["npz_sha256"], entries)

        # roll the base state forward so the next delta extends this one:
        # membership, pids and fingerprint advance, and `published` becomes
        # base ∘ chain (the next crossing-band scan reads current counts)
        bundle = artifacts.load_delta_bundle(bundle_path, expect_sha256=digest["sha256"])
        save_base_state(
            cfg,
            token=base["token"],
            run_index=base["run_index"],
            dataset_path=dataset_path,
            baskets=combined,
            pid_values=merged_pids,
            published=apply_delta_to_tensors(prev, bundle),
            npz_sha256=base["npz_sha256"],
            dataset_digest=(base["dataset_bytes"] + suffix_len, full_sha),
        )
        if lease is not None:
            lease.release()
        timings["publish"] = time.perf_counter() - t
        duration = time.perf_counter() - t0
        print(
            f"Delta {seq} published: {len(r_ids_k)} changed rows, "
            f"{len(tombstones)} tombstones, {n_recompute} recomputed, "
            f"{duration:.2f}s"
        )
        print(f"Delta recount path: {'sparse' if plan.path == 'sparse' else 'dense'} "
              f"({len(r_ids)} rows x {mined.n_tracks} tracks x {mined.n_playlists} playlists)")
        return DeltaResult(
            seq=seq,
            bundle_path=bundle_path,
            n_new_rows=len(new_pids),
            n_changed=int(len(r_ids_k)),
            n_tombstones=len(tombstones),
            n_touched=n_recompute,
            duration_s=duration,
            fencing_token=lease.fencing_token if lease else None,
            base_token=base["token"],
            dataset=base["dataset"],
            run_index=int(base["run_index"]),
            n_playlists=int(mined.n_playlists),
            n_tracks=int(mined.n_tracks),
            phase_timings=timings,
        )
    except BaseException:
        if lease is not None:
            lease.stop_heartbeat()
            try:
                lease.release()
            except (artifacts.LeaseLostError, OSError):
                pass
        raise
    finally:
        if lease is not None:
            lease.stop_heartbeat()


def derive_serving_arrays(
    state: dict[str, Any],
) -> tuple[list[str], np.ndarray, np.ndarray, np.ndarray]:
    """Logical tensors → the engine's ``(vocab, rule_ids, rule_confs
    float32, known_mask)``, with exactly the load path's derivations, so a
    patched generation cannot derive differently from a freshly loaded
    one."""
    confs = derive_confs(
        state["rule_counts"], state["item_counts"], state["n_playlists"], state["mode"]
    )
    known = state["item_counts"] >= min_count_for(state["min_support"], state["n_playlists"])
    return state["vocab"], state["rule_ids"], confs, np.asarray(known)
