"""Offline ranking evaluation — counterpart of ``kmlserver_tpu/quality/eval.py``,
the measured half of the quality loop.

- **Deterministic split.** Leave-``n``-out per playlist, the held-out
  tracks picked by a keyed blake2b over ``(salt, playlist row, track
  name)``: no RNG state and no input order, so two runs, two ranks or a
  resume on another machine get the same split. It is host numpy, array
  for array the reference's. Playlists shorter than ``min_basket`` are not
  evaluated.
- **No leakage.** Both model families train on the train pairs only, and
  :func:`holdout_split` checks that the held-out and train pairs are
  disjoint before it returns.
- **The serving lookups.** Candidates come from the lookups the engine
  runs (``ops/serve.recommend_batch``, ``ops/embed.embed_topk``) on the
  phase's device, and the blend is the engine's own
  :func:`~kmlserver_tpu_torch.serving.engine.blend_candidates`, so a
  measured number describes a ranking production serves.
- **Deterministic report.** No timestamps or tokens and floats rounded to
  6 places: a resumed job publishes the same ``quality.report.json``
  bytes.

Metrics per serving mode (rules / embed / blend / popularity fallback):
``recall_at_k`` (hits over min(k, |targets|)), ``mrr`` (reciprocal rank of
the first hit in the top k) and ``coverage`` (the share of playlists the
model, not the fallback, answered).

On the card the phase runs both hand kernels: the mine of the train split
(the popcount kernel under ``KMLS_COUNT_PATH=bitpack``) and the sparse ALS
training (segsum under ``KMLS_ALS_SPARSE=always``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
import time
from typing import Any

import numpy as np
import torch

from ..config import MiningConfig
from ..mining import als
from ..mining.miner import MiningResult, mine
from ..mining.vocab import Baskets
from ..ops.embed import embed_topk
from ..ops.serve import recommend_batch
from ..ops.support import min_count_for
from ..serving.engine import blend_candidates, stable_seed
from ..utils.device import resolve_device
from ..utils.profiling import format_phases
from .sweep import DEFAULT_BLEND_WEIGHT, sweep_blend_weight

QUALITY_REPORT_VERSION = 1
# the split's identity salt: a change to the split is a version bump
SPLIT_SALT = "kmls-eval-v1"
# seed cap per eval request: serving's KMLS_MAX_SEED_TRACKS default
EVAL_SEED_CAP = 128
# requests per lookup batch: one (EVAL_BATCH, L) seed shape per run
EVAL_BATCH = 64


def _pair_digest(row: int, name: str) -> int:
    """The hold-out key of one (playlist, track): blake2b, which no process
    salts and no input order moves."""
    h = hashlib.blake2b(f"{SPLIT_SALT}|{row}|{name}".encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(h, "big")


@dataclasses.dataclass
class HoldoutSplit:
    """One held-out split: the train baskets and, per evaluated playlist,
    its seeds and held-out targets."""

    train: Baskets
    eval_rows: list[int]
    seed_names: list[list[str]]
    target_names: list[list[str]]
    n_eligible: int  # playlists long enough to evaluate, before the cap


def holdout_split(
    baskets: Baskets,
    n_holdout: int = 1,
    min_basket: int = 3,
    max_playlists: int = 0,
) -> HoldoutSplit:
    """Leave ``n_holdout`` out per playlist. In each eligible playlist (at
    least ``min_basket`` tracks, and never fewer than two seeds left) the
    ``n_holdout`` tracks of smallest pair digest are held out; the rest are
    seeds and training pairs. ``max_playlists`` > 0 keeps the playlists of
    smallest row digest (a prefix would favour low pids)."""
    min_basket = max(min_basket, n_holdout + 2)
    rows = baskets.playlist_rows.astype(np.int64)
    tids = baskets.track_ids.astype(np.int64)
    order = np.lexsort((tids, rows))
    rows_s, tids_s = rows[order], tids[order]
    sizes = np.bincount(rows_s, minlength=baskets.n_playlists)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    eligible = np.flatnonzero(sizes >= min_basket)
    n_eligible = len(eligible)
    if max_playlists > 0 and len(eligible) > max_playlists:
        keyed = sorted(eligible.tolist(), key=lambda r: _pair_digest(r, "<row>"))
        eligible = np.asarray(sorted(keyed[:max_playlists]), dtype=np.int64)
    names = baskets.vocab.names
    heldout_mask = np.zeros(len(rows_s), dtype=bool)
    eval_rows: list[int] = []
    seed_names: list[list[str]] = []
    target_names: list[list[str]] = []
    for r in eligible.tolist():
        lo = int(starts[r])
        member = tids_s[lo:lo + int(sizes[r])]
        digests = [_pair_digest(r, names[int(t)]) for t in member]
        picked = sorted(range(len(member)), key=lambda i: digests[i])
        held = set(picked[:n_holdout])
        heldout_mask[lo + np.asarray(sorted(held), dtype=np.int64)] = True
        eval_rows.append(r)
        seed_names.append([names[int(member[i])] for i in range(len(member)) if i not in held])
        target_names.append([names[int(member[i])] for i in sorted(held)])
    keep = ~heldout_mask
    train = Baskets(
        playlist_rows=rows_s[keep].astype(np.int32),
        track_ids=tids_s[keep].astype(np.int32),
        n_playlists=baskets.n_playlists,
        vocab=baskets.vocab,
    )
    # the held-out and train pairs partition the membership: an overlap
    # would score the models on answers they trained on
    v = np.int64(baskets.n_tracks)
    train_keys = set((rows_s[keep] * v + tids_s[keep]).tolist())
    held_keys = set((rows_s[heldout_mask] * v + tids_s[heldout_mask]).tolist())
    if train_keys & held_keys:
        raise AssertionError(
            "held-out pairs leaked into the train split — the split is broken, refusing to evaluate"
        )
    return HoldoutSplit(
        train=train,
        eval_rows=eval_rows,
        seed_names=seed_names,
        target_names=target_names,
        n_eligible=n_eligible,
    )


def _batched_candidates(
    kernel, tensor_args: tuple[torch.Tensor, ...], seed_id_lists: list[list[int]], k: int,
    device: torch.device,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Run a top-k lookup over ``(EVAL_BATCH, L)`` seed batches on
    ``device`` (-1 padding, L capped at :data:`EVAL_SEED_CAP`, one shape
    per run) → ``(top ids, top scores, batches)`` on the host."""
    n = len(seed_id_lists)
    length = max(1, min(max((len(s) for s in seed_id_lists), default=1), EVAL_SEED_CAP))
    out_ids = np.full((n, k), -1, dtype=np.int32)
    out_scores = np.zeros((n, k), dtype=np.float32)
    batches = 0
    for lo in range(0, n, EVAL_BATCH):
        chunk = seed_id_lists[lo:lo + EVAL_BATCH]
        arr = np.full((EVAL_BATCH, length), -1, dtype=np.int32)
        for r, ids in enumerate(chunk):
            ids = ids[:length]
            arr[r, : len(ids)] = ids
        ids_d, scores_d = kernel(*tensor_args, torch.from_numpy(arr).to(device), k_best=k)
        out_ids[lo:lo + len(chunk)] = ids_d.cpu().numpy()[: len(chunk)]
        out_scores[lo:lo + len(chunk)] = scores_d.cpu().numpy()[: len(chunk)]
        batches += 1
    return out_ids, out_scores, batches


def _rank_metrics(answer: list[str], targets: list[str], k: int) -> tuple[float, float]:
    """→ (recall@k, reciprocal rank of the first hit in the top k)."""
    target_set = set(targets)
    top = answer[:k]
    hits = sum(1 for name in top if name in target_set)
    recall = hits / max(min(k, len(target_set)), 1)
    rr = 0.0
    for rank, name in enumerate(top, start=1):
        if name in target_set:
            rr = 1.0 / rank
            break
    return recall, rr


def _fallback_answer(best_names: list[str], seeds: list[str], k: int) -> list[str]:
    """The popularity fallback as serving composes it: a sample over the
    popularity ranking seeded by :func:`stable_seed` of the seeds."""
    if not best_names:
        return []
    rng = random.Random(stable_seed(seeds))
    return rng.sample(best_names, min(k, len(best_names)))


@dataclasses.dataclass
class Families:
    """Both model families trained on a split's train half."""

    result: MiningResult
    # L2-normalized item factors over the train vocabulary (None: embed
    # off or the HBM-fit guard declined)
    emb_factors: np.ndarray | None
    emb_vocab: list[str]
    # the popularity ranking of the fallback mode
    best_names: list[str]
    seconds: dict[str, float]  # host wall clock of the mine and of ALS


def train_families(
    cfg: MiningConfig, split: HoldoutSplit, device: torch.device, mesh=None
) -> Families:
    """Mine and (with ``embed_enabled``) train ALS on the train split, and
    rank its tracks by popularity."""
    t = time.perf_counter()
    result = mine(split.train, cfg, device=device, mesh=mesh)
    seconds = {"mine": time.perf_counter() - t}
    factors = None
    if cfg.embed_enabled:
        t = time.perf_counter()
        payload = als.train_embeddings(split.train, cfg, mesh=mesh, device=device)
        seconds["als"] = time.perf_counter() - t
        if payload.get("item_factors") is not None:
            factors = np.asarray(payload["item_factors"], dtype=np.float32)
    # the popularity ranking: production's tie order (count desc, name asc)
    # and percentile truncation, over the train pairs (deduplicated) so a
    # held-out pair never votes for its own popularity
    train = split.train
    pop_counts = np.bincount(train.track_ids, minlength=train.n_tracks)
    pop_order = np.lexsort((np.asarray(train.vocab.names, dtype=object), -pop_counts))
    keep_n = int(len(pop_order) * cfg.top_tracks_save_percentile)
    return Families(
        result=result,
        emb_factors=factors,
        emb_vocab=list(train.vocab.names),
        best_names=[train.vocab.names[int(i)] for i in pop_order[:keep_n]],
        seconds=seconds,
    )


@dataclasses.dataclass
class Candidates:
    """Per evaluated playlist: the seed ids each family knows and its
    ranked (name, score) candidates."""

    rule_seed_ids: list[list[int]]
    rule_pairs: list[list[tuple[str, float]]]
    emb_seed_ids: list[list[int]]
    emb_pairs: list[list[tuple[str, float]]] | None
    batches: dict[str, int]  # lookup batches per family


def lookup_candidates(
    split: HoldoutSplit, families: Families, k: int, device: torch.device
) -> Candidates:
    """Both families' top-k candidates for every evaluated playlist through
    the serving lookups on ``device``; each family's tensors are uploaded
    once. Rule ids index ``result.vocab_names`` (the mined, possibly
    pruned, vocabulary), never the full one."""
    tensors = families.result.tensors
    rule_vocab = families.result.vocab_names
    rule_index = {n: i for i, n in enumerate(rule_vocab)}
    known = tensors.item_counts >= min_count_for(tensors.min_support, tensors.n_playlists)
    rule_seed_ids = [
        [rule_index[n] for n in seeds if n in rule_index and bool(known[rule_index[n]])][
            :EVAL_SEED_CAP
        ]
        for seeds in split.seed_names
    ]
    rule_args = (
        torch.as_tensor(tensors.rule_ids, device=device),
        torch.as_tensor(tensors.rule_confs, device=device),
    )
    r_ids, r_confs, rule_batches = _batched_candidates(
        recommend_batch, rule_args, rule_seed_ids, k, device
    )
    rule_pairs = [
        [(rule_vocab[int(i)], float(c)) for i, c in zip(r_ids[e], r_confs[e]) if i >= 0]
        for e in range(len(split.eval_rows))
    ]
    batches = {"rules": rule_batches, "embed": 0}
    if families.emb_factors is None:
        return Candidates(rule_seed_ids, rule_pairs, [], None, batches)
    emb_vocab = families.emb_vocab
    emb_index = {n: i for i, n in enumerate(emb_vocab)}
    emb_seed_ids = [
        [emb_index[n] for n in seeds if n in emb_index][:EVAL_SEED_CAP]
        for seeds in split.seed_names
    ]
    e_ids, e_sims, batches["embed"] = _batched_candidates(
        embed_topk, (torch.as_tensor(families.emb_factors, device=device),), emb_seed_ids, k,
        device,
    )
    emb_pairs = [
        [(emb_vocab[int(i)], float(s)) for i, s in zip(e_ids[e], e_sims[e]) if i >= 0]
        for e in range(len(split.eval_rows))
    ]
    return Candidates(rule_seed_ids, rule_pairs, emb_seed_ids, emb_pairs, batches)


def compose_answer(
    split: HoldoutSplit, families: Families, cands: Candidates, k: int,
    mode: str, weight: float, e: int,
) -> tuple[list[str], bool]:
    """→ (answer names, answered by a model) for evaluated playlist ``e``
    under serving ``mode``, as the engine composes it."""
    rk = bool(cands.rule_seed_ids[e])
    ek = cands.emb_pairs is not None and bool(cands.emb_seed_ids[e])
    seeds = split.seed_names[e]
    if mode == "popularity" or (not rk and not ek):
        return _fallback_answer(families.best_names, seeds, k), False
    if mode == "rules":
        if not rk:
            return _fallback_answer(families.best_names, seeds, k), False
        return [n for n, _ in cands.rule_pairs[e]], True
    if mode == "embed":
        if not ek:
            return _fallback_answer(families.best_names, seeds, k), False
        return [n for n, _ in cands.emb_pairs[e]], True
    # blend: the union of both families; embed-only for seeds the rules
    # never saw (cold start), rules-only without embedding candidates
    if not ek:
        return [n for n, _ in cands.rule_pairs[e]], True
    if not rk:
        return [n for n, _ in cands.emb_pairs[e]], True
    return blend_candidates(cands.rule_pairs[e], cands.emb_pairs[e], weight, k), True


def score_modes(
    report: dict[str, Any], split: HoldoutSplit, families: Families, cands: Candidates,
) -> None:
    """Fill ``report``'s ``modes``, ``sweep`` and ``measured_blend_weight``
    from the candidates (host work only)."""
    k = report["k"]
    n_eval = len(split.eval_rows)

    def score_mode(mode: str, weight: float = DEFAULT_BLEND_WEIGHT) -> dict:
        recalls, rrs, covered = [], [], 0
        for e in range(n_eval):
            answer, by_model = compose_answer(split, families, cands, k, mode, weight, e)
            recall, rr = _rank_metrics(answer, split.target_names[e], k)
            recalls.append(recall)
            rrs.append(rr)
            covered += int(by_model and bool(answer))
        return {
            "recall_at_k": round(float(np.mean(recalls)), 6),
            "mrr": round(float(np.mean(rrs)), 6),
            "coverage": round(covered / n_eval, 6),
        }

    report["modes"]["rules"] = score_mode("rules")
    report["modes"]["popularity"] = score_mode("popularity")
    if cands.emb_pairs is not None:
        report["modes"]["embed"] = score_mode("embed")
        report["modes"]["blend"] = score_mode("blend")
        sweep = sweep_blend_weight(
            lambda w, e: compose_answer(split, families, cands, k, "blend", w, e)[0],
            split.target_names, n_eval, k,
        )
        report["sweep"] = sweep
        report["measured_blend_weight"] = sweep["best_weight"]
    else:
        # no second family this generation: blend is rules-only and there
        # is no weight to measure (`measured` serving falls back, loudly)
        report["modes"]["blend"] = report["modes"]["rules"]


def run_eval_phase(
    cfg: MiningConfig,
    baskets: Baskets,
    device: str | torch.device = "cuda",
    mesh=None,
) -> dict[str, Any]:
    """The ``eval`` pipeline phase on ``device``: split → both families
    trained on the train half → every serving mode scored → the blend
    weight swept → the quality report (the phase's checkpoint payload and
    the ``quality.report.json`` body). Raises before any work when
    ``device`` is CUDA and no card is present. With a ``mesh`` every rank
    of it runs this (its mine enters the all-reduce)."""
    dev = resolve_device(device)
    timings: dict[str, float] = {}
    t = time.perf_counter()
    k = max(1, cfg.eval_k)
    holdout_n = max(1, cfg.eval_holdout_n)
    split = holdout_split(baskets, n_holdout=holdout_n, max_playlists=cfg.eval_max_playlists)
    timings["split"] = time.perf_counter() - t
    n_eval = len(split.eval_rows)
    print(
        f"Eval split: {n_eval} playlists evaluated ({split.n_eligible} eligible), "
        f"leave-{holdout_n}-out, {len(split.train.playlist_rows)} train pairs"
    )
    report: dict[str, Any] = {
        "version": QUALITY_REPORT_VERSION,
        "split": {
            "salt": SPLIT_SALT,
            "holdout_n": holdout_n,
            "n_eval_playlists": n_eval,
            "n_eligible_playlists": split.n_eligible,
            "n_train_pairs": int(len(split.train.playlist_rows)),
        },
        "k": k,
        "modes": {},
        "sweep": None,
        "measured_blend_weight": None,
    }
    if n_eval == 0:
        print("Eval: no playlist long enough to hold out — empty report")
        return report

    families = train_families(cfg, split, dev, mesh)
    timings.update(families.seconds)
    t = time.perf_counter()
    cands = lookup_candidates(split, families, k, dev)
    timings["lookups"] = time.perf_counter() - t
    t = time.perf_counter()
    score_modes(report, split, families, cands)
    timings["score_and_sweep"] = time.perf_counter() - t

    for mode in ("rules", "embed", "blend", "popularity"):
        stats = report["modes"].get(mode)
        if stats:
            print(
                f"Eval {mode}: recall@{k} {stats['recall_at_k']:.4f}, "
                f"MRR {stats['mrr']:.4f}, coverage {stats['coverage']:.3f}"
            )
    if report["measured_blend_weight"] is not None:
        print(
            f"Eval blend sweep: measured optimum w={report['measured_blend_weight']} "
            f"(recall@{k} {report['sweep']['best_recall_at_k']:.4f})"
        )
    print(
        f"Eval lookups: {cands.batches['rules']} rule and {cands.batches['embed']} embedding "
        f"batches of {EVAL_BATCH} requests"
    )
    print("Eval " + format_phases(timings))
    return report


__all__ = [
    "EVAL_BATCH",
    "EVAL_SEED_CAP",
    "Candidates",
    "Families",
    "HoldoutSplit",
    "QUALITY_REPORT_VERSION",
    "SPLIT_SALT",
    "compose_answer",
    "holdout_split",
    "lookup_candidates",
    "run_eval_phase",
    "score_modes",
    "train_families",
]
