"""The publication a serving configuration serves, drawn from the seed and
written through the port's artifact writer, as the mining job writes it.

From the configuration (``configs/<name>.json``, ``publication``):

- the catalog: ``tracks`` names, most popular first, with the mining
  job's popularity (``P·q_t`` of config 4's Bernoulli-Zipf law);
- the rule vocabulary: the candidate-frequent head of that law (config
  4's analytic cut); its keys, the tracks whose count reaches
  ``min_count``; ``rules`` rules spread over the keys with row lengths
  falling as ``1 / rank`` and capped at ``k_max``; each row's consequents
  drawn distinct among the keys (not the key itself), each confidence
  ``count / item_count`` with ``count = ceil(u · item_count)``, ``u``
  uniform in (0, 1]; rows ranked by count, equal counts by id (confidence
  mode);
- the embeddings: ``rank``-wide float32 factors over the whole catalog,
  standard normal, rows normalized;
- the popularity list: the top ``best_share`` of the catalog.
"""

from __future__ import annotations

import os

import numpy as np

from .reference import mine as ref_mine


def _row_lengths(n_keys: int, total: int, k_max: int) -> np.ndarray:
    """Row lengths ``min(k_max, floor(a / (rank + 1)))`` (at least 1) with
    ``a`` found so that they sum to ``total``; the remainder goes to the
    rows below the cap, head first."""
    ranks = np.arange(1, n_keys + 1, dtype=np.float64)
    lo, hi = 0.0, float(total) * 4
    for _ in range(100):
        a = (lo + hi) / 2
        if np.minimum(k_max, np.maximum(1, np.floor(a / ranks))).sum() > total:
            hi = a
        else:
            lo = a
    lengths = np.minimum(k_max, np.maximum(1, np.floor(lo / ranks))).astype(np.int64)
    short = total - int(lengths.sum())
    room = np.flatnonzero(lengths < k_max)[:max(short, 0)]
    lengths[room] += 1
    return lengths


def draw(cfg: dict, seed: int) -> dict:
    """The publication of ``cfg["publication"]`` under ``seed`` → the
    arrays both the writer and the reference read."""
    c = cfg["publication"]
    rng = np.random.default_rng(seed)
    p, v = int(c["playlists"]), int(c["tracks"])
    q = ref_mine.membership_probs(v, p, int(c["rows"]), float(c["zipf_s"]))
    min_count = ref_mine.min_count_for(float(c["min_support"]), p)
    f = ref_mine.candidate_count(q, p, min_count)
    counts = np.floor(p * q).astype(np.int64)
    names = [f"t{i:07d}" for i in range(v)]
    item_counts = counts[:f]
    n_keys = int((item_counts >= min_count).sum())
    k_max = int(c["k_max"])
    lengths = _row_lengths(n_keys, int(c["rules"]), k_max)
    rule_ids = np.full((f, k_max), -1, dtype=np.int64)
    rule_counts = np.zeros((f, k_max), dtype=np.int64)
    for t in range(n_keys):
        need = int(lengths[t])
        cand = rng.choice(n_keys - 1, size=need, replace=False)
        cand = cand + (cand >= t)  # never the key itself
        u = 1.0 - rng.random(need)  # (0, 1]
        cnt = np.maximum(1, np.ceil(u * item_counts[t])).astype(np.int64)
        order = np.lexsort((cand, -cnt))
        rule_ids[t, :need] = cand[order]
        rule_counts[t, :need] = cnt[order]
    factors = rng.standard_normal((v, int(c["rank"])), dtype=np.float32)
    factors /= np.linalg.norm(factors, axis=1, keepdims=True)
    n_best = int(v * float(c["best_share"]))
    return {
        "names": names, "counts": counts, "rule_ids": rule_ids, "rule_counts": rule_counts,
        "item_counts": item_counts, "min_count": min_count, "min_support": float(c["min_support"]),
        "playlists": p, "factors": factors, "best_names": names[:n_best],
        "n_rules": int(lengths.sum()), "n_keys": n_keys,
    }


def write(pub: dict, base_dir: str) -> str:
    """Publish ``pub`` under ``base_dir`` (the PVC) through the port's
    writer: the popularity and rule pickles, the rule tensors, the
    embeddings, the manifest, then the invalidation token → the token."""
    from kmlserver_tpu_torch.config import ServingConfig
    from kmlserver_tpu_torch.io import artifacts, registry
    from kmlserver_tpu_torch.quality.lifecycle import manifest_filenames
    from kmlserver_tpu_torch.config import MiningConfig
    from kmlserver_tpu_torch.utils.timeutil import get_current_time_str_precise

    scfg = ServingConfig(base_dir=base_dir)
    pickles = scfg.pickles_dir
    os.makedirs(pickles, exist_ok=True)
    f = len(pub["item_counts"])
    vocab = pub["names"][:f]
    best = [{"track_name": n, "count": int(pub["counts"][i])}
            for i, n in enumerate(pub["best_names"])]
    artifacts.save_pickle(best, os.path.join(pickles, scfg.best_tracks_file))
    rec_path = os.path.join(pickles, scfg.recommendations_file)
    rules = {}
    confs = pub["rule_counts"] / np.maximum(pub["item_counts"], 1)[:, None].astype(np.float64)
    for t in np.flatnonzero(pub["item_counts"] >= pub["min_count"]).tolist():
        row = pub["rule_ids"][t]
        rules[vocab[t]] = {vocab[j]: float(confs[t, k]) for k, j in enumerate(row.tolist()) if j >= 0}
    artifacts.save_pickle(rules, rec_path)
    artifacts.save_rule_tensors(
        artifacts.tensor_artifact_path(rec_path), vocab=vocab,
        rule_ids=pub["rule_ids"].astype(np.int32), rule_counts=pub["rule_counts"].astype(np.int32),
        item_counts=pub["item_counts"].astype(np.int32), n_playlists=pub["playlists"],
        min_support=pub["min_support"], mode="confidence", min_confidence=0.0,
    )
    artifacts.save_embeddings(
        artifacts.embeddings_artifact_path(pickles), vocab=pub["names"],
        item_factors=pub["factors"], rank=pub["factors"].shape[1], iters=8, reg=0.1,
    )
    token = get_current_time_str_precise()
    artifacts.write_manifest(pickles, manifest_filenames(MiningConfig(base_dir=base_dir)), token=token)
    artifacts.atomic_write_text(
        registry.token_path_for(base_dir, scfg.data_invalidation_file), token)
    return token
