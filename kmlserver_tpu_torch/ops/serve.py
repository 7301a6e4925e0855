"""The serving lookup — counterpart of ``kmlserver_tpu/ops/serve.py``.

Seed songs' rule rows are gathered from the device-resident rule tensors,
max-merged by scatter-max into a per-request score vector, and the top-K
ids extracted, batched over B requests. Semantics are the reference's
(rest_api/app/main.py:224-254): seeds absent from the rules contribute
nothing, a recommendation may be another seed, the merge is a max over
per-seed confidences, and equal scores rank by ascending id — the order
``jax.lax.top_k`` gives. ``torch.topk`` promises no order among equal
values, so the top-k here is a stable descending sort, sliced.

The vocab-sharded lookup (X9) — a per-slab partial and a cross-slab merge —
runs through the same epilogue, so its answers are the replicated
lookup's. These are library ops, as the reference's are XLA ops.
"""

from __future__ import annotations

import numpy as np
import torch

# X9 calls that ran on a CUDA device (library ops, so calls, not launches)
CALLS = {"shard_partial": 0, "merge_partial": 0}


def masked_topk_from_candidates(
    cand_ids: torch.Tensor,  # int (B, N) ids, -1 = dead lane
    cand_confs: torch.Tensor,  # float32 (B, N), 0 = dead lane
    *,
    v: int,
    k_best: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Max-merge (id, conf) candidate lanes into a ``(B, V)`` score vector
    (dead lanes — id < 0 or conf ≤ 0 — land in a spill slot V, sliced
    off), then top-k with ids of conf ≤ 0 set to -1, columns padded up to
    ``k_best``."""
    b = cand_ids.shape[0]
    live = (cand_ids >= 0) & (cand_confs > 0)
    targets = torch.where(live, cand_ids, torch.full_like(cand_ids, v)).to(torch.int64)
    confs = torch.where(live, cand_confs, torch.zeros_like(cand_confs))
    scores = torch.zeros((b, v + 1), dtype=cand_confs.dtype, device=cand_confs.device)
    scores.scatter_reduce_(1, targets, confs, reduce="amax", include_self=True)
    scores = scores[:, :v]
    k = min(k_best, v)
    top_confs, top_ids = torch.sort(scores, dim=1, descending=True, stable=True)
    top_confs, top_ids = top_confs[:, :k], top_ids[:, :k].to(torch.int32)
    top_ids = torch.where(top_confs > 0, top_ids, torch.full_like(top_ids, -1))
    if k < k_best:  # pad so callers always see k_best columns
        top_ids = torch.nn.functional.pad(top_ids, (0, k_best - k), value=-1)
        top_confs = torch.nn.functional.pad(top_confs, (0, k_best - k))
    return top_ids, top_confs


def recommend_batch(
    rule_ids: torch.Tensor,  # int32 (V, K_max), -1 padded
    rule_confs: torch.Tensor,  # float32 (V, K_max), 0 padded
    seed_ids: torch.Tensor,  # int (B, L), -1 padded
    *,
    k_best: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """→ ``(top_ids int32 (B, k_best) with -1 padding, top_confs float32)``,
    on the rule tensors' device."""
    v = rule_ids.shape[0]
    b = seed_ids.shape[0]
    seed_ids = seed_ids.to(device=rule_ids.device, dtype=torch.int64)
    safe_seeds = torch.where(seed_ids >= 0, seed_ids, torch.zeros_like(seed_ids))
    gathered_ids = rule_ids[safe_seeds]  # (B, L, K)
    gathered_confs = rule_confs[safe_seeds]
    valid = (gathered_ids >= 0) & (seed_ids >= 0)[..., None]
    return masked_topk_from_candidates(
        torch.where(valid, gathered_ids, torch.full_like(gathered_ids, -1)).reshape(b, -1),
        torch.where(valid, gathered_confs, torch.zeros_like(gathered_confs)).reshape(b, -1),
        v=v, k_best=k_best,
    )


# ---------------------------------------------------------------------------
# X9, the vocab-sharded lookup (reference ``ops/serve.py:126-249``): the rule
# tensors are cut along the vocab (antecedent) axis into S slabs of V_loc
# rows each, the vocabulary padded to V_loc·S with empty rows. Each slab's
# partial maps the seed batch onto its own rows, gathers them and takes the
# top-k at the padded GLOBAL width; the (S, B, k) partials, in shard order,
# go through the same epilogue once more. A consequent of the true top-k
# ranks inside the top-k of the slab where it attains its maximum, so the
# merge sees every winner at its exact score, and the answer equals the
# replicated lookup's bit for bit (ties by ascending global id).
# ---------------------------------------------------------------------------


def shard_partial_topk(
    rule_ids_loc: torch.Tensor,  # int32 (V_loc, K) — GLOBAL consequent ids
    rule_confs_loc: torch.Tensor,  # float32 (V_loc, K)
    seed_ids: torch.Tensor,  # int (B, L), -1 padded, GLOBAL ids
    lo: int,  # this slab's first global row
    *,
    v: int,  # the padded global width, V_loc · S
    k_best: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One slab's ``(B, k_best)`` partial at global ids and width, on the
    slab's device. Seeds outside ``[lo, lo + V_loc)`` contribute nothing."""
    v_loc = rule_ids_loc.shape[0]
    b = seed_ids.shape[0]
    seed_ids = seed_ids.to(device=rule_ids_loc.device, dtype=torch.int64)
    in_shard = (seed_ids >= lo) & (seed_ids < lo + v_loc)
    local = torch.where(in_shard, seed_ids - lo, torch.full_like(seed_ids, -1))
    safe = torch.where(local >= 0, local, torch.zeros_like(local))
    gathered_ids = rule_ids_loc[safe]  # (B, L, K)
    gathered_confs = rule_confs_loc[safe]
    valid = (gathered_ids >= 0) & (local >= 0)[..., None]
    if rule_ids_loc.is_cuda:
        CALLS["shard_partial"] += 1
    return masked_topk_from_candidates(
        torch.where(valid, gathered_ids, torch.full_like(gathered_ids, -1)).reshape(b, -1),
        torch.where(valid, gathered_confs, torch.zeros_like(gathered_confs)).reshape(b, -1),
        v=v, k_best=k_best,
    )


def merge_partial_topk(
    all_ids: torch.Tensor,  # int32 (S, B, k_best) partials, shard order
    all_confs: torch.Tensor,  # float32 (S, B, k_best)
    *,
    v: int,
    k_best: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The cross-shard max-merge → the final ``(B, k_best)``. A slot whose
    confidences are ``-inf`` (a rank left out of the merge) is dead."""
    s, b, k = all_ids.shape
    if all_ids.is_cuda:
        CALLS["merge_partial"] += 1
    return masked_topk_from_candidates(
        all_ids.transpose(0, 1).reshape(b, s * k),
        all_confs.transpose(0, 1).reshape(b, s * k),
        v=v, k_best=k_best,
    )


def sharded_recommend(
    shard_ids: list[torch.Tensor],  # S slabs, int32 (V_loc, K) each
    shard_confs: list[torch.Tensor],  # float32 (V_loc, K) each
    seed_ids: torch.Tensor,  # int (B, L), -1 padded, GLOBAL ids
    *,
    k_best: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The in-process sharded lookup (reference ``sharded_recommend_fn``):
    each slab's partial on its own device, the partials copied to the first
    slab's device in shard order and merged there once → ``(B, k_best)``
    there, equal to :func:`recommend_batch` on the unpadded tensors."""
    v_loc = shard_ids[0].shape[0]
    v = v_loc * len(shard_ids)
    dev = shard_ids[0].device
    parts = [
        shard_partial_topk(ids, confs, seed_ids, s * v_loc, v=v, k_best=k_best)
        for s, (ids, confs) in enumerate(zip(shard_ids, shard_confs))
    ]
    return merge_partial_topk(
        torch.stack([p[0].to(dev) for p in parts]),
        torch.stack([p[1].to(dev) for p in parts]),
        v=v, k_best=k_best,
    )


def split_vocab(
    rule_ids: np.ndarray, rule_confs: np.ndarray, n_shards: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host rule tensors padded along the vocab axis to a multiple of
    ``n_shards`` with empty rows (-1 ids, 0 confidences, unreachable: seed
    ids are below V) → ``(ids, confs, V_loc)``; slab s is rows
    ``[s·V_loc, (s+1)·V_loc)``."""
    v, k = rule_ids.shape
    v_loc = -(-v // n_shards)
    ids = np.full((v_loc * n_shards, k), -1, dtype=np.int32)
    confs = np.zeros((v_loc * n_shards, k), dtype=np.float32)
    ids[:v] = rule_ids
    confs[:v] = rule_confs
    return ids, confs, v_loc
