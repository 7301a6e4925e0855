"""The serving lookup — counterpart of ``kmlserver_tpu/ops/serve.py``.

Seed songs' rule rows are gathered from the device-resident rule tensors,
max-merged by scatter-max into a per-request score vector, and the top-K
ids extracted, batched over B requests. Semantics are the reference's
(rest_api/app/main.py:224-254): seeds absent from the rules contribute
nothing, a recommendation may be another seed, the merge is a max over
per-seed confidences, and equal scores rank by ascending id — the order
``jax.lax.top_k`` gives. ``torch.topk`` promises no order among equal
values, so the top-k here is a stable descending sort, sliced.
"""

from __future__ import annotations

import torch


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
